"""The loop of a run: episodes of a traffic mix, the window, the sample of
steps kept for the correctness check.

The loop runs episodes of the cell's traffic mix (traffic.py) on a system
of the mix's kind of step (perfbench/kinds/).  Each step is timed on the
host clock from before the step to after ``torch.cuda.synchronize()``; a
step whose ``ok`` is false (an MPC step: QP status not 0, or a state or
plan not finite) counts as failed and its episode starts again.  The
window closes after the step that reaches ``seconds``.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from perfbench import traffic


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Record:
    """A step kept for the correctness check: what went in and what came
    out, and the outputs of the step before it in its episode (None for
    an episode's first step)."""
    first: bool
    x: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    eps: torch.Tensor
    out: object
    prev: object


class Loop:
    """Episodes of a traffic mix on a system of the mix's kind, step by
    step."""

    def __init__(self, system, mix: traffic.Mix, draws, seed: int, kind):
        self.system, self.mix, self.draws = system, mix, draws
        self.seed, self.kind = seed, kind
        self.episode = -1
        self.k = mix.episode_steps
        self.carry = self.prev = None
        rng = random.Random(traffic.seed64(seed, 2))
        self.kept = traffic.Reservoir(mix.compare_steps, rng)
        self.kept_first = traffic.Reservoir(
            mix.compare_first_steps if mix.episode_steps > 1 else 0, rng)
        self.keep = False

    def new_episode(self) -> None:
        self.episode += 1
        self.k = 0
        self.eps = self.draws.episode(self.episode)
        self.carry = self.system.episode_start()
        self.prev = None

    def step(self):
        """One step; returns (ok, out).  Ends on the device sync."""
        if self.k >= self.mix.episode_steps:
            self.new_episode()
        c, eps = self.carry, self.eps[self.k]
        nxt, out = self.system.step(c, eps)
        ok = bool(out.ok)
        sync(self.system.device)
        if not ok:
            self.k = self.mix.episode_steps      # the episode starts again
            return ok, out
        if self.keep:
            first = self.prev is None
            make = lambda: self.kind.record(self, c, eps, out)  # noqa
            (self.kept_first if first and self.kept_first.k else
             self.kept).offer(make)
        self.carry, self.prev = nxt, out
        self.k += 1
        return ok, out

    def records(self):
        return self.kept_first.items + self.kept.items


@dataclasses.dataclass
class Window:
    step_ms: list
    wall_s: float
    failed: int
    outs: list          # the kind's counts of each successful step


def run_window(loop: Loop, seconds: float) -> Window:
    """Steps until ``seconds`` have passed, the check's sample kept."""
    loop.keep = True
    step_ms, outs, failed = [], [], 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while True:
        t0 = time.perf_counter()
        ok, out = loop.step()
        t1 = time.perf_counter()
        step_ms.append(1e3 * (t1 - t0))
        if ok:
            outs.append(loop.kind.counts(out))
        else:
            failed += 1
        if t1 >= t_end:
            break
    loop.keep = False
    return Window(step_ms, time.perf_counter() - t_start, failed, outs)


def warm_up(loop: Loop, n: int) -> None:
    """n untimed steps from a fresh episode's start."""
    loop.k = loop.mix.episode_steps
    for _ in range(n):
        loop.step()
