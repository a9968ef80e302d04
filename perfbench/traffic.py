"""The one traffic generator: episodes of MPC steps from a traffic file.

A traffic file (``perfbench/traffic/<name>.json``) holds only parameters:

* ``episode_steps``: MPC steps per episode.  Every episode starts at the
  configuration's published start state from the cold iterate (the start
  tiled over the horizon, zero inputs) and a cold QP; within an episode
  the plant state, the shifted solution and the QP warm start carry, as a
  controller runs.  With 1, every step is an episode's first;
* ``pool_episodes``: distinct sets of epistemic draws made at set-up;
  episode e of a run takes set e mod pool_episodes;
* ``warmup_episodes``: episodes run at set-up before the window;
* ``trace_steps``: steps traced after the window (``--trace 1``), from a
  fresh episode's start;
* ``compare_steps``, ``compare_first_steps``: how many of the window's
  steps the correctness check compares, drawn from the seed: a uniform
  sample of the steps, and one of the episodes' first steps (where
  ``episode_steps`` > 1);
* ``kind`` (optional, ``kind_of``): the kind of step, a file
  ``perfbench/kinds/<kind>.py`` (cell.kind_module); without it ``mpc``,
  the MPC step.  A kind may name further whole-number keys of its own
  (its ``MIX_KEYS``), kept in ``Mix.extra``.

The MPC step's draws (``Draws``) are the truncated normal on [-beta,
beta] of the program's ``agent.make_epistemic`` (inverse CDF of uniforms),
made here on the device from ``--seed`` in one call, and handed alike to
the program and to the reference; another kind shapes its own.
"""

from __future__ import annotations

import dataclasses
import json
import random

import torch

KEYS = ("episode_steps", "pool_episodes", "warmup_episodes", "trace_steps",
        "compare_steps", "compare_first_steps")


@dataclasses.dataclass(frozen=True)
class Mix:
    episode_steps: int
    pool_episodes: int
    warmup_episodes: int
    trace_steps: int
    compare_steps: int
    compare_first_steps: int
    extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path: str, kind_keys=()) -> "Mix":
        """The mix of a traffic file whose kind names the further keys
        ``kind_keys``."""
        with open(path) as f:
            raw = json.load(f)
        keys = KEYS + tuple(kind_keys)
        missing = [k for k in keys if k not in raw]
        extra = [k for k in raw if k not in keys and k != "kind"]
        if missing or extra:
            raise ValueError(f"{path}: missing {missing}, unknown {extra}")
        mix = cls(**{k: int(raw[k]) for k in KEYS},
                  extra={k: int(raw[k]) for k in kind_keys})
        if min(mix.episode_steps, mix.pool_episodes, mix.trace_steps,
               mix.compare_steps) < 1 or min(mix.warmup_episodes,
                                             mix.compare_first_steps) < 0:
            raise ValueError(f"{path}: counts out of range: {raw}")
        return mix


def kind_of(path: str) -> str:
    """The kind of step a traffic file names (``mpc`` where it names
    none)."""
    with open(path) as f:
        return str(json.load(f).get("kind", "mpc"))


def seed64(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    return random.Random(f"{seed}:{salt}").getrandbits(63)


def truncated_normal(shape, beta: float, generator, device, dtype):
    """Standard normal draws truncated to [-beta, beta] by the inverse CDF
    of uniforms, drawn in float64 from ``generator`` on its device."""
    b = torch.tensor(beta, dtype=torch.float64)
    normal = torch.distributions.Normal(0.0, 1.0)
    lo, hi = normal.cdf(-b).item(), normal.cdf(b).item()
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    x = torch.special.ndtri(lo + (hi - lo) * u).clamp(-beta, beta)
    return x.to(device=device, dtype=dtype)


class Draws:
    """The pool of epistemic draws of the MPC step: (pool, episode_steps,
    max_sqp_iter, ns, g_ny, H, Ty), made once from the seed (another kind
    gives its own ``shape``)."""

    def __init__(self, mix: Mix, sizes: dict, seed: int, device, dtype):
        gen = torch.Generator(device=device).manual_seed(seed64(seed, 1))
        self.pool = truncated_normal(self.shape(mix, sizes), sizes["beta"],
                                     gen, device, dtype)
        self.mix = mix

    @staticmethod
    def shape(mix: Mix, sizes: dict) -> tuple:
        return (mix.pool_episodes, mix.episode_steps, sizes["max_sqp_iter"],
                sizes["ns"], sizes["g_ny"], sizes["H"], sizes["Ty"])

    def episode(self, e: int):
        """The draws of episode e, one entry a step (MPC: (episode_steps,
        max_sqp_iter, ns, g_ny, H, Ty))."""
        return self.pool[e % self.mix.pool_episodes]


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream whose length is
    not known beforehand (reservoir sampling), drawn from ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, make):
        """Count one item; keep ``make()`` if the sample takes it."""
        self.seen += 1
        if self.k <= 0:
            return
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make()
