"""The body of one run: set-up, warm-up, window, traced steps, check, and
the result line's fields, for a step of the cell's kind (perfbench/kinds/).
``run.py`` calls it on the card; the tests call it on the CPU with a system
of their own."""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from perfbench import check, harness, trace


class NothingToRead(RuntimeError):
    """A metric that BENCHMARK.json gives the cell read nothing."""


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (perfbench/metrics/__init__.py)."""
    summary: object        # trace.Summary of the traced steps, or None
    sizes: dict            # the configuration's sizes (the kind's Program)
    traced: list           # the kind's counts a traced step (MPC: SQP
                           # iterations, QP iterations)
    window: list           # the same, each successful window step
    step_ms: list          # every window step's host-clock latency
    window_s: float        # the window's wall time
    setup_s: float         # module start to the first timed step

    @property
    def mean_step_ms(self) -> float:
        return 1e3 * self.window_s / len(self.step_ms)


def _ints(outs):
    return [tuple(int(v) for v in o) for o in outs]


def _traced_steps(loop, n: int, device):
    """n steps from a fresh episode's start under torch.profiler (host and
    device activity), each inside a ``perfbench_step`` annotation."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    loop.k = loop.mix.episode_steps
    outs = []
    with profile(activities=acts) as prof:
        for _ in range(n):
            with record_function(trace.STEP):
                ok, out = loop.step()
            if ok:
                outs.append(loop.kind.counts(out))
    return trace.reduce(trace.events_from_profiler(prof)), outs


def run(c, seed: int, seconds: float, traced: bool, device, t0: float,
        out_dir: str, log, make_system=None, dtype=torch.float32,
        card_state=lambda: {}, host_state=lambda: {},
        setup_parts=None) -> dict:
    """One run of cell ``c``; returns the result line as a dict, its
    ``checks`` last, ``build_s`` the part of ``setup_s`` that built or
    loaded the CUDA libraries (the nvcc build on a checkout's first run).
    ``setup_parts``: seconds of the set-up before this call, by part
    (``run.py``: imports, CUDA context); the run's record under
    ``out_dir`` gets them with this call's parts (problem, build/load,
    draws, warm-up).  Raises NothingToRead where a metric of the cell
    reads nothing."""
    device = torch.device(device)
    parts = dict(setup_parts or {})
    mark = time.perf_counter()

    def part(name):
        nonlocal mark
        harness.sync(device)
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    system = (make_system or c.kind.Program)(c.config_path, device, dtype)
    part("problem")
    log(f"{c.name}: libraries {system.libraries}, sizes {system.sizes}")
    system.build()
    part("build_load")
    build_s = parts["build_load"]
    log(f"build/load {build_s:.1f} s")
    draws = c.kind.Draws(c.mix, system.sizes, seed, device, dtype)
    part("draws")
    loop = harness.Loop(system, c.mix, draws, seed, c.kind)
    for _ in range(c.mix.warmup_episodes):
        harness.warm_up(loop, c.mix.episode_steps)
    part("warm_up")
    launches0 = dict(system.launch_counts())
    card0, host0 = card_state(), host_state()
    setup_s = time.perf_counter() - t0
    parts["other"] = setup_s - sum(parts.values())
    shares = ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
    log(f"set-up {setup_s:.3f} s ({shares}); window of {seconds} s")

    w = harness.run_window(loop, seconds)
    card1, host1 = card_state(), host_state()
    launches = {k: v - launches0.get(k, 0)
                for k, v in system.launch_counts().items()}
    summary, traced_outs = None, []
    if traced:
        summary, traced_outs = _traced_steps(
            loop, c.mix.trace_steps, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    ctx = Context(summary, dict(system.sizes), _ints(traced_outs),
                  _ints(w.outs), w.step_ms, w.wall_s, setup_s)
    records = loop.records()
    dt_ms = over_dt = None
    if "dt" in system.sizes:        # a control period: the MPC step's
        dt_ms = 1e3 * system.sizes["dt"]
        over_dt = sum(ms > dt_ms for ms in w.step_ms)
    log(f"window: {len(w.step_ms)} steps in {w.wall_s:.3f} s, {w.failed} "
        f"failed, {over_dt} over dt = {dt_ms} ms; {len(records)} kept")
    del loop, draws, system
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings = c.kind.compare(c, records, device, seed)
    correct, checks = check.verdict(readings, c.limits)
    log(f"check {time.perf_counter() - t_check:.1f} s: correct={correct}")

    names = c.per_layer if traced else c.end_to_end
    metrics = {}
    for m in names:
        v = c.readers[m["name"]].read(ctx)
        if v is None:
            raise NothingToRead(
                f"metric {m['name']} of {c.name} found nothing to read in "
                "this run (for a layer's share: no device op matches its "
                "prefixes)")
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_us / 1e6,
                   window_s=summary.window_us / 1e6)
    res = {"correct": bool(correct), "attempted": len(ctx.step_ms),
           "failed": w.failed,
           "metrics": metrics, "device": dev, "build_s": build_s}
    if summary is not None:
        res["breakdown"] = summary.breakdown()
    res["checks"] = checks

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"seed{seed}_trace{int(traced)}.json"),
              "w") as f:
        json.dump({"workload": c.name, "seed": seed, "seconds": seconds,
                   "card_before": card0, "card_after": card1,
                   "host_before": host0, "host_after": host1,
                   "setup_s": setup_s, "setup_parts": parts,
                   "dt_ms": dt_ms, "over_dt": over_dt,
                   "step_ms": w.step_ms, "launches": launches,
                   "readings": readings, "result": res}, f)
    return res
