"""The port's bench: warm closed-loop solves per second on the card.

Counterpart of the repository root's ``bench.py``, which stays the JAX
package's bench: the same workloads, rows and keys, measured on an NVIDIA
GPU through the port's CUDA kernels.

Usage (from the repository root, on a machine with an NVIDIA GPU):

    python -m sampling_gpmpc_torch.bench [--seed N] [--device cuda|cpu]
        [--skip-512] [--skip-car] [--skip-equiv] [--trace-dir D]

Rows (float32; each step's draws from ``agent.make_epistemic`` with a
generator seeded by ``--seed``, the config's seed by default; the row
functions take their sizes as arguments, and :func:`mpc_step` and
``ClosedLoop.step`` take injected draws):

* ``value``: ``params_pendulum1D_samples`` at ns = 64, H = 20, one RTI
  iteration a step; 3 warm-up and 100 timed closed-loop steps, each
  :func:`mpc_step` (the SQP solve with the QP warm start carried, the
  plan's first input with the ancillary feedback applied to the plant,
  the solution shift) timed on the host clock ending in
  ``torch.cuda.synchronize()``.  ``value`` = 1 / mean step time; the
  median, the p90 and the cold step 0 beside it; ``idle_share``: 1 -
  device busy time over wall time, both of one separate window of 5 steps
  under ``torch.profiler``;
* ``ns512_value``: the same at ns = 512 (3 + 80 steps);
* ``car_value``: ``params_car`` (ns = 20, H = 15, 4 SQP iterations a step:
  the hall-block GP stage), 3 + 80 steps;
* ``fs_value``: ``params_car_residual_fs`` forward sampling, 4000
  realizations x 50 steps, sampled steps per second of the fastest of 3
  rollouts after 1, and ``fs_nan_frac``;
* the kernels against their plain versions on the card: the same ns = 64
  solve through all kernels, through the plain GP stage with the IPM
  kernels, and all plain (``kernel_gp_vs_plain_maxdiff``,
  ``kernel_ipm_vs_plain_maxdiff``); the car's hall-block stage against its
  plain version and the float32 posterior's tube
  (``kernel_hall_vs_plain_maxdiff``, ``kernel_hall_tube_violation``);
* ``*_vs_baseline``: the same port computation on the host CPU in float32
  (ns = 64: 20 + 100 steps, ns = 512: 20 + 40, the car 10 + 20; the
  fastest of 2), and for forward sampling the reference-shaped per-step
  refit in float64 on the CPU (``fs_refit_baseline``, 200 x 30, the
  fastest of 5).  Annulled, with a note, when the host's load average is
  high: the baselines run on the host the card shares.

Any failure exits non-zero: a row that raises, a QP status other than 0
or a non-finite state at any closed-loop step.  Without CUDA the bench
raises unless ``--device cpu`` is given (the tests' tiny runs).  Progress
goes to stderr; the last line of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from sampling_gpmpc_torch import agent, fs_refit_baseline, setup
from sampling_gpmpc_torch.config import load_problem, make_data
from sampling_gpmpc_torch.dempc import shift_solution
from sampling_gpmpc_torch.envs import make_env
from sampling_gpmpc_torch.gp import exact
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.assemble import row_counts
from sampling_gpmpc_torch.ocp.spec import make_ocp_data
from sampling_gpmpc_torch.ops import build as kernels
from sampling_gpmpc_torch.ops import routes
from sampling_gpmpc_torch.reachability import forward_sample_rollout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_CONFIG = "params_pendulum1D_samples"
CAR_CONFIG = "params_car"
FS_CONFIG = "params_car_residual_fs"
DTYPE = torch.float32
# float32 posterior-variance cancellation floor of the hall tube, as a share
# of the prior variance (the JAX bench's NOISE_REL)
NOISE_REL = 1e-3


class Sizes(NamedTuple):
    """The bench's sizes: (warm-up, timed) steps of each closed-loop row
    on the device and on the CPU, and the forward-sampling shapes."""
    ns: int = 64
    ns_large: int = 512
    H: int = 20
    loop: Tuple[int, int] = (3, 100)
    loop_large: Tuple[int, int] = (3, 80)
    car: Tuple[int, int] = (3, 80)
    trace_steps: int = 5
    cpu_loop: Tuple[int, int] = (20, 100)
    cpu_large: Tuple[int, int] = (20, 40)
    cpu_car: Tuple[int, int] = (10, 20)
    cpu_reps: int = 2
    fs: Tuple[int, int] = (4000, 50)        # realizations, steps
    fs_runs: Tuple[int, int] = (1, 3)       # warm-up, timed rollouts
    fs_cpu: Tuple[int, int] = (200, 30)
    fs_cpu_reps: int = 5


def _problem(config: str, base: dict, overrides):
    params, spec, data = load_problem(
        os.path.join(ROOT, "params", config + ".yaml"))
    spec = dataclasses.replace(spec, **{**base, **(overrides or {})})
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    # re-derive what depends on H (the tightenings, the cost profile)
    data = make_data(params, spec)
    return params, spec, data, make_env(spec, params)


def build(overrides=None):
    """params_pendulum1D_samples at the bench's ns = 64, H = 20, one RTI
    iteration a step, with ``overrides`` of the spec; (params, spec,
    data, env)."""
    return _problem(LOOP_CONFIG, dict(ns=64, H=20, max_sqp_iter=1,
                                      num_mpc_iter=1), overrides)


def build_car(overrides=None):
    """params_car (ns = 20, H = 15, 4 SQP iterations a step) with
    ``overrides``; (params, spec, data, env)."""
    return _problem(CAR_CONFIG, dict(num_mpc_iter=103), overrides)


def draws(spec, steps: int, seed: int, device, dtype=DTYPE):
    """The epistemic draws of ``steps`` MPC steps, (steps, max_sqp_iter,
    ns, g_ny, H, Ty), from a generator seeded with ``seed``."""
    return agent.make_epistemic(
        dataclasses.replace(spec, num_mpc_iter=steps),
        torch.Generator().manual_seed(seed), device, dtype)


def mpc_step(spec, env, hyp, ocp, x, X, U, gp, qp_ws, qp_valid, eps, K_fb,
             goal):
    """One closed-loop step: the SQP solve from the iterate (X, U) with the
    QP warm start carried, the plan's first input (with the ancillary
    feedback where ``K_fb`` is given) applied to the plant from X[0, 0],
    and the solution shifted where the config shifts it.  Returns the next
    state, the next iterate and the SolveState (its gp, qp_ws and qp_valid
    are the rest of the carry)."""
    st = sqp.solve(spec, env, hyp, ocp, x, X, U, gp, eps, qp_ws, qp_valid)
    X, U = st.X, st.U
    u0 = U[0]
    if K_fb is not None:
        u0 = u0 - (goal - X[0, 0]) @ K_fb.T
    x_next = env.discrete_dyn(X[0, 0], u0).reshape(-1)
    if spec.shift_soln:
        X, U = shift_solution(X, U)
    return x_next, X, U, st


class ClosedLoop:
    """The carry of :func:`mpc_step` on one device, from the bench's start:
    the config's start state, ``init_iterate`` and a cold QP."""

    def __init__(self, spec, data, env, device, dtype=DTYPE):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa
                                      device=device)
        self.spec, self.env = spec, env
        self.ocp = make_ocp_data(spec, data, device, dtype)
        self.hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)
        self.gp = agent.init_gp_state(spec, env, device, dtype, hyp=self.hyp)
        self.X, self.U = sqp.init_iterate(spec, device, dtype, data.start)
        self.qp_ws = sqp.init_qp_ws(spec, device, dtype)
        self.qp_valid = torch.zeros((), dtype=torch.bool, device=device)
        self.x = t(data.start)
        self.K_fb = t(data.K_fb) if spec.use_feedback else None
        self.goal = t(data.goal)

    def step(self, eps):
        """One :func:`mpc_step` on the step's draws ``eps`` (max_sqp_iter,
        ns, g_ny, H, Ty); returns its SolveState."""
        self.x, self.X, self.U, st = mpc_step(
            self.spec, self.env, self.hyp, self.ocp, self.x, self.X, self.U,
            self.gp, self.qp_ws, self.qp_valid, eps, self.K_fb, self.goal)
        self.gp, self.qp_ws, self.qp_valid = st.gp, st.qp_ws, st.qp_valid
        return st

    def check(self, st, label: str):
        """Raise on a QP status other than 0 or a non-finite state or plan
        (syncs with the device)."""
        status = int(st.status)
        if status != 0:
            raise RuntimeError(f"{label}: QP status {status}")
        if not all(bool(torch.isfinite(a).all())
                   for a in (self.x, self.X, self.U)):
            raise RuntimeError(f"{label}: non-finite state")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile (0 < q <= 100): the smallest value with
    at least q % of the values at or below it (of 100 values, p90 leaves
    10 beyond it)."""
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)), 1) - 1]


def summary(step_ms) -> dict:
    """The timed steps' mean, median and p90 ms, their count, and the rate
    ``value`` = 1 / mean in steps per second."""
    mean = sum(step_ms) / len(step_ms)
    return {"value": 1e3 / mean, "mean_ms": mean,
            "median_ms": statistics.median(step_ms),
            "p90_ms": percentile(step_ms, 90), "steps": len(step_ms)}


def loop_row(spec, data, env, device, warmup: int, timed: int, seed: int,
             label: str, trace_steps: int = 0, trace_dir: str = None,
             dtype=DTYPE) -> dict:
    """``warmup`` + ``timed`` closed-loop steps from the bench's start, each
    timed on the host clock ending in a device sync, then checked (QP
    status 0, finite state).  The launch counters are zeroed after the
    warm-up and read after the timed steps.  With ``trace_steps``, that
    many more steps run under ``torch.profiler`` (CUDA activity; trace in
    ``trace_dir``) for the device idle share: 1 - their busy time over
    their wall time."""
    n = warmup + timed + trace_steps
    eps = draws(spec, n, seed, device, dtype)
    loop = ClosedLoop(spec, data, env, device, dtype)
    step_ms, sqp_its, qp_its = [], [], []

    def step(m):
        t0 = time.perf_counter()
        st = loop.step(eps[m])
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        loop.check(st, f"{label} step {m}")
        return st, ms

    for m in range(warmup + timed):
        if m == warmup:
            routes.zero_launch_counts()
        st, ms = step(m)
        step_ms.append(ms)
        sqp_its.append(int(st.it))
        qp_its.append(int(st.qp_iters))
    launches = routes.launch_counts()
    nU = spec.H * spec.nu
    row = {**summary(step_ms[warmup:]), "cold_ms": step_ms[0],
           "step_ms": step_ms, "sqp_iters": sqp_its, "qp_iters": qp_its,
           "launches": launches,
           "launches_per_step": {k: v / timed for k, v in launches.items()},
           "qp_shape": (nU, *row_counts(spec))}
    if trace_steps:
        from torch.profiler import ProfilerActivity, profile

        from sampling_gpmpc_torch.profile_loop import device_trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for m in range(warmup + timed, n):
                step(m)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        os.makedirs(trace_dir, exist_ok=True)
        busy_ms, n_kernels, _, _ = device_trace(
            prof, os.path.join(trace_dir, "trace_bench_device.json"))
        if busy_ms is None:
            raise RuntimeError(f"{label}: the trace holds no device work")
        row.update(
            idle_share=1.0 - busy_ms / wall_ms,
            device_busy_ms_per_step=busy_ms / trace_steps,
            kernels_per_step=n_kernels / trace_steps)
    return row


def cpu_baseline(spec, data, env, warmup: int, timed: int, reps: int,
                 seed: int, label: str) -> float:
    """Mean ms per step of the same closed loop on the host CPU in float32
    (the kernels' plain versions), the fastest of ``reps`` runs."""
    return min(loop_row(spec, data, env, "cpu", warmup, timed, seed,
                        f"{label} cpu baseline")["mean_ms"]
               for _ in range(reps))


def equiv_check(spec, data, env, device, seed: int, dtype=DTYPE) -> dict:
    """The same cold solve three ways on ``device``: through all kernels,
    through the plain GP stage with the glue and IPM kernels, and all
    plain.  Returns {"gp": (max|dX|, max|dU|) of the first two, "ipm": ...
    of the last two (the glue kernel's and the IPM's together)}, in units
    of the solution."""
    eps = draws(spec, 1, seed, device, dtype)[0]

    def solve(gp_plain, qp_plain):
        with routes.plain_route(gp=gp_plain, qp=qp_plain,
                                glue=gp_plain and qp_plain):
            loop = ClosedLoop(spec, data, env, device, dtype)
            st = loop.step(eps)
        loop.check(st, f"equivalence solve (plain GP {gp_plain}, plain QP "
                       f"{qp_plain})")
        return st.X, st.U

    a, b, c = solve(False, False), solve(True, False), solve(True, True)
    d = lambda p, q: float(torch.max(torch.abs(p - q)))  # noqa: E731
    return {"gp": (d(a[0], b[0]), d(a[1], b[1])),
            "ipm": (d(b[0], c[0]), d(b[1], c[1]))}


def hall_equiv_check(device, seed: int, dtype=DTYPE) -> dict:
    """The hall-block GP stage against its plain version at identical
    inputs: params_car's SQP iteration 1 from the iterate of a 2-iteration
    solve (plain GP; glue and IPM kernels), the hall buffer filled by a
    real iteration-0 append, the test points moved by 0.01 normal noise.
    The tube criterion: every kernel draw within beta (sigma + sigma_n) of the
    float32 posterior mean, sigma_n = sqrt(NOISE_REL prior variance) the
    float32 variance's cancellation floor.  Returns the raw max |dg kernel
    - plain| ("dg"), that difference as a share of the tube width ("rel")
    and the largest excursion past the tube ("viol", 0 = pass)."""
    _, spec, data, env = build_car({"max_sqp_iter": 2})
    eps = draws(spec, 2, seed, device, dtype)
    loop = ClosedLoop(spec, data, env, device, dtype)
    hyp = loop.hyp
    with routes.plain_route(gp=True, qp=False, glue=False):
        warm = loop.step(eps[0])
        loop.check(warm, "hall equivalence: the 2-iteration solve")
        xu = sqp._linearization_inputs(spec, loop.ocp, warm.X, warm.U)
        Xt = xu[..., list(spec.g_idx_inputs)]
        _, gp_f = agent.sample_dynamics(spec, env, hyp,
                                        agent.reset_hall(loop.gp), Xt,
                                        eps[1, 0], hall_empty=True)
        noise = torch.randn(Xt.shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(5))
        Xt1 = Xt + 0.01 * noise.to(device=Xt.device, dtype=dtype)
        dg_x = agent.sample_dynamics(spec, env, hyp, gp_f, Xt1, eps[1, 1])[0]
        mean, cov = agent._batched_posterior_incremental(spec, hyp, gp_f,
                                                         Xt1)
    dg_p = agent.sample_dynamics(spec, env, hyp, gp_f, Xt1, eps[1, 1])[0]
    shape = (spec.ns, spec.g_ny, spec.H, spec.Ty)
    mu = mean.reshape(shape)
    var = torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                      min=0.0).reshape(shape)
    pv = exact.prior_task_variances(hyp.lengthscale, hyp.outputscale,
                                    spec.Ty)                  # (g_ny, Ty)
    tube = spec.gp.beta * (torch.sqrt(var)
                           + torch.sqrt(NOISE_REL * pv)[None, :, None, :])
    diff = torch.abs(dg_p - dg_x)
    return {"dg": float(diff.max()), "rel": float((diff / tube).max()),
            "viol": float(torch.clamp(torch.abs(dg_p - mu) - tube,
                                      min=0.0).max())}


def fs_problem(ns: int):
    """params_car_residual_fs at ``ns`` realizations: (params, spec,
    data, env)."""
    params, spec, data = load_problem(
        os.path.join(ROOT, "params", FS_CONFIG + ".yaml"))
    spec = dataclasses.replace(spec, ns=ns)
    params["agent"]["num_dyn_samples"] = ns
    return params, spec, data, make_env(spec, params)


def fs_row(device, ns: int, steps: int, seed: int, warmup: int = 1,
           reps: int = 3, dtype=DTYPE) -> dict:
    """Forward sampling (``forward_sample_rollout``: ns realizations x
    ``steps`` steps on zero inputs with the ancillary feedback), the
    fastest of ``reps`` rollouts after ``warmup``, each on its own draws,
    timed on the host clock ending in a device sync."""
    _, spec, data, env = fs_problem(ns)
    hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)
    gp0 = agent.init_gp_state(spec, env, device, dtype, capacity=steps,
                              hyp=hyp)
    U = np.zeros((steps, spec.nu))
    fb = ({"K": data.K_fb, "x_eq": data.goal}
          if spec.use_feedback and data.K_fb is not None else None)

    def roll(r):
        gen = torch.Generator().manual_seed(seed + r)
        return forward_sample_rollout(spec, env, hyp, gp0, data.start, U,
                                      gen, use_feedback=fb)[0]

    for r in range(warmup):
        roll(r)
    sync(device)
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        X = roll(100 + r)
        sync(device)
        best = min(best, time.perf_counter() - t0)
    X = X.cpu().numpy()
    return {"value": ns * steps / best, "seconds": best,
            "nan_frac": float(np.isnan(X).mean()),
            "nonfinite_realizations":
                int((~np.isfinite(X).all(axis=(0, 2))).sum())}


def fs_baseline(ns: int, steps: int, reps: int) -> float:
    """Sampled steps per second of ``fs_refit_baseline`` (the reference's
    per-step refit, float64 on the CPU) at ns x steps, the fastest of
    ``reps``, with torch's threads pinned to at most 8 (restored after)."""
    params, spec, data, _ = fs_problem(ns)
    U = np.zeros((steps, spec.nu))
    threads = torch.get_num_threads()
    torch.set_num_threads(min(8, os.cpu_count() or 8))
    try:
        return max(fs_refit_baseline.run(params, spec, data, ns, steps, U,
                                         seed=0)["steps_per_s"]
                   for _ in range(reps))
    finally:
        torch.set_num_threads(threads)


def host_load():
    """(1-minute load average, its limit, whether the host is loaded):
    above half the cores (at least 4), the in-process CPU baselines are
    unreliable."""
    try:
        load = round(os.getloadavg()[0], 2)
    except OSError:
        load = -1.0
    limit = max(4.0, 0.5 * (os.cpu_count() or 8))
    return load, limit, load > limit


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _row_keys(prefix: str, row: dict) -> dict:
    keys = ("mean_ms", "median_ms", "p90_ms", "steps", "cold_ms",
            "launches_per_step", "qp_shape")
    out = {f"{prefix}{k}": row[k] for k in keys}
    out[f"{prefix}qp_iters_mean"] = statistics.mean(
        row["qp_iters"][-row["steps"]:])
    out[f"{prefix}qp_iters_max"] = max(row["qp_iters"][-row["steps"]:])
    return out


def run(device=None, seed=None, sizes: Sizes = Sizes(), skip_512=False,
        skip_car=False, skip_equiv=False, baselines=True,
        trace_dir=os.path.join(ROOT, "build")):
    """Every row; returns (the JSON record, the rows' results).
    ``baselines=False`` leaves out the CPU baselines (their ratios are
    then None)."""
    dev = setup.resolve_device(device)
    t_start = time.perf_counter()
    _, spec, data, env = build(dict(ns=sizes.ns, H=sizes.H))
    seed = spec.seed if seed is None else seed
    on_card = dev.type == "cuda"
    card = setup.card_line() if on_card else "cpu"
    build_s = None
    if on_card:
        # the loops' kernel libraries, built before the rows so that each
        # row's cold step is a cold solve and not a build
        t0 = time.perf_counter()
        kernels.build_all(("gp_sample", "gp_hall", "ipm", "glue"))
        build_s = time.perf_counter() - t0
    where = f"on {card}" if on_card else "on the CPU"
    notes, rows = [], {}
    load, limit, loaded = host_load()
    if not on_card:
        notes.append("run on the CPU: no CPU baseline, no trace")
    elif not baselines:
        notes.append("CPU baselines not run")
    elif loaded:
        notes.append(f"load_avg {load} > {limit:.0f}: in-process CPU "
                     "baselines unreliable; every *_vs_baseline annulled")
    with_base = on_card and baselines and not loaded

    rows["ns64"] = loop_row(spec, data, env, dev, *sizes.loop, seed, "ns64",
                            trace_steps=sizes.trace_steps if on_card else 0,
                            trace_dir=trace_dir)
    log(f"ns={sizes.ns}: {rows['ns64']['value']:.3f} solves/s")
    vs = None
    if with_base:
        vs = cpu_baseline(spec, data, env, *sizes.cpu_loop, sizes.cpu_reps,
                          seed, "ns64") / rows["ns64"]["mean_ms"]
    record = {
        "metric": "sqp_solves_per_s", "value": rows["ns64"]["value"],
        "unit": f"solves/s {where} (float32): warm closed-loop "
                f"GP-sampling SQP-RTI steps (solve + plant step + shift) of "
                f"{LOOP_CONFIG} at ns={sizes.ns}, H={sizes.H}; 1 / mean "
                f"host-clock step over {sizes.loop[1]} steps after "
                f"{sizes.loop[0]}, each ending in a device sync; cpu "
                f"baseline = the same port computation on the host CPU in "
                f"float32, fastest of {sizes.cpu_reps}",
        "vs_baseline": vs, **_row_keys("", rows["ns64"]),
        "idle_share": rows["ns64"].get("idle_share"),
        "kernels_per_step": rows["ns64"].get("kernels_per_step"),
        "load_avg_1min": load}

    big = dict(ns512_value=None, ns512_vs_baseline=None)
    if skip_512:
        notes.append(f"ns={sizes.ns_large} row skipped")
    else:
        _, spec5, data5, env5 = build(dict(ns=sizes.ns_large, H=sizes.H))
        r = rows["ns512"] = loop_row(spec5, data5, env5, dev,
                                     *sizes.loop_large, seed, "ns512")
        log(f"ns={sizes.ns_large}: {r['value']:.3f} solves/s")
        big.update(ns512_value=r["value"], **_row_keys("ns512_", r))
        if with_base:
            big["ns512_vs_baseline"] = cpu_baseline(
                spec5, data5, env5, *sizes.cpu_large, sizes.cpu_reps, seed,
                "ns512") / r["mean_ms"]
    big["ns512_unit"] = (f"solves/s {where}, the same warm closed-loop "
                         f"metric at ns={sizes.ns_large} (the method's "
                         f"published sample scale)")

    car = dict(car_value=None, car_vs_baseline=None)
    if skip_car:
        notes.append("car row skipped")
    else:
        _, specc, datac, envc = build_car()
        r = rows["car"] = loop_row(specc, datac, envc, dev, *sizes.car, seed,
                                   "car")
        log(f"car: {r['value']:.3f} solves/s")
        car.update(car_value=r["value"], **_row_keys("car_", r),
                   car_sqp_iters_mean=statistics.mean(
                       r["sqp_iters"][-r["steps"]:]))
        if with_base:
            car["car_vs_baseline"] = cpu_baseline(
                specc, datac, envc, *sizes.cpu_car, sizes.cpu_reps, seed,
                "car") / r["mean_ms"]
    car["car_unit"] = (f"solves/s {where}, {CAR_CONFIG} closed loop (ns=20, "
                       f"H=15, 4 SQP iterations a step: iterations >= 1 run "
                       f"the hallucination-block GP stage)")

    equiv = dict(kernel_gp_vs_plain_maxdiff=None,
                 kernel_ipm_vs_plain_maxdiff=None,
                 kernel_hall_vs_plain_maxdiff=None,
                 kernel_hall_tube_violation=None)
    if skip_equiv:
        notes.append("kernel-against-plain checks skipped")
    else:
        rows["equiv"] = equiv_check(spec, data, env, dev, seed)
        rows["hall"] = hall_equiv_check(dev, seed)
        equiv.update(
            kernel_gp_vs_plain_maxdiff=max(rows["equiv"]["gp"]),
            kernel_ipm_vs_plain_maxdiff=max(rows["equiv"]["ipm"]),
            kernel_hall_vs_plain_maxdiff=rows["hall"]["dg"],
            kernel_hall_tube_violation=rows["hall"]["viol"])
        if rows["hall"]["viol"] > 0.0:
            notes.append(f"the hall kernel left the tube by "
                         f"{rows['hall']['viol']:.2e}")
    equiv["equiv_unit"] = (
        f"{where}: max |solution difference| of the same ns={sizes.ns} solve"
        f" with the GP kernel (gp) or the IPM kernels (ipm) swapped for "
        f"their plain versions; the hall-block stage's max |draw "
        f"difference| against its plain version and its excursion past "
        f"the float32 tube (0 = pass)")

    ns_fs, steps_fs = sizes.fs
    r = rows["fs"] = fs_row(dev, ns_fs, steps_fs, seed, *sizes.fs_runs)
    log(f"fs: {r['value']:.1f} sampled steps/s")
    fs_vs = None
    if with_base:
        fs_vs = r["value"] / fs_baseline(*sizes.fs_cpu, sizes.fs_cpu_reps)
    record.update(big)
    record.update(car)
    record.update(equiv)
    record.update({
        "notes": notes,
        "fs_metric": "gp_sample_rollout_steps_per_s",
        "fs_value": r["value"],
        "fs_unit": f"sampled steps/s {where} (ns={ns_fs} GP realizations x "
                   f"{steps_fs} steps, per-step iterative conditioning, "
                   f"float32, fastest of {sizes.fs_runs[1]}; vs the "
                   f"reference-shaped per-step-refit float64 CPU baseline "
                   f"at {sizes.fs_cpu[0]} x {sizes.fs_cpu[1]})",
        "fs_vs_baseline": fs_vs,
        "fs_nan_frac": r["nan_frac"],
        "device": card, "seed": seed, "dtype": str(DTYPE),
        "build_s": build_s, "seconds": time.perf_counter() - t_start})
    return record, rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the draws (default: the config's)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    parser.add_argument("--skip-512", action="store_true")
    parser.add_argument("--skip-car", action="store_true")
    parser.add_argument("--skip-equiv", action="store_true")
    parser.add_argument("--trace-dir", default=os.path.join(ROOT, "build"),
                        help="where the traced window's device trace goes")
    args = parser.parse_args(argv)
    record, _ = run(args.device, args.seed, skip_512=args.skip_512,
                    skip_car=args.skip_car, skip_equiv=args.skip_equiv,
                    trace_dir=args.trace_dir)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
