"""Device trace of the port's closed loop: where an MPC step's time goes.

Usage (on a machine with an NVIDIA GPU):

    python -m sampling_gpmpc_torch.profile_loop [-param NAME]
        [--trace-dir DIR]

Runs ``DEMPC.run`` (for ``params_drone_obstacles_approx``: the approximate
MPC's ``ApproxMPC.run``, pessimistic or with ``--optimistic``) three
times on CUDA float32: untraced to build and warm up, untraced again for
the wall time, and under ``torch.profiler`` with CPU and CUDA activity
(the host's torch ops and the program's spans, ``obs.py``, beside the
kernels, copies and fills on the card).  With ``--fs`` the traced work is one
forward-sampling rollout instead (``reachability.forward_sample_rollout``
over the config's ``num_MPC_itrs`` steps on zero inputs, with the
ancillary feedback, as ``simulate_forward_sampling`` runs it; e.g.
``-param params_car_residual_fs --fs``), and a "step" is one propagation
step.  Prints one JSON object:

* ``wall_ms`` / ``traced_wall_ms``: host clock around the untraced / the
  traced run, ending in a sync;
* ``device_busy_ms``: the union of the card's kernel, copy and fill
  intervals in the traced run; ``idle_share = 1 - busy / traced wall``;
* ``kernels_per_step`` and the kernels with the most device time;
* ``host_ms_per_step``: the traced run's host ms a step by layer
  (``obs.host_ms_by_layer``: each instant to the innermost span), the time
  outside spans included;
* ``idle_ms_by_span``: the card's idle ms by the innermost span open at
  each gap (``obs.idle_by_span``);
* ``host_ops``: the torch ops with the most self CPU time, with their
  calls per step.

The trace lands in ``--trace-dir`` (default ``build/``) as
``trace_loop_device.json``, the spans alone beside it as
``trace_loop_spans.json`` on the same clock.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

TOP = 10          # kernels and host ops listed


def _intervals_union_us(spans):
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_trace(prof, path):
    """Write the chrome trace of a ``torch.profiler`` run to ``path`` and
    read it back: the union of the card's kernel, copy and fill intervals
    in ms (``None`` where the trace holds none), the number of kernels, per
    kernel name [ms, count], and the trace as exported."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    spans, per_kernel = [], defaultdict(lambda: [0.0, 0])
    n_kernels = 0
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if cat == "kernel":
                n_kernels += 1
                k = per_kernel[e["name"][:80]]
                k[0] += float(e["dur"]) / 1e3
                k[1] += 1
    busy_ms = _intervals_union_us(spans) / 1e3 if spans else None
    return busy_ms, n_kernels, dict(per_kernel), trace


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-param", default="params_pendulum1D_samples")
    parser.add_argument("--trace-dir", default="build")
    parser.add_argument("--fs", action="store_true",
                        help="trace a forward-sampling rollout instead of "
                             "the closed loop")
    parser.add_argument("--optimistic", action="store_true",
                        help="the drone's optimistic planner")
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sampling_gpmpc_torch import obs, setup
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import DEMPC
    from sampling_gpmpc_torch.envs import make_env

    dev = setup.resolve_device("cuda")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = os.path.join(here, "params", args.param + ".yaml")
    if args.param.startswith("params_drone"):
        import yaml

        from sampling_gpmpc_torch.approx.solver import ApproxMPC
        with open(cfg) as fh:
            params = yaml.safe_load(fh)
        params["agent"]["run"]["optimistic"] = args.optimistic
        params["agent"]["run"]["pessimistic"] = not args.optimistic
        steps = params["common"]["num_MPC_itrs"]
        ns = params["agent"]["num_samples_tightening"]

        def run():
            mpc = ApproxMPC(params, dev, torch.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mpc.run(num_iters=steps)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0), out
    else:
        params, spec, data = load_problem(cfg)
        env = make_env(spec, params)
        steps, ns = spec.num_mpc_iter, spec.ns

        def run():
            mpc = DEMPC(params, spec, data, env, device=dev,
                        dtype=torch.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mpc.run()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0), out

    if args.fs:
        import numpy as np

        from sampling_gpmpc_torch import agent
        from sampling_gpmpc_torch.gp.exact import GPHyperArrays
        from sampling_gpmpc_torch.reachability import forward_sample_rollout
        hyp = GPHyperArrays.from_spec(spec.gp, dev, torch.float32)
        gp0 = agent.init_gp_state(spec, env, dev, torch.float32,
                                  capacity=steps, hyp=hyp)
        fb = ({"K": data.K_fb, "x_eq": data.goal}
              if spec.use_feedback and data.K_fb is not None else None)
        U = np.zeros((steps, spec.nu))

        def run():
            gen = torch.Generator().manual_seed(spec.seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward_sample_rollout(spec, env, hyp, gp0, data.start, U, gen,
                                   use_feedback=fb)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0), None

    run()                                            # build + warm up
    wall_ms, out = run()
    os.makedirs(args.trace_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall_ms, _ = run()
    busy_ms, n_kernels, per_kernel, trace = device_trace(
        prof, os.path.join(args.trace_dir, "trace_loop_device.json"))
    top_k = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    obs.write(os.path.join(args.trace_dir, "trace_loop_spans.json"),
              trace["baseTimeNanoseconds"])
    host_ms = defaultdict(float)
    for by_layer in obs.host_ms_by_layer(obs.spans()).values():
        for name, ms in by_layer.items():
            host_ms[name] += ms / steps
    idle = obs.idle_by_span([e for e in trace["traceEvents"]
                             if e.get("ph") == "X" and "dur" in e])
    host = sorted(prof.key_averages(),
                  key=lambda a: -a.self_cpu_time_total)[:TOP]

    loop = {} if out is None else {
        "solve_ms_sum": 1e3 * sum(out["solver_time"]),
        "first_solve_ms": 1e3 * out["solver_time"][0],
        "ipm_iters": out.get("qp_iters")}
    print(json.dumps({
        "config": args.param + (" optimistic" if args.optimistic else ""),
        "workload": "forward sampling" if args.fs else "closed loop",
        "steps": steps, "ns": ns,
        "card": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms, **loop,
        "traced_wall_ms": traced_wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": None if busy_ms is None
        else 1.0 - busy_ms / traced_wall_ms,
        "kernels_per_step": n_kernels / steps,
        "top_kernels": [{"name": n, "ms": v[0], "count": v[1]}
                        for n, v in top_k],
        "host_ms_per_step": dict(host_ms),
        "idle_ms_by_span": {k: v / 1e3 for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]},
        "host_ops": [{"name": a.key, "self_cpu_ms": a.self_cpu_time_total
                      / 1e3, "calls_per_step": a.count / steps}
                     for a in host],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
