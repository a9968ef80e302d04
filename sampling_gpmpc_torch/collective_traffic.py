"""Collective traffic of the sample-sharded solve, counted at run time.

Counterpart of ``profiling/collective_traffic.py``, which reads the JAX
sharded solve's collectives out of its compiled HLO.  The port has no HLO:
here the reducers of ``parallel/collectives.py`` count their own rounds
and payload bytes (``TrafficCounter``), per reducer kind and per scope:
"sqp" (an SQP iteration's body: the condensed cost, the convergence
norms), "qp prepare" (the QP's pre-loop) and "mehrotra" (the Mehrotra
loop: five sums, three mins and one max an iteration).  Two routes at the JAX
script's shape (``params_pendulum1D_samples`` at ns = 64, three forced SQP
iterations):

* the blocked route: ``make_blocked_solve``, the blocks threads of this
  process taking turns on one device;
* the multi-process route: ``--procs`` processes of this module, one rank
  each, over gloo (``torch.distributed``).

Both count the same rounds and bytes (one per-rank program).  The script
prints the table of rounds and bytes by kind and scope for each route,
the rounds and bytes per SQP iteration and per Mehrotra iteration, the
per-SQP-iteration payload at the measured Mehrotra trips, and the compute
per SQP iteration of the one-device solve on this device, beside which
the traffic is set by a latency-bandwidth model whose link numbers
(``LINKS``) are assumptions, not measurements.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.collective_traffic [--ns 64] \\
        [--blocks 4] [--procs 4] [--device cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CONFIG = "params_pendulum1D_samples"
SQP_ITERS = 3           # forced SQP iterations, as the JAX script's
SCOPE_ORDER = ("sqp", "qp prepare", "mehrotra")
# the model's links, (latency us, bandwidth GB/s): assumptions standing
# for a link within a node and one across nodes, not measurements
LINKS = ((5.0, 100.0), (25.0, 12.5))


def _problem(ns: int, device, dtype):
    from sampling_gpmpc_torch.parallel.worker import problem
    return problem(CONFIG, ns, SQP_ITERS, device, dtype)


def summarize(table: dict, sqp_iters: int, qp_iters: int) -> dict:
    """Per-solve rounds and bytes of one rank's table {(kind, scope):
    (rounds, bytes)}, and the rounds and bytes per SQP iteration (its body
    and the QP pre-loop) and per Mehrotra iteration."""
    def tot(scopes, i):
        return sum(v[i] for (_, s), v in table.items() if s in scopes)
    body = ("sqp", "qp prepare")
    return {
        "table": {f"{k} {s}": list(v) for (k, s), v in table.items()},
        "sqp_iters": sqp_iters, "mehrotra_iters": qp_iters,
        "rounds_per_sqp_iter": tot(body, 0) / sqp_iters,
        "bytes_per_sqp_iter": tot(body, 1) / sqp_iters,
        "rounds_per_mehrotra_iter": tot(("mehrotra",), 0) / max(qp_iters, 1),
        "bytes_per_mehrotra_iter": tot(("mehrotra",), 1) / max(qp_iters, 1),
    }


def blocked_traffic(ns: int, blocks: int, device, dtype):
    """The blocked route under a counter: (summary, every block's table
    equal)."""
    from sampling_gpmpc_torch.parallel.collectives import (TrafficCounter,
                                                           counting)
    from sampling_gpmpc_torch.parallel.sharded import make_blocked_solve
    spec, env, hyp, ocp, gp, X0, U0, st, eps = _problem(ns, device, dtype)
    counter = TrafficCounter()
    with counting(counter):
        out = make_blocked_solve(spec, env, hyp, ocp, blocks)(st, X0, U0, gp,
                                                              eps)
    tables = [counter.table(r) for r in range(blocks)]
    same = all(t == tables[0] for t in tables)
    return summarize(tables[0], int(out.it), int(out.qp_iters)), same


def one_device_ms(ns: int, device, dtype, repeats: int = 5):
    """Median ms per SQP iteration of the one-device solve (the kernels on
    the card), warm, host clock ending in a sync."""
    import torch

    from sampling_gpmpc_torch.ocp import sqp
    spec, env, hyp, ocp, gp, X0, U0, st, eps = _problem(ns, device, dtype)
    times = []
    for _ in range(repeats + 1):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
        it = int(out.it)                   # waits for the device
        times.append(1e3 * (time.perf_counter() - t0) / it)
    return float(np.median(times[1:]))


def rank_main(a) -> int:
    """One rank of the multi-process route: the sharded solve under a
    counter; writes this rank's table to ``--out``/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.parallel import distributed
    from sampling_gpmpc_torch.parallel.collectives import (TrafficCounter,
                                                           counting)
    from sampling_gpmpc_torch.parallel.mesh import sample_mesh
    from sampling_gpmpc_torch.parallel.sharded import make_sharded_solve
    dev = setup.resolve_device(a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    distributed.init_multihost(f"127.0.0.1:{a.port}", a.world, a.rank,
                               "gloo")
    try:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        group = sample_mesh().group
        dtype = (getattr(torch, a.dtype) if a.dtype
                 else setup.default_dtype(dev))
        spec, env, hyp, ocp, gp, X0, U0, st, eps = _problem(
            a.ns, dev, dtype)
        solve = make_sharded_solve(spec, env, hyp, ocp, group, ordered=True)
        counter = TrafficCounter()
        with counting(counter):
            out = solve(st, X0, U0, gp, eps)
        table = counter.table(a.rank)
        with open(os.path.join(a.out, f"rank{a.rank}.json"), "w") as f:
            json.dump({"table": [[k, s, n, b] for (k, s), (n, b)
                                 in table.items()],
                       "it": int(out.it), "qp_iters": int(out.qp_iters)}, f)
    finally:
        dist.destroy_process_group()
    return 0


def process_traffic(ns: int, procs: int, device: str,
                    dtype=None, timeout: float = 600.0):
    """The multi-process route: ``procs`` ranks of this module over gloo
    (in ``dtype``, else the device's default).  Returns (rank 0's summary,
    every rank's table equal)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cluster = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
               "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS")
    env = {k: v for k, v in os.environ.items() if k not in cluster}
    env["PYTHONPATH"] = root
    with tempfile.TemporaryDirectory() as out:
        ps = [subprocess.Popen(
            [sys.executable, "-m", "sampling_gpmpc_torch.collective_traffic",
             "--rank", str(r), "--world", str(procs), "--port", str(port),
             "--out", out, "--ns", str(ns),
             "--device", device]
            + (["--dtype", str(dtype).split(".")[-1]] if dtype else []),
            cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(procs)]
        logs = []
        try:
            for p in ps:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(ps, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} failed:\n{log[-3000:]}")
        res = []
        for r in range(procs):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                res.append(json.load(f))
    tables = [{(k, s): (n, b) for k, s, n, b in d["table"]} for d in res]
    same = all(t == tables[0] for t in tables)
    return summarize(tables[0], res[0]["it"], res[0]["qp_iters"]), same


def print_route(name: str, s: dict, same: bool) -> None:
    print(f"\n{name}: {s['sqp_iters']} SQP iterations, "
          f"{s['mehrotra_iters']} Mehrotra iterations; every rank the same "
          f"table: {same}")
    print(f"{'reducer':8s} {'scope':>11s} {'rounds':>7s} {'bytes':>10s}")
    for key, (n, b) in sorted(s["table"].items(), key=lambda kv: (
            SCOPE_ORDER.index(kv[0].split(' ', 1)[1]), kv[0])):
        kind, scope = key.split(" ", 1)
        print(f"{kind:8s} {scope:>11s} {n:7d} {b:10d}")
    print(f"per SQP iteration (body + QP pre-loop): "
          f"{s['rounds_per_sqp_iter']:.2f} rounds, "
          f"{s['bytes_per_sqp_iter']:.1f} bytes; per Mehrotra iteration: "
          f"{s['rounds_per_mehrotra_iter']:.2f} rounds, "
          f"{s['bytes_per_mehrotra_iter']:.1f} bytes")


def traffic(ns: int, blocks: int, procs: int, device, dtype) -> dict:
    """Count both routes, print their tables and the per-SQP-iteration
    model (``LINKS``); raise if the ranks or the routes counted
    differently.

    Returns:
        {route name: summary} and "compute_ms", "payload_bytes",
        "rounds" (per SQP iteration at the measured Mehrotra iterations).
    """
    routes = {f"blocked route ({blocks} blocks)":
              blocked_traffic(ns, blocks, device, dtype)}
    if procs:
        routes[f"multi-process route ({procs} ranks, gloo)"] = \
            process_traffic(ns, procs, device.type, dtype)
    for name, (s, same) in routes.items():
        print_route(name, s, same)
    sums = [s for s, _ in routes.values()]
    if not all(same for _, same in routes.values()):
        raise RuntimeError("ranks counted different tables")
    if any(s != sums[0] for s in sums):
        raise RuntimeError("the routes counted different tables")
    s = sums[0]
    trips = s["mehrotra_iters"] / s["sqp_iters"]
    per_sqp = s["bytes_per_sqp_iter"] + s["bytes_per_mehrotra_iter"] * trips
    n_coll = s["rounds_per_sqp_iter"] + s["rounds_per_mehrotra_iter"] * trips
    c_ms = one_device_ms(ns, device, dtype)
    print(f"\nper-SQP-iteration payload at the measured {trips:.1f} "
          f"Mehrotra iterations a QP: {per_sqp:.0f} bytes across "
          f"{n_coll:.1f} dependent rounds")
    print(f"compute per SQP iteration, one-device solve on {device}: "
          f"{c_ms:.3f} ms")
    for lat, bw in LINKS:
        t_comm = n_coll * lat * 1e-3 + per_sqp / (bw * 1e9) * 1e3
        print(f"model link {lat:g} us, {bw:g} GB/s: communication "
              f"{t_comm:.3f} ms a SQP iteration -> efficiency "
              f"{c_ms / (c_ms + t_comm):.1%}")
    return {"routes": {k: v[0] for k, v in routes.items()},
            "compute_ms": c_ms, "payload_bytes": per_sqp, "rounds": n_coll}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="collective traffic")
    ap.add_argument("--ns", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--procs", type=int, default=4,
                    help="ranks of the multi-process route (0: skip it)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) | cpu; float64 on the CPU")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dtype", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        return rank_main(a)

    import torch

    from sampling_gpmpc_torch import setup
    device, dtype = setup.resolve(a.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    print(f"{CONFIG} at ns={a.ns}, {SQP_ITERS} SQP iterations, {dtype} on "
          f"{device}" + (f" ({torch.cuda.get_device_name(device)})"
                         if device.type == "cuda" else ""))
    traffic(a.ns, a.blocks, a.procs, device, dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
