"""Host cost of the in-process sharded solve on one card.

Times one RTI solve of params_pendulum1D_samples at ns = 64 (float32 on
the card) through the one-device route with the IPM kernels, the same
route with the plain QP body (``ipm.run_full_plain``), and the blocked
route (``parallel.sharded.make_blocked_solve``) at 1, 2 and 4 blocks: the
blocks take turns, each issuing the one-device op count on its share of
the samples, and the QP under the group is the plain body with its
collectives.  Host clock around each solve, ending in a device sync;
after one warm-up call, the median of ``--repeats``.

    python -m sampling_gpmpc_torch.microbench_shard [--repeats 3]

Prints one JSON line: ms per solve by route, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ops import ipm
from sampling_gpmpc_torch.parallel.sharded import make_blocked_solve
from sampling_gpmpc_torch.parallel.worker import problem


def _ms(fn, repeats):
    fn()                                     # warm-up
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ns", type=int, default=64)
    a = ap.parse_args(argv)
    dev = setup.resolve_device("cuda")
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_pendulum1D_samples", a.ns, 1, dev, torch.float32)
    args = (st, X0, U0, gp, eps)
    one = lambda: sqp.solve(spec, env, hyp, ocp, *args)  # noqa: E731
    ms = {"one_device_kernels": _ms(one, a.repeats)}
    saved = ipm.run_full
    ipm.run_full = ipm.run_full_plain
    try:
        ms["one_device_plain_qp"] = _ms(one, a.repeats)
    finally:
        ipm.run_full = saved
    for n in (1, 2, 4):
        blocked = make_blocked_solve(spec, env, hyp, ocp, n)
        ms[f"blocked_{n}"] = _ms(lambda: blocked(*args), a.repeats)
    card = setup.card_line()
    print(json.dumps({"config": "params_pendulum1D_samples", "ns": a.ns,
                      "sqp_iterations": 1, "ms_per_solve": ms,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
