"""Device time of the two IPM kernels, from the CUDA trace, on the GPU.

For seeded QPs (``ops/ipm.seeded_qp``) at the closed loops' shapes
(pendulum nU=17, m_h=7174, m_s=70; car nU=30, m_h=60, m_s=2480), at the
seeded wide QPs ``chip_smoke.py`` checks and at the hard-only loops'
shapes (m_s = 0: params_pendulum nU=30, m_h=2460; params_pendulum_samples
nU=1, m_h=2002; params_car_residual nU=100, m_h=800), cold and warm
started (the
carried state of a plain solve, with g moved by 1e-3, so the warm start is
accepted), it times ``ipm.prepare`` and ``ipm.mehrotra`` by the mean
device duration of their kernels under ``torch.profiler`` over N calls:
the kernels' own time, whatever the Python wrappers cost on the host;
and the host time of one ``ipm.prepare`` call (N calls back to back, no
synchronization).
Prints one line per QP and start, then one JSON line.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.microbench_ipm [--n 50]

It uses only ``ipm.prepare``, ``ipm.mehrotra``, ``ipm.seeded_qp`` and
``ipm.run_full_plain``, so the same file times another checkout's kernels
when that checkout comes first on the path:
    PYTHONPATH=<checkout> python sampling_gpmpc_torch/microbench_ipm.py
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

QPS = ((17, 7174, 70), (30, 60, 2480), (20, 52000, 512), (64, 4000, 400),
       (128, 20000, 1000), (30, 2460, 0), (1, 2002, 0), (100, 800, 0))


def device_us(fn, name: str, n: int) -> float:
    """Mean device microseconds of the kernels whose name holds ``name``
    per fn() call, over n warm calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0.0)
                for e in prof.key_averages() if name in e.key)
    return total / n


def run(n: int = 50) -> list:
    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    from sampling_gpmpc_torch.ops import ipm
    dev = setup.resolve_device("cuda")
    kw = (3e-5, 1e-7, 150, qp_mod.STALL_ITERS, qp_mod.STALL_RTOL,
          qp_mod.MU_GRIND, qp_mod.WS_BAND)
    consts = kw[3:6]
    rows = []
    for shape in QPS:
        args = ipm.seeded_qp(*shape, 5, dev)
        sol = qp_mod._finish(*ipm.run_full_plain(*args, None, None, *kw),
                             3e-5)
        moved = list(args)
        moved[1] = args[1] + 1e-3
        valid = torch.ones((), dtype=torch.bool, device=dev)
        for start, a, ws, wv in (("cold", args, None, None),
                                 ("warm", moved, sol.state, valid)):
            prep = lambda: ipm.prepare(*a, ws, wv, qp_mod.WS_BAND)
            d = prep()
            t_p = device_us(prep, "ipm_prepare", n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                prep()
            h_p = 1e6 * (time.perf_counter() - t0) / n
            torch.cuda.synchronize()
            iters = int(ipm.mehrotra(d, 3e-5, 1e-7, 150, *consts)[2])
            t_m = device_us(lambda: ipm.mehrotra(d, 3e-5, 1e-7, 150,
                                                 *consts),
                            "ipm_mehrotra", max(5, n // 5))
            row = dict(nU=shape[0], m_h=shape[1], m_s=shape[2], start=start,
                       prepare_us=t_p, prepare_host_us=h_p, mehrotra_us=t_m,
                       iters=iters)
            print(f"[ipm] nU={shape[0]} m_h={shape[1]} m_s={shape[2]} "
                  f"{start}: prepare {t_p:.3f} us (the wrapper's host time "
                  f"{h_p:.1f} us a call), mehrotra {t_m:.3f} us "
                  f"({iters} iterations)", flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50)
    args = ap.parse_args(argv)
    rows = run(args.n)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ipm": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
