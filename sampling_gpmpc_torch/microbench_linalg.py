"""Batched small-matrix linalg kernels against the library, on the GPU.

Counterpart of ``profiling/microbench_linalg.py``: the entry point that
runs the port's batched Cholesky (``ops/batch_linalg.chol``), triangular
solve (``ops/batch_linalg.tri_solve``, both directions) and masked batched
Cholesky (``ops/batched_chol.batched_cholesky(use_kernel=True)``).  For each
(B, n) in SHAPES, with m = 8 right-hand-side columns, and at the
forward-sampling shape FS_SHAPE (the 4000 realizations x 3 outputs of
``params_car_residual_fs`` against a 50-row hallucination block), it prints
the kernels' times beside ``torch.linalg.cholesky`` /
``torch.linalg.solve_triangular`` on the same inputs: the library is the
yardstick here, and the port's kernel path never calls it.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.microbench_linalg [--n-iter 30]

Times are medians of warm readings between CUDA events, each of 10
back-to-back launches queued behind a sleep kernel (:func:`cuda_ms`, which
``chip_smoke.py`` times every kernel with).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

SHAPES = ((64, 60), (64, 108), (128, 60), (512, 60))
M = 8
FS_SHAPE = (12000, 50, 1)
# ~100 us at the H100's 1.98 GHz boost clock: the least sleep a call gets
SLEEP_CYCLES_PER_CALL = 200_000
CLOCK_HZ = 1.98e9
SLEEP_MAX_CYCLES = 40_000_000      # ~20 ms a reading


def cuda_ms(fn, n=30, warm=3, k=10) -> float:
    """Median milliseconds of one fn() call on the device (warm): n
    readings, each k back-to-back calls between one pair of CUDA events,
    divided by k.  Each reading is queued behind a sleep kernel long enough
    for the host to enqueue the k calls: twice the median host time of a
    warm-up call, at least SLEEP_CYCLES_PER_CALL a call, so the events time
    the device's work and not the Python wrappers' launch time, wherever
    the host keeps ahead of the device (a plain version's long chain of
    small ops, or one that synchronizes, may not: its reading stays
    host-bound).  Pass k=1 for calls of many ms."""
    host = []
    for _ in range(warm):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    per_call = max(SLEEP_CYCLES_PER_CALL,
                   int(2 * statistics.median(host) * CLOCK_HZ) if host else 0)
    sleep = min(per_call * k, SLEEP_MAX_CYCLES)
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        e0.record()
        for _ in range(k):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / k)
    return statistics.median(times)


def spd_inputs(B: int, n: int, m: int, device, seed: int = 0):
    """SPD batch S = A A' + 3 I (A standard normal) and right-hand sides
    R (B, n, m), float32, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    S = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(n, dtype=np.float32)
    R = rng.standard_normal((B, n, m)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device).contiguous()
    return t(S), t(R)


def shapes():
    """(B, n, m) of every measured shape: the JAX microbench's and fs."""
    return [(B, n, M) for B, n in SHAPES] + [FS_SHAPE]


def measure(B: int, n: int, m: int, device, n_iter: int = 30,
            seed: int = 0, verbose: bool = True) -> dict:
    """Drive the three kernels through their entry points at one shape and
    time each beside its library counterpart.  Returns the inputs, the
    outputs and the times (ms)."""
    from sampling_gpmpc_torch.ops import batch_linalg, batched_chol

    S, R = spd_inputs(B, n, m, device, seed)
    L = batch_linalg.chol(S)
    X = batch_linalg.tri_solve(L, R)
    Xt = batch_linalg.tri_solve(L, R, lower_factor_transposed=True)
    Lb = batched_chol.batched_cholesky(S, use_kernel=True)
    row = dict(
        B=B, n=n, m=m, S=S, R=R, L=L, X=X, Xt=Xt, Lb=Lb,
        chol_ms=cuda_ms(lambda: batch_linalg.chol(S), n_iter),
        chol_lib_ms=cuda_ms(lambda: torch.linalg.cholesky(S), n_iter),
        tri_ms=cuda_ms(lambda: batch_linalg.tri_solve(L, R), n_iter),
        tri_t_ms=cuda_ms(lambda: batch_linalg.tri_solve(
            L, R, lower_factor_transposed=True), n_iter),
        tri_lib_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            L, R, upper=False), n_iter),
        tri_lib_t_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            L.transpose(-1, -2), R, upper=True), n_iter),
        bchol_ms=cuda_ms(lambda: batched_chol.batched_cholesky(
            S, use_kernel=True), n_iter))
    if verbose:
        print(f"B={B:5d} n={n:3d} m={m}  chol: kernel "
              f"{row['chol_ms']:.4f} ms, torch.linalg "
              f"{row['chol_lib_ms']:.4f} ms | tri_solve: kernel "
              f"{row['tri_ms']:.4f} ms (transposed {row['tri_t_ms']:.4f}), "
              f"torch.linalg {row['tri_lib_ms']:.4f} ms (transposed "
              f"{row['tri_lib_t_ms']:.4f}) | batched_cholesky "
              f"kernel {row['bchol_ms']:.4f} ms", flush=True)
    return row


def run(device, n_iter: int = 30, verbose: bool = True) -> list:
    """:func:`measure` at every shape of :func:`shapes`."""
    return [measure(B, n, m, device, n_iter, verbose=verbose)
            for B, n, m in shapes()]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n-iter", type=int, default=30)
    args = parser.parse_args(argv)

    from sampling_gpmpc_torch import setup

    device = setup.resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("microbench_linalg times CUDA kernels: it needs a "
                         "GPU")
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    run(device, args.n_iter)


if __name__ == "__main__":
    main()
