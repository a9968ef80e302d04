"""Batched small-matrix Cholesky and triangular solve: CUDA kernels + plain
versions.

Port of ``sampling_gpmpc_tpu/ops/batch_linalg.py`` (``_chol_kernel``,
``_tri_kernel``).  The JAX package reaches its kernels through
``custom_vmap``: under ``vmap`` the mapped axes fold into one lane-batched
launch.  Here the batch dimensions are written out:

* ``chol(A)`` for A (..., n, n): lower factor, upper triangle zero;
* ``tri_solve(L, R, lower_factor_transposed=False)``: L X = R (or L' X =
  R) for L (..., n, n) and R (..., n, m), or R (..., n) when
  ``R.ndim == L.ndim - 1``.

Routing keeps the JAX package's shape rule, decided from shapes before any
launch: a batch (a leading dimension on the factor) with MIN_N <= n <=
MAX_N whose tile fits one CTA's shared memory takes the kernel on a CUDA
float32 tensor (another dtype raises) and the kernel's plain version on a
CPU tensor; outside that window, and for an unbatched (shared) factor,
the function computes with ``torch.linalg``, as the JAX package routes to
XLA.  The kernels and their plain versions read the lower triangle only.
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch.gp.exact import cholesky_nan, solve_tri_shared
from sampling_gpmpc_torch.ops import build

# the kernels pay off only for mid-size matrices (the JAX package's window:
# below 16 the library loop is already cheap)
MIN_N, MAX_N = 16, 180
LAUNCHES = {"chol": 0, "tri_solve": 0}


def chol_smem_bytes(n: int) -> int:
    """Dynamic shared memory of one Cholesky CTA (the lower triangle at
    row stride n + 1 and two column buffers)."""
    return 4 * (n * (n + 1) + 2 * n)


def tri_smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one solve CTA (the factor at row stride
    n + 1 and the n x m right-hand side)."""
    return 4 * (n * (n + 1) + n * m)


def use_kernel(n: int, m: int = None) -> bool:
    """The shape rule: the kernel (or its plain version) takes a batched
    n x n factor, MIN_N <= n <= MAX_N, whose tile fits one CTA."""
    smem = chol_smem_bytes(n) if m is None else tri_smem_bytes(n, m)
    return MIN_N <= n <= MAX_N and smem <= build.SMEM_MAX


def _check_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 only, got "
                         f"{t.dtype}; run float64 with device='cpu'")


def chol_plain(A: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in plain torch: right-looking column
    elimination, l = A[:, j] rsqrt(A[j, j]), trailing update A -= l l' with
    the TPU kernel's masks.  A failed pivot at column j0 gives NaN from that
    column on and, through the masked update's NaN * 0, in the earlier
    columns of the rows below j0.  Reads the lower triangle of A (..., n,
    n); the upper triangle of the factor is zero."""
    n = A.shape[-1]
    A = torch.tril(A)
    idx = torch.arange(n, device=A.device)
    for j in range(n):
        r = torch.rsqrt(A[..., j, j])[..., None]
        col = A[..., :, j] * r
        f = torch.where(idx > j, col, torch.zeros_like(col))
        A = A - f[..., :, None] * f[..., None, :]
        A[..., :, j] = torch.where(idx >= j, col, torch.zeros_like(col))
    return torch.tril(A)


def tri_solve_plain(L: torch.Tensor, R: torch.Tensor,
                    lower_factor_transposed: bool = False) -> torch.Tensor:
    """The kernel's algorithm in plain torch: column-oriented substitution
    on L (..., n, n) and R (..., n, m), forward for L X = R, backward for
    L' X = R (L' read as the rows of L).  Every row takes the masked update
    (coefficient 0 outside the mask), as in the TPU kernel."""
    n = L.shape[-1]
    lower = not lower_factor_transposed
    X = R.clone()
    idx = torch.arange(n, device=L.device)
    for s in range(n):
        j = s if lower else n - 1 - s
        xj = X[..., j, :] / L[..., j, j][..., None]
        col = L[..., :, j] if lower else L[..., j, :]
        f = torch.where(idx > j if lower else idx < j, col,
                        torch.zeros_like(col))
        X = X - f[..., :, None] * xj[..., None, :]
        X[..., j, :] = xj
    return X


def _chol_launch(A3: torch.Tensor) -> torch.Tensor:
    B, n, _ = A3.shape
    out = torch.empty_like(A3)
    if B == 0:
        return out
    build.check_tensor("A", A3, (B, n, n), A3.device)
    fn = build.load("batch_linalg").batch_chol
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, I, I, P]
    fn.restype = I
    with torch.cuda.device(A3.device):
        rc = fn(A3.data_ptr(), out.data_ptr(), B, n, chol_smem_bytes(n),
                torch.cuda.current_stream(A3.device).cuda_stream)
    build.check(rc, "batch_chol launch")
    LAUNCHES["chol"] += 1
    return out


def _tri_launch(L3, R3, lower: bool) -> torch.Tensor:
    B, n, m = R3.shape
    out = torch.empty_like(R3)
    if B == 0:
        return out
    build.check_tensor("L", L3, (B, n, n), R3.device)
    build.check_tensor("R", R3, (B, n, m), R3.device)
    fn = build.load("batch_linalg").batch_tri_solve
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, I, P]
    fn.restype = I
    with torch.cuda.device(R3.device):
        rc = fn(L3.data_ptr(), R3.data_ptr(), out.data_ptr(), B, n, m,
                int(lower), tri_smem_bytes(n, m),
                torch.cuda.current_stream(R3.device).cuda_stream)
    build.check(rc, "batch_tri_solve launch")
    LAUNCHES["tri_solve"] += 1
    return out


def chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A (..., n, n); a matrix that is not
    positive definite gives NaN (see ``chol_plain`` for the kernel's
    pattern; ``torch.linalg`` routes give an all-NaN factor, as XLA)."""
    n = A.shape[-1]
    if A.ndim < 3 or not use_kernel(n):
        return cholesky_nan(A)
    if A.device.type == "cpu":
        return chol_plain(A)
    _check_cuda("chol", A)
    A3 = A.reshape((-1, n, n)).contiguous()
    return _chol_launch(A3).reshape(A.shape)


def tri_solve(L: torch.Tensor, R: torch.Tensor, *,
              lower_factor_transposed: bool = False) -> torch.Tensor:
    """Solve L X = R (or L' X = R) for lower factors L (..., n, n).

    ``R`` is (..., n, m), or (..., n) when ``R.ndim == L.ndim - 1``; batch
    dimensions broadcast.  An unbatched L is one shared factor: its solve
    runs in ``torch.linalg`` with the batch folded into the columns.
    """
    vec = R.ndim == L.ndim - 1
    if vec:
        R = R[..., None]
    n, m = L.shape[-1], R.shape[-1]
    if L.ndim == 2:
        X = solve_tri_shared(L, R, upper=lower_factor_transposed)
    elif not use_kernel(n, m):
        Lt = L.transpose(-1, -2) if lower_factor_transposed else L
        X = torch.linalg.solve_triangular(Lt, R,
                                          upper=lower_factor_transposed)
    else:
        batch = torch.broadcast_shapes(L.shape[:-2], R.shape[:-2])
        L3 = L.expand(batch + (n, n)).reshape((-1, n, n))
        R3 = R.expand(batch + (n, m)).reshape((-1, n, m))
        if L.device.type == "cpu":
            X = tri_solve_plain(L3, R3, lower_factor_transposed)
        else:
            _check_cuda("tri_solve", R)
            _check_cuda("tri_solve", L)
            X = _tri_launch(L3.contiguous(), R3.contiguous(),
                            not lower_factor_transposed)
        X = X.reshape(batch + (n, m))
    return X[..., 0] if vec else X
