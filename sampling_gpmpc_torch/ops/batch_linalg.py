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

The Cholesky (``csrc/batch_linalg.cu``, and ``ops/batched_chol.py``'s) is
the right-looking blocked factor of ``gp_hall`` in 32-column panels;
:func:`blocked_chol` carries it in plain torch, its ``panel=1`` the column
sweep of the earlier design.  The triangular solve is a blocked
substitution in 32-row panels over the same tiles, which
:func:`tri_solve_plain` carries with a ``panel`` argument (1: the column
sweep; every width gives the same result bit for bit).
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch.gp.exact import cholesky_nan, solve_tri_shared
from sampling_gpmpc_torch import obs
from sampling_gpmpc_torch.ops import build
from sampling_gpmpc_torch.ops.gp_sample import PANEL, TILE_FLOATS, factor_panels

# the kernels pay off only for mid-size matrices (the JAX package's window:
# below 16 the library loop is already cheap)
MIN_N, MAX_N = 16, 180
LAUNCHES = {"chol": 0, "tri_solve": 0}


def chol_smem_bytes(n: int) -> int:
    """Dynamic shared memory of one Cholesky CTA: the lower triangle as
    32x32 tiles at row stride 33, n padded to whole tiles (csrc/common.cuh
    ``Tiles``)."""
    t = -(-n // PANEL)
    return 4 * (t * (t + 1) // 2 * TILE_FLOATS)


def tri_smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one solve CTA: the factor's lower triangle
    as 32x32 tiles (as :func:`chol_smem_bytes`), the right-hand side padded
    to whole tiles (rows) x m, and a flag per column."""
    t = -(-n // PANEL)
    return 4 * (t * (t + 1) // 2 * TILE_FLOATS + t * PANEL * m + m)


def tri_launch_shape(n: int, m: int):
    """(threads, warp_diag) of one solve CTA, as measured fastest on an
    H100 among 32-512 threads: up to n = 64, 32 threads for a single
    right-hand side (16 CTAs share an SM) and 128 for more; 256 above.
    The diagonal tile is solved one warp per column while the columns are
    no more than the warps, one thread per column otherwise."""
    nt = (32 if m == 1 else 128) if n <= 64 else 256
    return nt, m <= nt // 32


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


def blocked_chol(A: torch.Tensor, panel: int = PANEL) -> torch.Tensor:
    """The Cholesky kernels' factor in plain torch: the lower triangle of A
    (..., n, n), mirrored, factored right-looking in panels of ``panel``
    columns (``gp_sample.factor_panels``: per panel the diagonal block's
    column sweep, the rows below solved against it, the trailing block
    updated); ``panel=1`` is the column sweep.  Returns the lower factor,
    upper triangle zero; a non-positive pivot leaves a non-finite diagonal
    from its column on."""
    n = A.shape[-1]
    A = torch.tril(A) + torch.tril(A, -1).transpose(-1, -2)
    return torch.tril(factor_panels(A, 0, n, n, panel))


def first_failed_pivot(L: torch.Tensor) -> torch.Tensor:
    """Per matrix of L (..., n, n), the first column whose diagonal entry is
    not finite, n if none, shaped (..., 1, 1) to broadcast."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    bad = ~torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1))
    return torch.where(bad, idx, n).amin(-1)[..., None, None]


def chol_plain(A: torch.Tensor, panel: int = PANEL) -> torch.Tensor:
    """The kernel's algorithm in plain torch: :func:`blocked_chol` of the
    lower triangle of A (..., n, n), upper triangle zero.  A failed pivot at
    column j0 gives the TPU kernel's NaN pattern, written from j0: NaN from
    that column on and, as its masked update's NaN * 0 does, in the earlier
    columns of the rows below j0."""
    L = blocked_chol(A, panel)
    j0 = first_failed_pivot(L)
    i = torch.arange(A.shape[-1], device=A.device)
    a, c = i[:, None], i[None, :]
    nan = (c <= a) & ((a > j0) | ((a == j0) & (c == a)))
    return L.masked_fill(nan, float("nan"))


def tri_solve_plain(L: torch.Tensor, R: torch.Tensor,
                    lower_factor_transposed: bool = False,
                    panel: int = PANEL) -> torch.Tensor:
    """The kernel's algorithm in plain torch: blocked substitution on L
    (..., n, n) and R (..., n, m) in panels of ``panel`` rows, forward for
    L X = R, backward for L' X = R (L' read as the rows of L; only the
    lower triangle is read).  Per panel, the diagonal block's column sweep,
    then the rows past the panel updated, one column of the panel at a
    time in the sweep's order, so every element takes the same updates
    x - f x_j (x_j = x / L_jj) in the same order at every width; ``panel=1``
    is the column sweep of the earlier design.  A column with a
    non-finite solved entry is NaN in every row, as the TPU kernel's masked
    update (coefficient 0 times NaN) leaves it."""
    n = L.shape[-1]
    lower = not lower_factor_transposed
    L = torch.tril(L)
    if not lower:
        L = L.transpose(-1, -2)
    X = R.clone()
    starts = range(0, n, panel)
    for a in (starts if lower else reversed(starts)):
        # the panel's rows [a, b) in the sweep's order (descending for L'),
        # the rows past it [c, d)
        b = min(a + panel, n)
        c, d = (b, n) if lower else (0, a)
        cols = range(a, b) if lower else range(b - 1, a - 1, -1)
        for j in cols:
            X[..., j, :] = X[..., j, :] / L[..., j, j][..., None]
            rest = slice(j + 1, b) if lower else slice(a, j)
            X[..., rest, :] = X[..., rest, :] - (L[..., rest, j, None]
                                                 * X[..., j, None, :])
        for j in cols:
            X[..., c:d, :] = X[..., c:d, :] - (L[..., c:d, j, None]
                                               * X[..., j, None, :])
    bad = ~torch.isfinite(X).all(dim=-2, keepdim=True)
    return X.masked_fill(bad, float("nan"))


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
    obs.count(LAUNCHES, "chol")
    return out


def _tri_launch(L3, R3, lower: bool) -> torch.Tensor:
    B, n, m = R3.shape
    out = torch.empty_like(R3)
    if B == 0 or m == 0:
        return out
    build.check_tensor("L", L3, (B, n, n), R3.device)
    build.check_tensor("R", R3, (B, n, m), R3.device)
    fn = build.load("batch_linalg").batch_tri_solve
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, I, I, I, P]
    fn.restype = I
    nt, warp_diag = tri_launch_shape(n, m)
    with torch.cuda.device(R3.device):
        rc = fn(L3.data_ptr(), R3.data_ptr(), out.data_ptr(), B, n, m,
                int(lower), nt, int(warp_diag), tri_smem_bytes(n, m),
                torch.cuda.current_stream(R3.device).cuda_stream)
    build.check(rc, "batch_tri_solve launch")
    obs.count(LAUNCHES, "tri_solve")
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
