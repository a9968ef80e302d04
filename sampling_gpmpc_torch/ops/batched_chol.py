"""Masked batched Cholesky with jitter: CUDA kernel + plain version.

Port of ``sampling_gpmpc_tpu/ops/pallas_chol.py`` (``_chol_kernel``,
``batched_cholesky``).  ``batched_cholesky(A, jitter, use_kernel)`` factors
A + jitter I for A (..., n, n).  As in the JAX package the default computes
with the library (``torch.linalg``, as JAX uses XLA); ``use_kernel=True``
takes the kernel on a CUDA float32 tensor (``csrc/batched_chol.cu``; any
other CUDA tensor raises) and the kernel's plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch.gp.exact import cholesky_nan
from sampling_gpmpc_torch.ops import build
from sampling_gpmpc_torch.ops.batch_linalg import chol_smem_bytes as smem_bytes

LAUNCHES = {"batched_chol": 0}


def check_supported(n: int, dtype) -> None:
    """Raise ValueError naming the limit when the kernel cannot take n."""
    if dtype != torch.float32:
        raise ValueError(f"batched_chol kernel takes float32 only, got "
                         f"{dtype}; run float64 with device='cpu'")
    if n < 1 or smem_bytes(n) > build.SMEM_MAX:
        raise ValueError(f"batched_chol: {smem_bytes(n)} B of shared memory "
                         f"for n={n}; one CTA takes at most {build.SMEM_MAX}")


def batched_cholesky_plain(A: torch.Tensor, jitter: float = 0.0
                           ) -> torch.Tensor:
    """The TPU kernel's algorithm in plain torch: per column j, pivot
    rsqrt(A[j, j]), column l = A[:, j] * pivot masked to rows >= j, the
    trailing update A -= l' l'' with l' masked to rows > j, and the factor
    accumulated as L += l e_j'.  A failed pivot at column j0 turns the rows
    from j0 down NaN in every column (NaN * 0 in the outer products)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    A = A + jitter * eye
    L = torch.zeros_like(A)
    idx = torch.arange(n, device=A.device)
    for j in range(n):
        colv = A[..., :, j] * torch.rsqrt(A[..., j, j])[..., None]
        zero = torch.zeros_like(colv)
        lcol = torch.where(idx >= j, colv, zero)
        lstrict = torch.where(idx > j, colv, zero)
        A = A - lstrict[..., :, None] * lstrict[..., None, :]
        L = L + lcol[..., :, None] * eye[j]
    return L


def batched_cholesky(A: torch.Tensor, jitter: float = 0.0,
                     use_kernel: bool = False) -> torch.Tensor:
    """Cholesky of a batch of SPD matrices: (..., n, n) -> lower (..., n,
    n) of A + jitter I."""
    n = A.shape[-1]
    if not use_kernel:
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        return cholesky_nan(A + jitter * eye)
    if A.device.type == "cpu":
        return batched_cholesky_plain(A, jitter)
    if A.device.type != "cuda":
        raise ValueError(f"batched_chol: unsupported device {A.device}")
    check_supported(n, A.dtype)
    A3 = A.reshape((-1, n, n)).contiguous()
    B = A3.shape[0]
    out = torch.empty_like(A3)
    if B == 0:
        return out.reshape(A.shape)
    build.check_tensor("A", A3, (B, n, n), A.device)
    fn = build.load("batched_chol").batched_chol
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, I, I, F, I, P]
    fn.restype = I
    with torch.cuda.device(A.device):
        rc = fn(A3.data_ptr(), out.data_ptr(), B, n, float(jitter),
                smem_bytes(n), torch.cuda.current_stream(A.device).cuda_stream)
    build.check(rc, "batched_chol launch")
    LAUNCHES["batched_chol"] += 1
    return out.reshape(A.shape)
