"""Fused empty-hallucination GP sample stage: CUDA kernel + plain version.

Port of ``sampling_gpmpc_tpu/ops/pallas_gp.py`` (``_kernel`` and
``sample_empty_one``).  For one GP output and every sample i it computes,
from the masked cross-covariance rows Kx_i and the test block Ktt_i:

    V = Linv Kx_i',  G = V'V,  mean = Kx_i alpha,  cov = Ktt_i - G + jitter I,
    L = chol(cov),   y = mean + L eps_i,   then the override tail.

Two deliberate differences from the float64 reference path
(``gp/exact.py`` predict_real + sample_with_overrides), shared by the kernel
and its plain version: the triangular solve against the fixed real-data
factor is a matmul with the precomputed ``Linv``, and there is no
escalating-jitter retry (a failed factorization gives NaN, and NaN samples
fall back to the mean).

``sample_empty_one`` runs the plain version for CPU tensors and the CUDA
kernel (``csrc/gp_sample.cu``) for CUDA tensors; it never falls back: a
CUDA stage the kernel cannot take raises (:func:`check_supported`).
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch.ops import build

LAUNCHES = {"gp_sample": 0}


def smem_bytes(Ht: int, R: int) -> int:
    """Dynamic shared memory of one CTA (see csrc/gp_sample.cu layout: Kx_i,
    V, the covariance tile and four row buffers; Linv stays in global
    memory)."""
    return 4 * (Ht * (R + 1) + R * (Ht + 1) + Ht * (Ht + 1) + 4 * Ht)


def check_supported(Ht: int, R: int, dtype) -> None:
    """Raise ValueError naming the limit when the kernel cannot take a
    stage: float32 only, and a tile that fits one CTA's shared memory."""
    if dtype != torch.float32:
        raise ValueError(f"gp_sample kernel takes float32 only, got {dtype}; "
                         "run float64 with device='cpu'")
    smem = smem_bytes(Ht, R)
    if Ht < 1 or R < 1 or smem > build.SMEM_MAX:
        raise ValueError(f"gp_sample: {smem} B of shared memory for Ht={Ht}, "
                         f"R={R}; one CTA takes 1 <= Ht, 1 <= R and at most "
                         f"{build.SMEM_MAX} B")


def chol_right_looking(A: torch.Tensor) -> torch.Tensor:
    """Batched right-looking Cholesky, the kernel's own column sweep:
    l = A[j:, j] / sqrt(A[j, j]), trailing block -= l l'.  A non-positive
    pivot gives NaN from that column on (no retry)."""
    A = A.clone()
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        r = 1.0 / torch.sqrt(A[..., j, j])
        col = A[..., j:, j] * r[..., None]
        L[..., j:, j] = col
        A[..., j + 1:, j + 1:] -= col[..., 1:, None] * col[..., None, 1:]
    return L


def sample_empty_plain(Kxm, Ktt, eps, Linv, alpha, prior_var, jitter: float,
                       beta: float, var_zero: float, rel_floor: float,
                       ty: int = 1, close=None, ynear=None):
    """Plain torch version of the kernel; same arguments and result as
    :func:`sample_empty_one`."""
    Ht = Kxm.shape[1]
    V = Linv @ Kxm.transpose(1, 2)                        # (ns, R, Ht)
    G = V.transpose(1, 2) @ V
    G = torch.tril(G) + torch.tril(G, -1).transpose(1, 2)  # exactly symmetric
    mean = (Kxm @ alpha[:, None])[..., 0]                  # (ns, Ht)
    eye = torch.eye(Ht, dtype=Kxm.dtype, device=Kxm.device)
    S = Ktt - G + jitter * eye
    var = torch.diagonal(S, dim1=-2, dim2=-1) - jitter
    L = chol_right_looking(S)
    y = mean + (L @ eps[..., None])[..., 0]
    return override_tail(mean, y, var, prior_var, beta, var_zero, rel_floor,
                         ty, close, ynear)


def override_tail(mean, y, var, prior_var, beta: float, var_zero: float,
                  rel_floor: float, ty: int = 1, close=None, ynear=None):
    """The GP kernels' override tail on (ns, Ht) rows, in
    ``pallas_gp._override_tail``'s order: relative variance floor, zero
    variance -> mean (Ty>1: all tasks of the point), min-dist -> nearest
    train row, beta clip, non-finite -> mean; min/max propagate NaN."""
    ns, Ht = y.shape
    var = torch.clamp(var, min=0.0)
    if rel_floor > 0.0:
        var = torch.where(var < rel_floor * prior_var, torch.zeros_like(var),
                          var)
    if var_zero >= 0.0:
        z = var <= var_zero
        if ty > 1:
            z = z.reshape(ns, Ht // ty, ty).all(-1, keepdim=True).expand(
                ns, Ht // ty, ty).reshape(ns, Ht)
        y = torch.where(z, mean, y)
    if close is not None:
        y = torch.where(close > 0, ynear, y)
    std = torch.sqrt(var)
    y = torch.minimum(torch.maximum(y, mean - beta * std), mean + beta * std)
    return torch.where(torch.isfinite(y), y, mean)


def sample_empty_one(Kxm, Ktt, eps, Linv, alpha, prior_var, jitter: float,
                     beta: float, var_zero: float, rel_floor: float,
                     ty: int = 1, close=None, ynear=None):
    """Run the fused stage for ONE GP output.

    Args:
        Kxm: (ns, Ht, R) masked cross-covariance blocks.
        Ktt: (ns, Ht, Ht) test-test blocks.
        eps: (ns, Ht) base draws.
        Linv: (R, R) inverse Cholesky factor of the masked train matrix.
        alpha: (R,) K~^-1 y~.
        prior_var: (Ht,) prior variance of each test row's task.
        ty: tasks per test point (for the Ty>1 zero-variance override).
        close/ynear: optional (ns, Ht) min-dist override rows.
    Returns:
        (ns, Ht) sampled rows.
    """
    if Kxm.device.type == "cpu":
        return sample_empty_plain(Kxm, Ktt, eps, Linv, alpha, prior_var,
                                  jitter, beta, var_zero, rel_floor, ty=ty,
                                  close=close, ynear=ynear)
    if Kxm.device.type != "cuda":
        raise ValueError(f"gp_sample: unsupported device {Kxm.device}")
    ns, Ht, R = Kxm.shape
    dev = Kxm.device
    check_supported(Ht, R, Kxm.dtype)
    smem = smem_bytes(Ht, R)
    args = [("Kxm", Kxm, (ns, Ht, R)), ("Ktt", Ktt, (ns, Ht, Ht)),
            ("eps", eps, (ns, Ht)), ("Linv", Linv, (R, R)),
            ("alpha", alpha, (R,)), ("prior_var", prior_var, (Ht,))]
    if close is not None:
        args += [("close", close, (ns, Ht)), ("ynear", ynear, (ns, Ht))]
    for name, t, shape in args:
        build.check_tensor(name, t, shape, dev)
    fn = build.load("gp_sample").gp_sample_empty
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 9 + [I] * 4 + [F] * 4 + [I, P]
    fn.restype = I
    dg = torch.empty((ns, Ht), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = fn(Kxm.data_ptr(), Ktt.data_ptr(), eps.data_ptr(),
                Linv.data_ptr(), alpha.data_ptr(), prior_var.data_ptr(),
                ptr(close), ptr(ynear), dg.data_ptr(), ns, Ht, R, int(ty),
                float(jitter), float(beta), float(var_zero), float(rel_floor),
                smem, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gp_sample_empty launch")
    LAUNCHES["gp_sample"] += 1
    return dg
