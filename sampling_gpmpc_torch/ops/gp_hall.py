"""Fused hall-block GP sample stage: CUDA kernels + plain version.

Port of ``sampling_gpmpc_tpu/ops/pallas_gp.py`` (``_hall_kernel`` and
``sample_hall_one``), the GP stage of SQP iterations >= 1, where each sample
is conditioned on the real data and on its own hallucinated rows.  For one
GP output and every sample i, from the masked kernel blocks (Kxr_i, Kxh_i,
Ktt_i, Arh_i, Ahh_i with noise and identity fill, yh_i) and the fixed real
factor (``Linv`` = L_r^-1, ``w_r`` = L_r^-1 y_r):

    C = Linv Arh_i,  V_r = Linv Kxr_i',  S = Ahh_i - C'C + jitter I,
    L_s = chol(S),   [Vh'; w_h] = [Kxh_i - V_r'C; yh_i - w_r C] L_s^-T,
    cov = Ktt_i - V_r'V_r - Vh'Vh + jitter I,  mean = w_r V_r + w_h Vh,
    y = mean + chol(cov) eps_i,  then the override tail.

Only the first ``nh`` (= hall_n * Ty, the fill) hall rows take part: the
rows past the fill are masked empty slots, identity rows of S with zero
couplings, whose factorization and substitution steps are exact no-ops and
whose W columns are exactly zero.  As in ``gp_sample``, the solves against
the fixed real factor are matmuls with ``Linv`` and there is no
escalating-jitter retry (a failed factorization gives NaN, and NaN samples
fall back to the mean); the float64 reference path is
``gp/exact.py`` condition_update + predict_update + sample_with_overrides.

``sample_hall_one`` runs the plain version for CPU tensors and the CUDA
kernels (``csrc/gp_hall.cu``: two batched product launches and one factor
launch) for CUDA tensors; it never falls back: a CUDA stage the kernels
cannot take raises (:func:`check_supported`).
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch.ops import build
from sampling_gpmpc_torch.ops.gp_sample import chol_right_looking, override_tail

LAUNCHES = {"gp_hall": 0}


def factor_smem_bytes(Ht: int, nh: int) -> int:
    """Dynamic shared memory of one factor CTA (csrc/gp_hall.cu layout: S,
    W, the covariance tile and row buffers)."""
    return 4 * (nh * (nh + 1) + (Ht + 1) * (nh + 1) + Ht * (Ht + 1)
                + 2 * Ht + 2 * max(nh, Ht))


def workspace_floats(ns: int, Ht: int, Rr: int, nh: int) -> int:
    """Per-launch global workspace: C, V_r', S, W[:Ht] and Ktt - V_r'V_r."""
    return ns * (Rr * nh + Ht * Rr + nh * nh + Ht * nh + Ht * Ht)


def check_supported(Ht: int, Rr: int, Rh: int, nh: int, dtype) -> None:
    """Raise ValueError naming the limit when the kernels cannot take a
    stage: float32 only, a fill within the capacity, and a factor stage
    that fits one CTA's shared memory."""
    if dtype != torch.float32:
        raise ValueError(f"gp_hall kernel takes float32 only, got {dtype}; "
                         "run float64 with device='cpu'")
    if Ht < 1 or Rr < 1 or not 0 <= nh <= Rh:
        raise ValueError(f"gp_hall: need 1 <= Ht, 1 <= Rr and 0 <= nh <= Rh, "
                         f"got Ht={Ht}, Rr={Rr}, nh={nh}, Rh={Rh}")
    smem = factor_smem_bytes(Ht, nh)
    if smem > build.SMEM_MAX:
        raise ValueError(f"gp_hall: {smem} B of shared memory for Ht={Ht}, "
                         f"nh={nh} filled hall rows; one CTA takes at most "
                         f"{build.SMEM_MAX} B")


def subst_right_looking(W: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """W L^-T for a batch of lower factors L, column by column as the kernel
    sweeps: column j is divided by L[j, j], then subtracted, scaled by
    L[k, j], from every later column k."""
    W = W.clone()
    for j in range(L.shape[-1]):
        W[..., j] = W[..., j] / L[..., j, j][..., None]
        W[..., j + 1:] -= W[..., j:j + 1] * L[..., None, j + 1:, j]
    return W


def sample_hall_plain(nh: int, Kxr, Kxh, Ktt, Arh, Ahh, yh, eps, Linv, w_r,
                      prior_var, jitter: float, beta: float, var_zero: float,
                      rel_floor: float, ty: int = 1, close=None, ynear=None):
    """Plain torch version of the kernels; same arguments and result as
    :func:`sample_hall_one`."""
    nh = int(nh)
    Ht = Kxr.shape[1]
    C = Linv @ Arh[..., :nh]                               # (ns, Rr, nh)
    Vr = Linv @ Kxr.transpose(1, 2)                        # (ns, Rr, Ht)
    Ct, Vrt = C.transpose(1, 2), Vr.transpose(1, 2)
    S = (Ahh[:, :nh, :nh] - Ct @ C
         + jitter * torch.eye(nh, dtype=C.dtype, device=C.device))
    W = torch.cat([Kxh[..., :nh] - Vrt @ C,
                   (yh[:, :nh] - (w_r @ C))[:, None]], dim=1)  # (ns, Ht+1, nh)
    W = subst_right_looking(W, chol_right_looking(S))
    Vh, wh = W[:, :Ht], W[:, Ht]
    cov = (Ktt - Vrt @ Vr - Vh @ Vh.transpose(1, 2)
           + jitter * torch.eye(Ht, dtype=C.dtype, device=C.device))
    mean = (Vrt @ w_r[:, None])[..., 0] + (Vh @ wh[..., None])[..., 0]
    var = torch.diagonal(cov, dim1=-2, dim2=-1) - jitter
    y = mean + (chol_right_looking(cov) @ eps[..., None])[..., 0]
    return override_tail(mean, y, var, prior_var, beta, var_zero, rel_floor,
                         ty, close, ynear)


def sample_hall_one(nh: int, Kxr, Kxh, Ktt, Arh, Ahh, yh, eps, Linv, w_r,
                    prior_var, jitter: float, beta: float, var_zero: float,
                    rel_floor: float, ty: int = 1, close=None, ynear=None):
    """Run the fused hall-block stage for ONE GP output.

    Args:
        nh: filled hall rows (hall_n * Ty); the rows past it are padding.
        Kxr: (ns, Ht, Rr) masked cross-covariance to the real block.
        Kxh: (ns, Ht, Rh) masked cross-covariance to the hall block.
        Ktt: (ns, Ht, Ht) test-test blocks.
        Arh: (ns, Rr, Rh) masked real-hall cross blocks.
        Ahh: (ns, Rh, Rh) masked hall covariance (+noise, identity fill).
        yh: (ns, Rh) masked hall targets.
        eps: (ns, Ht) base draws.
        Linv: (Rr, Rr) inverse Cholesky factor of the real block.
        w_r: (Rr,) L_r^-1 y~_r.
        prior_var: (Ht,) prior variance of each test row's task.
        ty: tasks per test point (for the Ty>1 zero-variance override).
        close/ynear: optional (ns, Ht) min-dist override rows.
    Returns:
        (ns, Ht) sampled rows.
    """
    if Kxr.device.type == "cpu":
        return sample_hall_plain(nh, Kxr, Kxh, Ktt, Arh, Ahh, yh, eps, Linv,
                                 w_r, prior_var, jitter, beta, var_zero,
                                 rel_floor, ty=ty, close=close, ynear=ynear)
    if Kxr.device.type != "cuda":
        raise ValueError(f"gp_hall: unsupported device {Kxr.device}")
    ns, Ht, Rr = Kxr.shape
    Rh = Kxh.shape[-1]
    nh = int(nh)
    dev = Kxr.device
    check_supported(Ht, Rr, Rh, nh, Kxr.dtype)
    args = [("Kxr", Kxr, (ns, Ht, Rr)), ("Kxh", Kxh, (ns, Ht, Rh)),
            ("Ktt", Ktt, (ns, Ht, Ht)), ("Arh", Arh, (ns, Rr, Rh)),
            ("Ahh", Ahh, (ns, Rh, Rh)), ("yh", yh, (ns, Rh)),
            ("eps", eps, (ns, Ht)), ("Linv", Linv, (Rr, Rr)),
            ("w_r", w_r, (Rr,)), ("prior_var", prior_var, (Ht,))]
    if close is not None:
        args += [("close", close, (ns, Ht)), ("ynear", ynear, (ns, Ht))]
    for name, t, shape in args:
        build.check_tensor(name, t, shape, dev)
    fn = build.load("gp_hall").gp_hall_sample
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 14 + [I] * 6 + [F] * 4 + [I, P]
    fn.restype = I
    dg = torch.empty((ns, Ht), dtype=torch.float32, device=dev)
    work = torch.empty((max(workspace_floats(ns, Ht, Rr, nh), 1),),
                       dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = fn(Kxr.data_ptr(), Kxh.data_ptr(), Ktt.data_ptr(),
                Arh.data_ptr(), Ahh.data_ptr(), yh.data_ptr(), eps.data_ptr(),
                Linv.data_ptr(), w_r.data_ptr(), prior_var.data_ptr(),
                ptr(close), ptr(ynear), dg.data_ptr(), work.data_ptr(), ns,
                Ht, Rr, Rh, nh, int(ty), float(jitter), float(beta),
                float(var_zero), float(rel_floor), factor_smem_bytes(Ht, nh),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gp_hall_sample launch")
    LAUNCHES["gp_hall"] += 1
    return dg
