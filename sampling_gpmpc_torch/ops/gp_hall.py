"""Fused hall-block GP sample stage: CUDA kernels + plain version.

Port of ``sampling_gpmpc_tpu/ops/pallas_gp.py`` (``_hall_kernel`` and
``sample_hall_one``), the GP stage of SQP iterations >= 1, where each sample
is conditioned on the real data and on its own hallucinated rows.  For one
GP output and every sample i, from the masked kernel blocks (Kxr_i, Kxh_i,
Ktt_i, Arh_i, Ahh_i with noise and identity fill, yh_i) and the fixed real
factor (``Linv`` = L_r^-1, ``w_r`` = L_r^-1 y_r):

    C = Linv Arh_i,  V_r = Linv Kxr_i',  S = Ahh_i - C'C + jitter I,
    L_s = chol(S),   [Vh'; w_h] = [Kxh_i - V_r'C; yh_i - w_r C] L_s^-T,
    cov = Ktt_i - V_r'V_r - Vh'Vh + J,  mean = w_r V_r + w_h Vh,
    y = mean + chol(cov) eps_i,  then the override tail,

J diagonal, each row's jitter ``gp_sample.row_jitter`` (in float32 at
least ``gp_sample.JITTER_REL`` of the row's prior variance).

All of it is one right-looking blocked Cholesky of the bordered matrix
(:func:`bordered_matrix`) in panels of ``panel`` columns
(:func:`bordered_factor`): its first nh columns give L_s and [Vh'; w_h]
below it, whose trailing update leaves cov and -mean in the last rows; the
next Ht columns, bordering row left out, give chol(cov).  Panel width 1 is
the column sweep of the earlier design (Schur Cholesky, substitution, fold,
covariance Cholesky); the kernel runs width 32.

Only the first ``nh`` (= hall_n * Ty, the fill) hall rows take part: the
rows past the fill are masked empty slots, identity rows of S with zero
couplings, whose elimination steps are exact no-ops.  As in ``gp_sample``,
the solves against the fixed real factor are matmuls with ``Linv``, and a
covariance factor that fails is retried with ten times each row's jitter
(``gp_sample.factor_retried``, from the covariance block as the hall
columns left it); a Schur pivot that fails, or a covariance that fails at
every jitter, gives NaN, and NaN entries fall back to the mean.  The
float64 reference path is ``gp/exact.py`` condition_update +
predict_update + sample_with_overrides.

:func:`sample_hall` takes every GP output at once (inputs stacked on a
leading output axis) and runs the CUDA kernels (``csrc/gp_hall.cu``: two
batched product launches and one factor launch, each over every (output,
sample), the factor's tiles in shared memory or, where they do not fit, in
the global workspace: :func:`factor_tiles_global`) where
``build.kernel_route`` says, else the plain version; :func:`sample_hall_one`
is its one-output case.

:func:`sample_hall_points` is the stage the agent calls: from the points
(real, hall and test), the masks and the hyperparameters, it evaluates the
masked kernel blocks of every (output, sample) in one more launch
(``hall_blocks_kernel``, into the stage's workspace, only the first ``nh``
hall columns), then runs :func:`sample_hall`'s launch set on them, all in
one call.  Its plain version :func:`sample_hall_points_plain` evaluates the
same blocks in torch (:func:`hall_blocks_plain`, each output by
:func:`hall_blocks_one`, which ``agent.hall_stage_inputs`` runs over the
whole capacity) and runs :func:`sample_hall_plain_stacked`;
:func:`hall_blocks` runs the blocks kernel alone.  Each routes as
:func:`sample_hall`, and none falls back: a kernel-route stage the kernels
cannot take raises (:func:`check_supported`, :func:`check_points_supported`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from sampling_gpmpc_torch import obs
from sampling_gpmpc_torch.gp.exact import prior_task_variances
from sampling_gpmpc_torch.gp.kernel import kernel_matrix
from sampling_gpmpc_torch.ops import build
from sampling_gpmpc_torch.ops.gp_sample import (JITTER_REL, PANEL,
                                                TILE_FLOATS, factor_panels,
                                                factor_retried, override_tail,
                                                row_jitter)

# gp_hall: the stage's launch set (either entry); gp_hall_blocks: the
# blocks kernel (sample_hall_points, hall_blocks); gp_hall_global: the launch
# sets whose factor keeps its tiles in the global workspace
# (factor_tiles_global); gp_hall_panels: their panel steps (hall_panels)
LAUNCHES = {"gp_hall": 0, "gp_hall_blocks": 0, "gp_hall_global": 0,
            "gp_hall_panels": 0}
# 32-column tiles a panel step of the global-tile factor eliminates
# (csrc/gp_hall.cu gp_hall_panel_kernel, gp_hall_update_kernel)
GLOBAL_PANEL_TILES = 2
MAX_D = 8           # GP input dimensions of csrc/gp_hall.cu's blocks kernel
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of csrc/gp_hall.cu's C entries
_ARGTYPES = {"gp_hall_sample": [_P] * 14 + [_I] * 7 + [_F] * 5 + [_I, _I, _P],
             "gp_hall_points": [_P] * 15 + [_I] * 8 + [_F] * 5 + [_I, _I, _P],
             "gp_hall_blocks": [_P] * 10 + [_I] * 8 + [_P]}
_FNS: dict = {}
# per-output arguments of sample_hall_one, stacked on a leading axis by
# sample_hall
STACKED = ("Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh", "eps", "Linv", "w_r",
           "prior_var", "close", "ynear")


def factor_tile_floats(Ht: int, nh: int) -> int:
    """Floats of one factor CTA's lower tiles of the bordered matrix, S
    padded to whole tiles (csrc/gp_hall.cu layout)."""
    nhp = -(-nh // PANEL) * PANEL
    tiles = -(-(nhp + Ht + 1) // PANEL)
    return tiles * (tiles + 1) // 2 * TILE_FLOATS


def factor_smem_bytes(Ht: int, nh: int) -> int:
    """Shared memory of one factor CTA holding its tiles: the tiles, then
    the mean, variance and draw rows."""
    return 4 * (factor_tile_floats(Ht, nh) + 3 * Ht)


def factor_tiles_global(Ht: int, nh: int) -> bool:
    """The factor's branch, from the shapes alone: tiles in a global
    workspace region per (output, sample) where they do not fit one CTA's
    shared memory, in shared memory otherwise (every fill of the car)."""
    return factor_smem_bytes(Ht, nh) > build.SMEM_MAX


def hall_panels(Ht: int, nh: int) -> int:
    """Panel steps (two launches each) of the global-tile factor at fill
    nh, from the shapes: the hall columns' tiles in panels of
    ``GLOBAL_PANEL_TILES``; 0 on the shared-memory branch."""
    if not factor_tiles_global(Ht, nh):
        return 0
    tiles = -(-nh // PANEL)
    return -(-tiles // GLOBAL_PANEL_TILES)


def _factor_args(Ht: int, nh: int):
    """(shared-memory bytes, panel tiles) of the factor's launches: the
    tiles and the three rows with panel tiles 0 (shared-memory branch), or
    the three rows alone and ``GLOBAL_PANEL_TILES`` (global-tile branch)."""
    if factor_tiles_global(Ht, nh):
        return 4 * 3 * Ht, GLOBAL_PANEL_TILES
    return factor_smem_bytes(Ht, nh), 0


def _count_stage(Ht: int, nh: int) -> None:
    """One launch set on the counters, with its branch and panel steps."""
    obs.count(LAUNCHES, "gp_hall")
    if factor_tiles_global(Ht, nh):
        obs.count(LAUNCHES, "gp_hall_global", tally=False)
        obs.count(LAUNCHES, "gp_hall_panels", tally=False,
                  n=hall_panels(Ht, nh))


def workspace_floats(nb: int, Ht: int, Rr: int, nh: int) -> int:
    """Global workspace of nb (output, sample) pairs: C, V_r', S, B[:Ht],
    Ktt - V_r'V_r, B's last row and the real-data mean, then the factor's
    tiles on the global-tile branch."""
    tiles = factor_tile_floats(Ht, nh) if factor_tiles_global(Ht, nh) else 0
    return nb * (Rr * nh + Ht * Rr + nh * nh + Ht * nh + Ht * Ht + nh + Ht
                 + tiles)


def check_supported(Ht: int, Rr: int, Rh: int, nh: int, dtype) -> None:
    """Raise ValueError naming the limit when the kernels cannot take a
    stage: float32 only and a fill within the capacity.  Every fill runs:
    tiles that do not fit shared memory go to the global workspace."""
    if dtype != torch.float32:
        raise ValueError(f"gp_hall kernel takes float32 only, got {dtype}; "
                         "run float64 with device='cpu'")
    if Ht < 1 or Rr < 1 or not 0 <= nh <= Rh:
        raise ValueError(f"gp_hall: need 1 <= Ht, 1 <= Rr and 0 <= nh <= Rh, "
                         f"got Ht={Ht}, Rr={Rr}, nh={nh}, Rh={Rh}")


def check_points_supported(N: int, Rr: int, D: int, ty: int, nh: int,
                           Mh: int) -> None:
    """Raise ValueError naming the limit when the blocks kernel cannot take
    a stage: 1 <= D <= MAX_D, ty = 1 (values) or 1 + D (values and
    gradients), Rr = N ty real rows and whole hall points within the
    capacity."""
    if not 1 <= D <= MAX_D or ty not in (1, 1 + D):
        raise ValueError(f"gp_hall blocks: need 1 <= D <= {MAX_D} and ty in "
                         f"(1, 1 + D), got D={D}, ty={ty}")
    if Rr != N * ty or nh % ty or not 0 <= nh <= Mh * ty:
        raise ValueError(f"gp_hall blocks: need Rr = N ty and nh a multiple "
                         f"of ty within Mh ty, got N={N}, Rr={Rr}, nh={nh}, "
                         f"Mh={Mh}, ty={ty}")


def _block_shapes(no: int, ns: int, Ht: int, Rr: int, nh: int) -> dict:
    """The blocks of ``hall_blocks_kernel`` in their order in its buffer
    (csrc/gp_hall.cu gp_hall_blocks), each region one after the other."""
    return dict(Kxr=(no, ns, Ht, Rr), Kxh=(no, ns, Ht, nh),
                Ktt=(no, ns, Ht, Ht), Arh=(no, ns, Rr, nh),
                Ahh=(no, ns, nh, nh), yh=(no, ns, nh), eps=(no, ns, Ht),
                prior_var=(no, Ht))


def blocks_floats(no: int, ns: int, Ht: int, Rr: int, nh: int) -> int:
    """Floats of the blocks in front of the workspace of
    :func:`sample_hall_points`: Kxr, Kxh, Ktt, Arh, Ahh, yh and the eps rows
    of each (output, sample), then prior_var of each output."""
    return sum(math.prod(s) for s in _block_shapes(no, ns, Ht, Rr,
                                                   nh).values())


def block_views(buf, no: int, ns: int, Ht: int, Rr: int, nh: int) -> dict:
    """The blocks in ``buf`` (at least :func:`blocks_floats` floats) as
    views, under :func:`hall_blocks_plain`'s keys and shapes."""
    out, at = {}, 0
    for k, shape in _block_shapes(no, ns, Ht, Rr, nh).items():
        n = math.prod(shape)
        out[k] = buf[at:at + n].view(shape)
        at += n
    return out


def hall_blocks_one(real_Z, m_r, hall_Z, hall_Y, Xt, lengthscale,
                    outputscale, noise_diag, with_grad: bool) -> dict:
    """One output's masked kernel blocks of the hall stage, plain torch (as
    the JAX package leaves them to XLA): Kxr (ns, Ht, Rr), Kxh (ns, Ht, Rh),
    Ktt (ns, Ht, Ht), Arh (ns, Rr, Rh), Ahh (ns, Rh, Rh) with the noise on
    its diagonal, yh (ns, Rh); empty and filtered hall rows get zero
    couplings and an identity diagonal.

    Args:
        real_Z: (N, D); m_r: (Rr,) real mask; hall_Z: (ns, M, D) and
        hall_Y: (ns, M, Ty) the hall points evaluated (NaN: masked), Rh =
        M Ty; Xt: (ns, H, D); lengthscale (D,), outputscale, noise_diag
        (Ty,) of the output.
    """
    ns, M, Ty = hall_Y.shape
    Rr, Rh = m_r.shape[-1], M * Ty
    yh_flat = hall_Y.reshape(ns, Rh)
    m_h = (~torch.isnan(yh_flat)).to(Xt.dtype)
    Zr = real_Z.expand((ns,) + real_Z.shape)
    ev1 = kernel_matrix(torch.cat([Zr, hall_Z], dim=1), hall_Z, lengthscale,
                        outputscale, with_grad)
    Arh = ev1[:, :Rr] * m_r[None, :, None] * m_h[:, None, :]
    Khh = ev1[:, Rr:] + torch.diag(noise_diag.repeat(M))
    Ahh = (m_h[:, :, None] * Khh * m_h[:, None, :]
           + torch.diag_embed(1.0 - m_h))
    ev2 = kernel_matrix(Xt, torch.cat([Zr, hall_Z, Xt], dim=1), lengthscale,
                        outputscale, with_grad)
    return dict(
        Kxr=(ev2[..., :Rr] * m_r).contiguous(),
        Kxh=(ev2[..., Rr:Rr + Rh] * m_h[:, None, :]).contiguous(),
        Ktt=ev2[..., Rr + Rh:].contiguous(),
        Arh=Arh.contiguous(), Ahh=Ahh.contiguous(),
        yh=(torch.nan_to_num(yh_flat) * m_h).contiguous())


def hall_blocks_plain(nh: int, real_Z, m_r, hall_Z, hall_Y, Xt, eps,
                      lengthscale, outputscale, noise_diag, ty: int) -> dict:
    """Plain version of ``hall_blocks_kernel``: the blocks it writes, each
    output's :func:`hall_blocks_one` over the first nh / ty hall points
    stacked on a leading output axis (Kxr (no, ns, Ht, Rr), Kxh (no, ns,
    Ht, nh), Ktt, Arh (no, ns, Rr, nh), Ahh (no, ns, nh, nh), yh (no, ns,
    nh)), the eps rows (no, ns, Ht) and prior_var (no, Ht).  Arguments as
    :func:`sample_hall_points`'."""
    hn = int(nh) // ty
    no = m_r.shape[0]
    ns, H = Xt.shape[:2]
    per = [hall_blocks_one(real_Z, m_r[j], hall_Z[:, j, :hn],
                           hall_Y[:, j, :hn], Xt, lengthscale[j],
                           outputscale[j], noise_diag, ty > 1)
           for j in range(no)]
    out = {k: torch.stack([b[k] for b in per]) for k in per[0]}
    out["eps"] = eps.transpose(0, 1).reshape(no, ns, H * ty)
    out["prior_var"] = prior_task_variances(lengthscale, outputscale,
                                            ty).repeat(1, H)
    return out


def bordered_matrix(nh: int, Kxr, Kxh, Ktt, Arh, Ahh, yh, Linv, w_r,
                    prior_var, jitter: float):
    """The bordered matrix [[S, B'], [B, K]] of every sample, (ns, n, n)
    with n = nh + Ht + 1: S = Ahh - C'C + jitter I (nh x nh), B = [Kxh -
    V_r'C; yh - w_r C], K = [[Ktt - V_r'V_r + J, -V_r'w_r], [-w_r'V_r,
    0]], J = diag(row_jitter(jitter, prior_var))."""
    nh = int(nh)
    ns, Ht = Kxr.shape[:2]
    dt, dev = Kxr.dtype, Kxr.device
    C = Linv @ Arh[..., :nh]                               # (ns, Rr, nh)
    Vr = Linv @ Kxr.transpose(1, 2)                        # (ns, Rr, Ht)
    Ct, Vrt = C.transpose(1, 2), Vr.transpose(1, 2)
    S = Ahh[:, :nh, :nh] - Ct @ C + jitter * torch.eye(nh, dtype=dt,
                                                       device=dev)
    B = torch.cat([Kxh[..., :nh] - Vrt @ C,
                   (yh[:, :nh] - (w_r @ C))[:, None]], dim=1)  # (ns, Ht+1, nh)
    K = torch.zeros((ns, Ht + 1, Ht + 1), dtype=dt, device=dev)
    K[:, :Ht, :Ht] = Ktt - Vrt @ Vr + torch.diag(row_jitter(jitter,
                                                            prior_var))
    mean_r = (Vrt @ w_r[:, None])[..., 0]
    K[:, :Ht, Ht] = -mean_r
    K[:, Ht, :Ht] = -mean_r
    return torch.cat([torch.cat([S, B.transpose(1, 2)], dim=2),
                      torch.cat([B, K], dim=2)], dim=1)


def bordered_factor(nh: int, Kxr, Kxh, Ktt, Arh, Ahh, yh, Linv, w_r,
                    prior_var, jitter: float, panel: int = PANEL):
    """The covariance factor L, the mean and the variance (diag(cov) - J)
    of every sample, from one blocked Cholesky of the bordered matrix: its
    first nh columns with the bordering row, then the next Ht without it,
    retried with more jitter where they fail."""
    nh = int(nh)
    Ht = Kxr.shape[1]
    n2 = nh + Ht
    M = bordered_matrix(nh, Kxr, Kxh, Ktt, Arh, Ahh, yh, Linv, w_r,
                        prior_var, jitter)
    factor_panels(M, 0, nh, n2 + 1, panel)
    mean = -M[:, n2, nh:n2].clone()
    jit0 = row_jitter(jitter, prior_var)
    var = torch.diagonal(M[:, nh:n2, nh:n2], dim1=-2, dim2=-1) - jit0
    factor_retried(M, nh, n2, M[:, nh:n2, nh:n2].clone(), True, var, jit0,
                   panel)
    return torch.tril(M[:, nh:n2, nh:n2]), mean, var


def sample_hall_plain(nh: int, Kxr, Kxh, Ktt, Arh, Ahh, yh, eps, Linv, w_r,
                      prior_var, jitter: float, beta: float, var_zero: float,
                      rel_floor: float, ty: int = 1, close=None, ynear=None,
                      panel: int = PANEL):
    """Plain torch version of the kernels for ONE output; same arguments
    and result as :func:`sample_hall_one`, ``panel`` the blocked
    factorization's panel width (1: the column sweep)."""
    L, mean, var = bordered_factor(nh, Kxr, Kxh, Ktt, Arh, Ahh, yh, Linv,
                                   w_r, prior_var, jitter, panel)
    y = mean + (L @ eps[..., None])[..., 0]
    return override_tail(mean, y, var, prior_var, beta, var_zero, rel_floor,
                         ty, close, ynear)


def sample_hall_plain_stacked(nh: int, jitter: float, beta: float,
                              var_zero: float, rel_floor: float, ty: int = 1,
                              **stacked):
    """Plain version of :func:`sample_hall`: one :func:`sample_hall_plain`
    per output."""
    no = stacked["Kxr"].shape[0]
    return torch.stack([sample_hall_plain(
        nh, jitter=jitter, beta=beta, var_zero=var_zero, rel_floor=rel_floor,
        ty=ty, **{k: None if v is None else v[o] for k, v in stacked.items()})
        for o in range(no)])


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
    if not build.kernel_route("gp", Kxr.device):
        return sample_hall_plain(nh, Kxr, Kxh, Ktt, Arh, Ahh, yh, eps, Linv,
                                 w_r, prior_var, jitter, beta, var_zero,
                                 rel_floor, ty=ty, close=close, ynear=ynear)
    one = lambda t: None if t is None else t[None]
    return sample_hall(nh, one(Kxr), one(Kxh), one(Ktt), one(Arh), one(Ahh),
                       one(yh), one(eps), one(Linv), one(w_r),
                       one(prior_var), jitter, beta, var_zero, rel_floor,
                       ty=ty, close=one(close), ynear=one(ynear))[0]


def sample_hall(nh: int, Kxr, Kxh, Ktt, Arh, Ahh, yh, eps, Linv, w_r,
                prior_var, jitter: float, beta: float, var_zero: float,
                rel_floor: float, ty: int = 1, close=None, ynear=None):
    """Run the fused hall-block stage for every GP output in one launch set.

    The arguments are :func:`sample_hall_one`'s, each per-output tensor
    stacked on a leading axis of ``no`` outputs: Kxr (no, ns, Ht, Rr), Kxh
    (no, ns, Ht, Rh), Ktt (no, ns, Ht, Ht), Arh (no, ns, Rr, Rh), Ahh (no,
    ns, Rh, Rh), yh (no, ns, Rh), eps (no, ns, Ht), Linv (no, Rr, Rr), w_r
    (no, Rr), prior_var (no, Ht), close/ynear (no, ns, Ht) or None; the
    scalars are shared.  Returns (no, ns, Ht) sampled rows.
    """
    if not build.kernel_route("gp", Kxr.device):
        return sample_hall_plain_stacked(
            nh, jitter, beta, var_zero, rel_floor, ty, Kxr=Kxr, Kxh=Kxh,
            Ktt=Ktt, Arh=Arh, Ahh=Ahh, yh=yh, eps=eps, Linv=Linv, w_r=w_r,
            prior_var=prior_var, close=close, ynear=ynear)
    if Kxr.device.type != "cuda":
        raise ValueError(f"gp_hall: unsupported device {Kxr.device}")
    no, ns, Ht, Rr = Kxr.shape
    Rh = Kxh.shape[-1]
    nh = int(nh)
    dev = Kxr.device
    check_supported(Ht, Rr, Rh, nh, Kxr.dtype)
    args = [("Kxr", Kxr, (no, ns, Ht, Rr)), ("Kxh", Kxh, (no, ns, Ht, Rh)),
            ("Ktt", Ktt, (no, ns, Ht, Ht)), ("Arh", Arh, (no, ns, Rr, Rh)),
            ("Ahh", Ahh, (no, ns, Rh, Rh)), ("yh", yh, (no, ns, Rh)),
            ("eps", eps, (no, ns, Ht)), ("Linv", Linv, (no, Rr, Rr)),
            ("w_r", w_r, (no, Rr)), ("prior_var", prior_var, (no, Ht))]
    if close is not None:
        args += [("close", close, (no, ns, Ht)), ("ynear", ynear, (no, ns, Ht))]
    for name, t, shape in args:
        build.check_tensor(name, t, shape, dev)
    fn = _fn("gp_hall_sample")
    dg = torch.empty((no, ns, Ht), dtype=torch.float32, device=dev)
    work = torch.empty((max(workspace_floats(no * ns, Ht, Rr, nh), 1),),
                       dtype=torch.float32, device=dev)
    smem, panel_tiles = _factor_args(Ht, nh)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = fn(Kxr.data_ptr(), Kxh.data_ptr(), Ktt.data_ptr(),
                Arh.data_ptr(), Ahh.data_ptr(), yh.data_ptr(), eps.data_ptr(),
                Linv.data_ptr(), w_r.data_ptr(), prior_var.data_ptr(),
                ptr(close), ptr(ynear), dg.data_ptr(), work.data_ptr(), no,
                ns, Ht, Rr, Rh, nh, int(ty), float(jitter), JITTER_REL,
                float(beta),
                float(var_zero), float(rel_floor), smem, panel_tiles,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gp_hall_sample launch")
    _count_stage(Ht, nh)
    return dg


def sample_hall_points_plain(nh: int, real_Z, m_r, hall_Z, hall_Y, Xt, eps,
                             lengthscale, outputscale, noise_diag, Linv, w_r,
                             jitter: float, beta: float, var_zero: float,
                             rel_floor: float, ty: int = 1, close=None,
                             ynear=None):
    """Plain version of :func:`sample_hall_points`: the blocks by
    :func:`hall_blocks_plain`, then :func:`sample_hall_plain_stacked`."""
    blocks = hall_blocks_plain(nh, real_Z, m_r, hall_Z, hall_Y, Xt, eps,
                               lengthscale, outputscale, noise_diag, ty)
    return sample_hall_plain_stacked(
        nh=nh, jitter=jitter, beta=beta, var_zero=var_zero,
        rel_floor=rel_floor, ty=ty, **blocks, Linv=Linv, w_r=w_r,
        close=close, ynear=ynear)


def _fn(name: str):
    """A C entry of the ``gp_hall`` library, loaded and typed once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("gp_hall"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def sample_hall_points(nh: int, real_Z, m_r, hall_Z, hall_Y, Xt, eps,
                       lengthscale, outputscale, noise_diag, Linv, w_r,
                       jitter: float, beta: float, var_zero: float,
                       rel_floor: float, ty: int = 1, close=None, ynear=None):
    """Run the hall-block stage of every GP output from the points: the
    blocks kernel, then :func:`sample_hall`'s launch set, in one call.

    Args:
        nh: filled hall rows (hall_n * ty); only they are evaluated.
        real_Z: (N, D) real inputs; m_r: (no, Rr) real masks, Rr = N ty.
        hall_Z: (ns, no, Mh, D), hall_Y: (ns, no, Mh, ty) the hall buffers
            (NaN: an empty or filtered row).
        Xt: (ns, H, D) test points; eps: (ns, no, H, ty) base draws.
        lengthscale: (no, D); outputscale: (no,); noise_diag: (ty,).
        Linv: (no, Rr, Rr); w_r: (no, Rr): the real factor.
        ty: tasks per point, 1 (values, ``rbf``) or 1 + D (``rbf_grad``).
        close/ynear: optional (no, ns, Ht) min-dist override rows.
    Returns:
        (no, ns, Ht) sampled rows, Ht = H ty.
    """
    if not build.kernel_route("gp", Xt.device):
        return sample_hall_points_plain(
            nh, real_Z, m_r, hall_Z, hall_Y, Xt, eps, lengthscale,
            outputscale, noise_diag, Linv, w_r, jitter, beta, var_zero,
            rel_floor, ty=ty, close=close, ynear=ynear)
    dims, ptrs = _checked_points(nh, real_Z, m_r, hall_Z, hall_Y, Xt, eps,
                                 lengthscale, outputscale, noise_diag, ty)
    no, ns, N, Mh, H, D, ty, hn = dims
    nh, Rr, Ht, dev = hn * ty, N * ty, H * ty, Xt.device
    args = [("Linv", Linv, (no, Rr, Rr)), ("w_r", w_r, (no, Rr))]
    if close is not None:
        args += [("close", close, (no, ns, Ht)),
                 ("ynear", ynear, (no, ns, Ht))]
    for name, t, shape in args:
        build.check_tensor(name, t, shape, dev)
    fn = _fn("gp_hall_points")
    dg = torch.empty((no, ns, Ht), dtype=torch.float32, device=dev)
    work = torch.empty((blocks_floats(no, ns, Ht, Rr, nh)
                        + workspace_floats(no * ns, Ht, Rr, nh),),
                       dtype=torch.float32, device=dev)
    smem, panel_tiles = _factor_args(Ht, nh)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = fn(*ptrs, Linv.data_ptr(), w_r.data_ptr(), ptr(close), ptr(ynear),
                dg.data_ptr(), work.data_ptr(), *dims, float(jitter),
                JITTER_REL, float(beta), float(var_zero), float(rel_floor), smem,
                panel_tiles, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gp_hall_points launch")
    obs.count(LAUNCHES, "gp_hall_blocks")
    _count_stage(Ht, nh)
    return dg


def hall_blocks(nh: int, real_Z, m_r, hall_Z, hall_Y, Xt, eps, lengthscale,
                outputscale, noise_diag, ty: int = 1) -> dict:
    """``hall_blocks_kernel`` alone: the blocks :func:`sample_hall_points`
    evaluates, as views of one buffer under :func:`hall_blocks_plain`'s
    keys and shapes (off the kernel route, the plain version).  Arguments as
    :func:`sample_hall_points`'."""
    if not build.kernel_route("gp", Xt.device):
        return hall_blocks_plain(nh, real_Z, m_r, hall_Z, hall_Y, Xt, eps,
                                 lengthscale, outputscale, noise_diag, ty)
    dims, ptrs = _checked_points(nh, real_Z, m_r, hall_Z, hall_Y, Xt, eps,
                                 lengthscale, outputscale, noise_diag, ty)
    no, ns, N, Mh, H, D, ty, hn = dims
    dev = Xt.device
    shape = (no, ns, H * ty, N * ty, hn * ty)
    buf = torch.empty((max(blocks_floats(*shape), 1),), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = _fn("gp_hall_blocks")(*ptrs, buf.data_ptr(), *dims,
                                   torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gp_hall_blocks launch")
    obs.count(LAUNCHES, "gp_hall_blocks")
    return block_views(buf, *shape)


def _checked_points(nh, real_Z, m_r, hall_Z, hall_Y, Xt, eps, lengthscale,
                    outputscale, noise_diag, ty):
    """The blocks kernel's sizes (no, ns, N, Mh, H, D, ty, hn) and the
    points' pointers, of CUDA points it can take; raises for any other."""
    if Xt.device.type != "cuda":
        raise ValueError(f"gp_hall: unsupported device {Xt.device}")
    ns, H, D = Xt.shape
    no, Rr = m_r.shape
    N, Mh = real_Z.shape[0], hall_Z.shape[2]
    nh, ty = int(nh), int(ty)
    check_supported(H * ty, Rr, Mh * ty, nh, Xt.dtype)
    check_points_supported(N, Rr, D, ty, nh, Mh)
    args = (("real_Z", real_Z, (N, D)), ("m_r", m_r, (no, Rr)),
            ("hall_Z", hall_Z, (ns, no, Mh, D)),
            ("hall_Y", hall_Y, (ns, no, Mh, ty)), ("Xt", Xt, (ns, H, D)),
            ("eps", eps, (ns, no, H, ty)),
            ("lengthscale", lengthscale, (no, D)),
            ("outputscale", outputscale, (no,)),
            ("noise_diag", noise_diag, (ty,)))
    for name, t, shape in args:
        build.check_tensor(name, t, shape, Xt.device)
    return ((no, ns, N, Mh, H, D, ty, nh // ty),
            [t.data_ptr() for _, t, _ in args])
