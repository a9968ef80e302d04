"""Structured soft-constraint QP (the HPIPM analog, ref: src/utils/ocp.py:302).

``solve_qp_soft`` is a Mehrotra predictor-corrector interior-point method
with analytic soft-slack elimination, row equilibration, a central-path
start at the dual scale, a duals-only warm start, best-KKT tracking and a
Jacobi-preconditioned Cholesky — all load-bearing (see the JAX package's
``ocp/qp.py``).  The algorithm lives in ``ops/ipm.py``: two CUDA kernels for
problems on the GPU (float32 only), its plain torch version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sampling_gpmpc_torch.ops import ipm

# stop after this many iterations without a >= 1 % best-KKT improvement,
# counted only once complementarity is nearly exhausted (mu < MU_GRIND mu0);
# float32 only — float64 keeps the exact exit
STALL_ITERS = 10
STALL_RTOL = 0.01
MU_GRIND = 1e-6
# status 0 iff best KKT residual <= STATUS_RTOL * tol
STATUS_RTOL = 1e3
# warm-start per-pair complementarity band, multiples of mu_ws
WS_BAND = (1e-8, 1e12)


class QPSolution(NamedTuple):
    z: torch.Tensor
    lam: torch.Tensor
    s: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor      # 0 = converged, 4 = not within tolerance
    gap: torch.Tensor         # best relative KKT residual
    state: tuple = None       # unscaled primal-dual iterate (warm starts)


def solve_qp_soft(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu,
                  tol: float = None, max_iter: int = 150, ws: tuple = None,
                  ws_valid=None) -> QPSolution:
    """Solve   min_u  0.5 u'Hu + g'u + sum_j [zl sl + 0.5 Zl sl^2
                                              + zu su + 0.5 Zu su^2]
               s.t.   G_h u <= d_h,   lo_j - sl_j <= G_s u <= hi_j + su_j,
                      sl, su >= 0.

    ``ws`` is the ``state`` tuple of a previous solve with the same row
    structure and ``ws_valid`` a bool tensor that enables it (HPIPM's
    ``qp_solver_warm_start`` analog, ref: src/utils/ocp.py:310).
    """
    dtype = g.dtype
    if tol is None:
        tol = 1e-8 if dtype == torch.float64 else 3e-5
    reg = 1e-13 if dtype == torch.float64 else 1e-7
    args = tuple(a.contiguous() for a in (H, g, G_h, d_h, G_s, lo_s, hi_s,
                                          zl, zu, Zl, Zu))
    if ws is not None:
        ws = tuple(a.contiguous() for a in ws)
    # CPU tensors take the plain solver; CUDA ones the kernels, or raise
    best, best_res, it, scale_h, scale_s = ipm.run_full(
        *args, ws, ws_valid, tol, reg, max_iter, STALL_ITERS, STALL_RTOL,
        MU_GRIND, WS_BAND)
    return _finish(best, best_res, it, scale_h, scale_s, tol)


def _finish(best, best_res, it, scale_h, scale_s, tol):
    """Status + un-equilibration tail shared by both paths."""
    status = torch.where(best_res <= tol * STATUS_RTOL, 0, 4)
    (u_b, sl_b, su_b, th_b, lh_b, tU_b, lU_b, tL_b, lL_b, nl_b, nu_b) = best
    state = (u_b, sl_b * scale_s, su_b * scale_s, th_b * scale_h,
             lh_b / scale_h, tU_b * scale_s, lU_b / scale_s,
             tL_b * scale_s, lL_b / scale_s, nl_b / scale_s, nu_b / scale_s)
    return QPSolution(z=best[0], lam=best[4], s=best[3], iters=it,
                      status=status, gap=best_res, state=state)


def boxes_to_rows(Gl, lo, hi):
    """Two-sided rows lo <= Gl z <= hi as canonical C z <= d."""
    return torch.cat([Gl, -Gl], dim=0), torch.cat([hi, -lo], dim=0)
