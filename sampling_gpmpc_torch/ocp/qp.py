"""Structured soft-constraint QP (the HPIPM analog, ref: src/utils/ocp.py:302).

``solve_qp_soft`` is a Mehrotra predictor-corrector interior-point method
with analytic soft-slack elimination, row equilibration, a central-path
start at the dual scale, a duals-only warm start, best-KKT tracking and a
Jacobi-preconditioned Cholesky — all load-bearing (see the JAX package's
``ocp/qp.py``).  The algorithm lives in ``ops/ipm.py``: two CUDA kernels for
problems on the GPU (float32 only), its plain torch version on the CPU.

Under a sample-axis group (``group``: this shard's rows of a sharded QP)
the solve runs the plain body with the group's reducers on whatever device
its tensors are on: the counterpart of the JAX package's gate, which turns
its Pallas IPM off under ``axis_name`` and runs its XLA body
(``sampling_gpmpc_tpu/ocp/qp.py:273``).  ``ROUTES`` counts the solves of
each route.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sampling_gpmpc_torch.ops import build, ipm

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
# solves by route: "run_full" (ops/ipm.run_full: kernels 1-2 on CUDA, the
# plain version on the CPU) and "group" (the plain body under a group)
ROUTES = {"run_full": 0, "group": 0}


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
                  ws_valid=None, group=None,
                  ordered: bool = False) -> QPSolution:
    """Solve   min_u  0.5 u'Hu + g'u + sum_j [zl sl + 0.5 Zl sl^2
                                              + zu su + 0.5 Zu su^2]
               s.t.   G_h u <= d_h,   lo_j - sl_j <= G_s u <= hi_j + su_j,
                      sl, su >= 0.

    ``ws`` is the ``state`` tuple of a previous solve with the same row
    structure and ``ws_valid`` a bool tensor that enables it (HPIPM's
    ``qp_solver_warm_start`` analog, ref: src/utils/ocp.py:310).

    ``group``: the rows (G_h, d_h, the soft rows and their penalties, the
    warm start's row slots) are this shard's; H, g and u are replicated.
    ``ordered`` selects the order-defined sums (parallel/collectives.py).
    """
    dtype = g.dtype
    if tol is None:
        tol = 1e-8 if dtype == torch.float64 else 3e-5
    reg = 1e-13 if dtype == torch.float64 else 1e-7
    args = tuple(a.contiguous() for a in (H, g, G_h, d_h, G_s, lo_s, hi_s,
                                          zl, zu, Zl, Zu))
    if ws is not None:
        ws = tuple(a.contiguous() for a in ws)
    if group is not None:
        # the JAX gate (qp.py:273): no fused IPM under a sample axis
        build.count(ROUTES, "group")
        p = ipm.prepare_plain(*args, ws, ws_valid, WS_BAND, group, ordered)
        best, best_res, it = ipm.mehrotra_plain(
            p, tol, reg, max_iter, STALL_ITERS, STALL_RTOL, MU_GRIND, group,
            ordered)
        return _finish(best, best_res, it, p.scale_h, p.scale_s, tol)
    build.count(ROUTES, "run_full")
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
