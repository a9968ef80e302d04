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

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.ops import build, ipm
from sampling_gpmpc_torch.ops.ipm import _precond_factor, _precond_solve
from sampling_gpmpc_torch.parallel.collectives import (group_size,
                                                       make_reducers)

# stop after this many iterations without a >= 1 % best-KKT improvement,
# counted only once complementarity is nearly exhausted (mu < MU_GRIND mu0);
# float32 only — float64 keeps the exact exit
STALL_ITERS = 10
STALL_RTOL = 0.01
MU_GRIND = 1e-6
# status 0 iff best KKT residual <= STATUS_RTOL * tol
STATUS_RTOL = 1e3
# default exit tolerance (relative KKT residual) by dtype
TOL = {torch.float64: 1e-8, torch.float32: 3e-5}
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


def solve_qp(P, q, C, d, tol: float = None, max_iter: int = 50,
             group=None, ordered: bool = False) -> QPSolution:
    """Solve min 0.5 z'Pz + q'z s.t. Cz <= d: the generic Mehrotra
    predictor-corrector IPM with slacks as variables, the cross-check
    solver ``solve_qp_soft`` is held against (counterpart of the JAX
    package's ``ocp/qp.py::solve_qp``; plain torch on whatever device its
    tensors are on, as the JAX package has no kernel for it).

    With ``group`` the rows (C, d) are this shard's of a sample-sharded QP
    and (P, q, z) are replicated: every row reduction goes through the
    group's reducers (``parallel/collectives.py``), where the JAX package
    has its psum/pmin/pmax over ``axis_name``.

    Args:
        P: (nz, nz) PD Hessian; q: (nz,); C: (m_local, nz); d: (m_local,).
    """
    nz = q.shape[0]
    dtype, dev = q.dtype, q.device
    if dev.type == "cuda":
        setup.full_precision()
    if tol is None:
        tol = TOL[dtype]
    reg = 1e-13 if dtype == torch.float64 else 1e-7
    psum, pmin, pmax = make_reducers(group, ordered)
    m = d.shape[0] * group_size(group)

    z = torch.zeros(nz, dtype=dtype, device=dev)
    s = torch.clamp(d - C @ z, min=1.0)
    # start on the central path (s_i lam_i = 1): pseudo-infinite rows
    # (slack ~ BIG) carry a near-zero multiplier
    lam = 1.0 / s
    # scale-aware residuals: the dual residual in the units of q, the
    # primal relative to 1 + |d|
    qscale = 1.0 + torch.max(torch.abs(q))

    def factorize(z, lam, s):
        w = lam / s
        rd_s, M_s = psum((C.T @ lam, (C.T * w) @ C))
        inv_s, L = _precond_factor(P + M_s, reg)
        return w, P @ z + q + rd_s, C @ z + s - d, inv_s, L

    def direction(lam, s, aux, sigma_mu, corr):
        w, r_dual, r_prim, inv_s, L = aux
        r_cent = lam * s - sigma_mu + corr
        rhs = -r_dual + psum(C.T @ (r_cent / s - w * r_prim))
        dz = _precond_solve(inv_s, L, rhs)
        ds = -r_prim - C @ dz
        return dz, ds, -(r_cent + lam * ds) / s

    def ratio(v, dv):
        r = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        torch.full_like(v, float("inf")))
        return torch.min(r) if r.numel() else r.new_tensor(float("inf"))

    def max_step2(v1, dv1, v2, dv2):
        """Two step ratios through one stacked pmin."""
        mn = pmin(torch.stack([ratio(v1, dv1), ratio(v2, dv2)]))
        return (torch.clamp(0.99 * mn[0], max=1.0),
                torch.clamp(0.99 * mn[1], max=1.0))

    def residual_parts(z, lam, s):
        rd_s, compl = psum((C.T @ lam, torch.dot(s, lam)))
        r_dual = torch.max(torch.abs(P @ z + q + rd_s)) / qscale
        rp = torch.abs(C @ z + s - d) / (1.0 + torch.abs(d))
        r_prim = pmax(torch.max(rp) if rp.numel() else rp.new_zeros(()))
        return torch.maximum(torch.maximum(r_dual, r_prim),
                             compl / (m * qscale)), compl

    it = 0
    csum = psum(torch.dot(s, lam))
    res = torch.tensor(float("inf"), dtype=dtype, device=dev)
    while it < max_iter and bool(res > tol):
        mu = csum / m
        aux = factorize(z, lam, s)
        # predictor (affine) step
        dz_a, ds_a, dlam_a = direction(lam, s, aux, 0.0, 0.0)
        a_p, a_d = max_step2(s, ds_a, lam, dlam_a)
        mu_aff = psum(torch.dot(s + a_p * ds_a, lam + a_d * dlam_a)) / m
        sigma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
        # corrector
        dz, ds, dlam = direction(lam, s, aux, sigma * mu, dlam_a * ds_a)
        a_s, a_l = max_step2(s, ds, lam, dlam)
        alpha = torch.minimum(a_s, a_l)
        z_n, s_n, lam_n = z + alpha * dz, s + alpha * ds, lam + alpha * dlam
        # freeze the iterate if the numerics break down (s -> 0 past
        # convergence); the flag agrees across shards
        fin = torch.stack([torch.isfinite(v).all() for v in (z_n, lam_n,
                                                             s_n)]).all()
        ok = bool(pmin(fin.to(torch.int32)) > 0)
        it += 1
        if not ok:
            break
        z, s, lam = z_n, s_n, lam_n
        res, csum = residual_parts(z, lam, s)
    res = residual_parts(z, lam, s)[0]
    status = torch.where(res <= tol * STATUS_RTOL, 0, 4)
    return QPSolution(z=z, lam=lam, s=s, iters=torch.tensor(it, device=dev),
                      status=status, gap=res)


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
        tol = TOL[dtype]
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
