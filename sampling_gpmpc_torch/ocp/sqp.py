"""SQP-RTI solve over the augmented sampled-dynamics OCP.

Counterpart of the reference's DEMPC_solver.solve (ref: src/solver.py:39-156)
and of the JAX package's ``ocp/sqp.py``.  Each iteration:

  1. GP condition + function-sample along the iterate (agent.sample_dynamics;
     the hallucination buffer is reset at iteration 0, ref: agent.py:261-272),
  2. per-sample affine linearization (A, B, value) with the ancillary
     feedback chain rule,
  3. condensing onto dU, QP assembly, structured soft QP,
  4. step consumption and the relative-change convergence test.

Iteration 0 is peeled (its GP stage runs on an empty buffer).  With
``max_sqp_iter == 1`` (SQP-RTI) the solve is that one iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sampling_gpmpc_torch import agent as agent_mod
from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.agent import GPState
from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import Env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp.assemble import (build_cost, build_hard_rows,
                                               build_soft_rows, row_counts)
from sampling_gpmpc_torch.ocp.condense import condense_parallel as condense
from sampling_gpmpc_torch.ocp.qp import boxes_to_rows, solve_qp_soft
from sampling_gpmpc_torch.ocp.spec import OCPData


class SolveState(NamedTuple):
    X: torch.Tensor        # (H+1, ns, nx) current iterate
    U: torch.Tensor        # (H, nu)
    gp: GPState
    it: int                # sqp iteration counter
    status: torch.Tensor   # 0 ok
    done: torch.Tensor     # convergence flag
    qp_ws: tuple           # QP warm-start state (ref: src/utils/ocp.py:310)
    qp_valid: torch.Tensor  # bool: qp_ws holds a usable previous solution
    qp_iters: torch.Tensor  # cumulative IPM iterations
    qp_gap: torch.Tensor    # last QP's best KKT residual
    best_step: torch.Tensor  # min raw relative step seen this solve
    stall_count: torch.Tensor
    mono_count: torch.Tensor
    alpha: torch.Tensor     # step under-relaxation (1.0 = pure RTI)


# stall-gated under-relaxation of the SQP step (see consume_step)
STALL_WINDOW = 6
STALL_SHRINK = 0.95
RECOVER_WINDOW = 4
MIN_ALPHA = 1.0 / 16.0


def consume_step(spec: ProblemSpec, X_it, U_it, X_cand, U_cand, ok,
                 best_step, stall_count, mono_count, alpha):
    """Post-QP step consumption.

    * a failed QP's step is not consumed (ref: src/solver.py:146-151);
    * stall-gated under-relaxation: when the raw relative step norm makes
      no new minimum for STALL_WINDOW iterations the applied step halves
      (floor MIN_ALPHA); RECOVER_WINDOW strict new minima double it back
      toward 1, where the update is the candidate itself;
    * the relative-change convergence test on the raw step
      (ref: src/solver.py:66-81).

    Returns (X, U, x_diff, u_diff, done, best_step, stall_count,
    mono_count, alpha).
    """
    dX = X_cand - X_it
    dU = U_cand - U_it
    x_diff = torch.linalg.norm(dX[:spec.H]) / (
        torch.linalg.norm(X_it[:spec.H]) + 1e-6)
    u_diff = torch.linalg.norm(dU) / (torch.linalg.norm(U_it) + 1e-6)
    sn = x_diff + u_diff
    improved = sn < STALL_SHRINK * best_step
    count = torch.where(improved, 0, stall_count + 1)
    engage = (count >= STALL_WINDOW) & (sn >= best_step)
    mono = torch.where(sn < best_step, mono_count + 1, 0)
    recover = (~engage) & (mono >= RECOVER_WINDOW) & (alpha < 1.0)
    alpha_new = torch.where(
        engage, torch.clamp(alpha * 0.5, min=MIN_ALPHA),
        torch.where(recover, torch.clamp(alpha * 2.0, max=1.0), alpha))
    count = torch.where(engage, 0, count)
    mono = torch.where(engage | recover, 0, mono)
    full = alpha_new == 1.0
    X = torch.where(ok, torch.where(full, X_cand, X_it + alpha_new * dX), X_it)
    U = torch.where(ok, torch.where(full, U_cand, U_it + alpha_new * dU), U_it)
    best_step = torch.where(ok, torch.minimum(best_step, sn), best_step)
    stall_count = torch.where(ok, count, stall_count)
    mono_count = torch.where(ok, mono, mono_count)
    alpha = torch.where(ok, alpha_new, alpha)
    done = (x_diff < spec.tol_nlp) & (u_diff < spec.tol_nlp)
    return (X, U, x_diff, u_diff, done, best_step, stall_count, mono_count,
            alpha)


def init_qp_ws(spec: ProblemSpec, device=None, dtype=None):
    """Placeholder warm-start state (selected away while qp_valid=False)."""
    device, dtype = setup.resolve(device, dtype)
    m_h, m_s = row_counts(spec)
    nU = spec.H * spec.nu
    z = lambda n: torch.ones((n,), dtype=dtype, device=device)
    return (torch.zeros((nU,), dtype=dtype, device=device), z(m_s), z(m_s),
            z(m_h), z(m_h), z(m_s), z(m_s), z(m_s), z(m_s), z(m_s), z(m_s))


def init_iterate(spec: ProblemSpec, device=None, dtype=None, start=None):
    """Initial iterate: the start state tiled over all stages, zero inputs —
    acados' default initialization (ref: src/utils/ocp.py:175-177)."""
    device, dtype = setup.resolve(device, dtype)
    X0 = torch.zeros((spec.H + 1, spec.ns, spec.nx), dtype=dtype,
                     device=device)
    if start is not None:
        X0[:] = torch.as_tensor(start, dtype=dtype, device=device)
    return X0, torch.zeros((spec.H, spec.nu), dtype=dtype, device=device)


def _linearization_inputs(spec: ProblemSpec, ocp: OCPData, X, U):
    """Per-sample (x, u_realized) points (ref: solver.py:86-92)."""
    Xs = X[:spec.H].transpose(0, 1)                          # (ns, H, nx)
    Ub = U[None].expand((spec.ns,) + U.shape)                # (ns, H, nu)
    if spec.use_feedback:
        Ub = Ub - (ocp.x_eq[None, None] - Xs) @ ocp.K_fb.T
    return torch.cat([Xs, Ub], dim=-1)                       # (ns, H, nx+nu)


def assemble_qp(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                ocp: OCPData, st_curr, X, U, gp: GPState, eps,
                hall_empty: bool = False):
    """GP sample stage, linearization, condensing and QP assembly of one
    SQP iteration.

    Returns (qp, T, Gamma, gp): ``qp`` the argument tuple of
    ``solve_qp_soft`` (H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu).
    """
    ns, nx = spec.ns, spec.nx
    xu = _linearization_inputs(spec, ocp, X, U)
    Xt = xu[..., list(spec.g_idx_inputs)]                    # (ns, H, D)
    dg, gp = agent_mod.sample_dynamics(spec, env, hyp, gp, Xt, eps,
                                       hall_empty=hall_empty)
    val, A, B = agent_mod.dyn_linearization(spec, env, xu, dg, ocp.K_fb)
    # delta dynamics dx_{k+1} = A dx_k + B du_k + r_k, r = f_lin - x̄_{k+1}
    r = val - X[1:].transpose(0, 1)
    dx0 = st_curr[None].expand(ns, nx) - X[0]
    T, Gamma = condense(A, B, r, dx0)
    H_U, g_U = build_cost(spec, ocp, T, Gamma, X, U)
    hard = build_hard_rows(spec, ocp, T, Gamma, X, U)
    soft, (zl, zu, Zl, Zu) = build_soft_rows(spec, ocp, T, Gamma, X)
    C_h, d_h = boxes_to_rows(hard.G, hard.lo, hard.hi)
    qp = (H_U, g_U, C_h, d_h, soft.G, soft.lo, soft.hi, zl, zu, Zl, Zu)
    return qp, T, Gamma, gp


def sqp_iteration(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                  ocp: OCPData, st_curr, X, U, gp: GPState, eps,
                  qp_ws=None, qp_valid=None, hall_empty: bool = False):
    """One SQP-RTI iteration; returns (X_new, U_new, gp, QPSolution)."""
    H, nu = spec.H, spec.nu
    qp, T, Gamma, gp = assemble_qp(spec, env, hyp, ocp, st_curr, X, U, gp,
                                   eps, hall_empty=hall_empty)
    sol = solve_qp_soft(*qp, tol=(spec.qp_tol if spec.qp_tol > 0 else None),
                        ws=qp_ws, ws_valid=qp_valid)
    dU = sol.z[:H * nu]
    dX = T + torch.einsum("ikau,u->ika", Gamma, dU)          # (ns, H+1, nx)
    return X + dX.transpose(0, 1), U + dU.reshape(H, nu), gp, sol


def solve(spec: ProblemSpec, env: Env, hyp: GPHyperArrays, ocp: OCPData,
          st_curr, X0, U0, gp0: GPState, eps_iters, qp_ws=None,
          qp_valid=None) -> SolveState:
    """Full SQP solve for one MPC step.

    Args:
        st_curr: (nx,) measured state (x0 equality bound).
        X0, U0: warm-start iterate.
        eps_iters: (max_sqp_iter, ns, g_ny, H, Ty) epistemic draws.
        qp_ws, qp_valid: QP warm start from the previous MPC step.
    """
    gp0 = agent_mod.reset_hall(gp0)
    dtype, dev = X0.dtype, X0.device

    def body(s: SolveState, hall_empty: bool = False) -> SolveState:
        X_cand, U_cand, gp, sol = sqp_iteration(
            spec, env, hyp, ocp, st_curr, s.X, s.U, s.gp, eps_iters[s.it],
            qp_ws=s.qp_ws, qp_valid=s.qp_valid, hall_empty=hall_empty)
        ok = sol.status == 0
        (X, U, _, _, done, best_step, stall_count, mono_count,
         alpha) = consume_step(spec, s.X, s.U, X_cand, U_cand, ok,
                               s.best_step, s.stall_count, s.mono_count,
                               s.alpha)
        return SolveState(X=X, U=U, gp=gp,
                          it=s.it + 1, status=sol.status, done=done,
                          qp_ws=sol.state, qp_valid=ok,
                          qp_iters=s.qp_iters + sol.iters, qp_gap=sol.gap,
                          best_step=best_step, stall_count=stall_count,
                          mono_count=mono_count, alpha=alpha)

    if qp_ws is None:
        qp_ws = init_qp_ws(spec, dev, dtype)
        qp_valid = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    s = SolveState(
        X=X0, U=U0, gp=gp0, it=0, status=zero,
        done=torch.zeros((), dtype=torch.bool, device=dev), qp_ws=qp_ws,
        qp_valid=qp_valid, qp_iters=zero,
        qp_gap=torch.tensor(float("inf"), dtype=dtype, device=dev),
        best_step=torch.tensor(float("inf"), dtype=dtype, device=dev),
        stall_count=zero, mono_count=zero,
        alpha=torch.ones((), dtype=dtype, device=dev))
    s = body(s, hall_empty=True)
    while s.it < spec.max_sqp_iter and not bool(s.done) and int(s.status) == 0:
        s = body(s)
    return s
