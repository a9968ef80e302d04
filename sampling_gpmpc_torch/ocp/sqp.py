"""SQP-RTI solve over the augmented sampled-dynamics OCP.

Counterpart of the reference's DEMPC_solver.solve (ref: src/solver.py:39-156)
and of the JAX package's ``ocp/sqp.py``.  Each iteration:

  1. GP condition + function-sample along the iterate (agent.sample_dynamics;
     the hallucination buffer is reset at iteration 0, ref: agent.py:261-272),
  2. per-sample affine linearization (A, B, value) with the ancillary
     feedback chain rule,
  3. condensing onto dU, QP assembly, structured soft QP,
  4. step consumption and the relative-change convergence test (one
     launch of ops/glue.py::advance on the kernel route, else
     consume_step).

Iteration 0 is peeled (its GP stage runs on an empty buffer).  With
``max_sqp_iter == 1`` (SQP-RTI) the solve is that one iteration.
``solve_recorded`` is the debug twin of ``solve``: the same iterations,
step by step, with every iterate, its GP samples, the posterior moments
they were drawn from and the assembled QP kept.

Under a sample-axis ``group`` (parallel/collectives.py) the same body runs
shard-local on ``spec.ns`` local samples: the GP stage, linearization,
condensing and rows stay local; the condensed cost, the QP's row
reductions and the convergence norms cross shards.  Every host-side branch
(the iteration test, the IPM's exits) reads a reduced value, so all ranks
stay in lockstep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sampling_gpmpc_torch import agent as agent_mod
from sampling_gpmpc_torch import obs, setup
from sampling_gpmpc_torch.agent import GPState
from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import Env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp.assemble import condensed_qp, row_counts
from sampling_gpmpc_torch.ocp.qp import solve_qp_soft
from sampling_gpmpc_torch.ocp.spec import OCPData
from sampling_gpmpc_torch.ops import build, glue
from sampling_gpmpc_torch.parallel.collectives import make_reducers


class SolveState(NamedTuple):
    X: torch.Tensor        # (H+1, ns, nx) current iterate
    U: torch.Tensor        # (H, nu)
    X_prev: torch.Tensor   # the iterate entering the last iteration
    U_prev: torch.Tensor
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
# the four as ops/glue.py::advance takes them
STALL = (STALL_WINDOW, STALL_SHRINK, RECOVER_WINDOW, MIN_ALPHA)


def consume_step(spec: ProblemSpec, X_it, U_it, X_cand, U_cand, ok,
                 best_step, stall_count, mono_count, alpha, group=None,
                 ordered: bool = False):
    """Post-QP step consumption.

    * a failed QP's step is not consumed (ref: src/solver.py:146-151);
    * stall-gated under-relaxation: when the raw relative step norm makes
      no new minimum for STALL_WINDOW iterations the applied step halves
      (floor MIN_ALPHA); RECOVER_WINDOW strict new minima double it back
      toward 1, where the update is the candidate itself;
    * the relative-change convergence test on the raw step
      (ref: src/solver.py:66-81); under a group the X norms are
      sqrt(psum(sum(a * a))) over the shards' samples.

    Returns (X, U, x_diff, u_diff, done, best_step, stall_count,
    mono_count, alpha).
    """
    dX = X_cand - X_it
    dU = U_cand - U_it
    if group is None:
        norm = torch.linalg.norm
    else:
        psum = make_reducers(group, ordered)[0]
        norm = lambda a: torch.sqrt(psum(torch.sum(a * a)))  # noqa: E731
    x_diff = norm(dX[:spec.H]) / (norm(X_it[:spec.H]) + 1e-6)
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
    with obs.span("loop.start"):
        return (torch.zeros((nU,), dtype=dtype, device=device), z(m_s),
                z(m_s), z(m_h), z(m_h), z(m_s), z(m_s), z(m_s), z(m_s),
                z(m_s), z(m_s))


def init_iterate(spec: ProblemSpec, device=None, dtype=None, start=None):
    """Initial iterate: the start state tiled over all stages, zero inputs —
    acados' default initialization (ref: src/utils/ocp.py:175-177)."""
    device, dtype = setup.resolve(device, dtype)
    with obs.span("loop.start"):
        X0 = torch.zeros((spec.H + 1, spec.ns, spec.nx), dtype=dtype,
                         device=device)
        if start is not None:
            # a copy from pageable host memory: the host waits for the
            # device
            obs.count(obs.SYNCS, "sqp.init_iterate:start", tally=False)
            X0[:] = torch.as_tensor(start, dtype=dtype, device=device)
        return X0, torch.zeros((spec.H, spec.nu), dtype=dtype,
                               device=device)


def _linearization_inputs(spec: ProblemSpec, ocp: OCPData, X, U):
    """Per-sample (x, u_realized) points (ref: solver.py:86-92)."""
    Xs = X[:spec.H].transpose(0, 1)                          # (ns, H, nx)
    Ub = U[None].expand((spec.ns,) + U.shape)                # (ns, H, nu)
    if spec.use_feedback:
        Ub = Ub - (ocp.x_eq[None, None] - Xs) @ ocp.K_fb.T
    return torch.cat([Xs, Ub], dim=-1)                       # (ns, H, nx+nu)


def assemble_qp(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                ocp: OCPData, st_curr, X, U, gp: GPState, eps,
                hall_empty: bool = False, group=None, ordered: bool = False):
    """GP sample stage, linearization, condensing and QP assembly of one
    SQP iteration.

    Returns (qp, T, Gamma, gp): ``qp`` the argument tuple of
    ``solve_qp_soft`` (H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu).
    """
    return _assemble(spec, env, hyp, ocp, st_curr, X, U, gp, eps,
                     hall_empty, group, ordered)[:4]


def _assemble(spec, env, hyp, ocp, st_curr, X, U, gp, eps, hall_empty,
              group=None, ordered=False):
    """:func:`assemble_qp` and the GP rows ``dg`` and inputs ``Xt``."""
    with obs.span("glue.linearize"):
        xu = _linearization_inputs(spec, ocp, X, U)
        # the index list's copy to the device synchronises
        obs.count(obs.SYNCS, "sqp._assemble:g_idx_inputs", tally=False)
        Xt = xu[..., list(spec.g_idx_inputs)]                # (ns, H, D)
    with obs.span("gp.sample"):
        dg, gp = agent_mod.sample_dynamics(spec, env, hyp, gp, Xt, eps,
                                           hall_empty=hall_empty, group=group)
    with obs.span("glue.linearize"):
        combined = env.assemble_val_jac(xu, dg.transpose(1, 2))
    # the feedback chain rule, residuals, condensing and rows: one kernel
    # on the card (ops/glue.py)
    qp, T, Gamma = condensed_qp(spec, ocp, combined, X, U, st_curr, group,
                                ordered)
    return qp, T, Gamma, gp, dg, Xt


QP_KEYS = ("H", "g", "C_h", "d_h", "G_s", "lo_s", "hi_s", "zl", "zu",
           "Zl", "Zu")


def _qp_step(spec, env, hyp, ocp, st_curr, X, U, gp, eps, qp_ws, qp_valid,
             hall_empty, group, ordered):
    """An SQP iteration up to its QP: (T, Gamma, gp, QPSolution, debug),
    debug = {"dg", "Xt", "qp"} as :func:`sqp_iteration` returns it."""
    qp, T, Gamma, gp, dg, Xt = _assemble(spec, env, hyp, ocp, st_curr, X, U,
                                         gp, eps, hall_empty, group, ordered)
    sol = solve_qp_soft(*qp, tol=(spec.qp_tol if spec.qp_tol > 0 else None),
                        ws=qp_ws, ws_valid=qp_valid, group=group,
                        ordered=ordered)
    return T, Gamma, gp, sol, {"dg": dg, "Xt": Xt,
                               "qp": dict(zip(QP_KEYS, qp))}


def candidate(spec: ProblemSpec, X, U, T, Gamma, z):
    """The full step's iterate (X + (T + Gamma dU)', U + dU), dU = z[:nU]."""
    H, nu = spec.H, spec.nu
    dU = z[:H * nu]
    dX = T + torch.einsum("ikau,u->ika", Gamma, dU)          # (ns, H+1, nx)
    return X + dX.transpose(0, 1), U + dU.reshape(H, nu)


def sqp_iteration(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                  ocp: OCPData, st_curr, X, U, gp: GPState, eps,
                  qp_ws=None, qp_valid=None, return_debug: bool = False,
                  hall_empty: bool = False, group=None,
                  ordered: bool = False):
    """One SQP-RTI iteration; returns (X_new, U_new, gp, QPSolution), the
    full step's candidate, and with ``return_debug`` also {"dg", "Xt",
    "qp"}: the sampled GP rows, the GP inputs and the assembled QP
    (``QP_KEYS``).  ``solve`` consumes the step through :func:`_advance`
    instead."""
    T, Gamma, gp, sol, dbg = _qp_step(spec, env, hyp, ocp, st_curr, X, U,
                                      gp, eps, qp_ws, qp_valid, hall_empty,
                                      group, ordered)
    with obs.span("sqp.advance"):
        X_new, U_new = candidate(spec, X, U, T, Gamma, sol.z)
    if return_debug:
        return X_new, U_new, gp, sol, dbg
    return X_new, U_new, gp, sol


def _initial_state(spec: ProblemSpec, X0, U0, gp0: GPState, qp_ws,
                   qp_valid) -> SolveState:
    """The state entering iteration 0: the hallucination buffer reset, the
    placeholder warm start unless one is given."""
    dtype, dev = X0.dtype, X0.device
    if qp_ws is None:
        qp_ws = init_qp_ws(spec, dev, dtype)
        qp_valid = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # two copies from pageable host memory: the host waits for the device
    obs.count(obs.SYNCS, "sqp._initial_state:qp_gap", tally=False)
    obs.count(obs.SYNCS, "sqp._initial_state:best_step", tally=False)
    return SolveState(
        X=X0, U=U0, X_prev=X0, U_prev=U0, gp=agent_mod.reset_hall(gp0), it=0,
        status=zero, done=torch.zeros((), dtype=torch.bool, device=dev),
        qp_ws=qp_ws, qp_valid=qp_valid, qp_iters=zero,
        qp_gap=torch.tensor(float("inf"), dtype=dtype, device=dev),
        best_step=torch.tensor(float("inf"), dtype=dtype, device=dev),
        stall_count=zero, mono_count=zero,
        alpha=torch.ones((), dtype=dtype, device=dev))


def _advance(spec: ProblemSpec, s: SolveState, T, Gamma, gp, sol,
             group=None, ordered=False):
    """The state after one iteration from its QP's solution and the
    iteration's T, Gamma: the one update of ``solve`` and
    ``solve_recorded``.  One launch of ``ops/glue.py::advance`` where
    ``build.kernel_route("glue", ...)`` holds and no group is given (the
    group's norms need a psum); else :func:`consume_step` on
    :func:`candidate`.  Returns (SolveState, x_diff, u_diff)."""
    with obs.span("sqp.advance"):
        if group is None and build.kernel_route("glue", s.X.device):
            (X, U, x_diff, u_diff, done, best_step, stall_count, mono_count,
             alpha, ok, qp_iters) = glue.advance(
                spec, s.X, s.U, T, Gamma, sol.z, sol.status, sol.iters,
                s.best_step, s.stall_count, s.mono_count, s.alpha,
                s.qp_iters, STALL)
        else:
            X_cand, U_cand = candidate(spec, s.X, s.U, T, Gamma, sol.z)
            ok = sol.status == 0
            (X, U, x_diff, u_diff, done, best_step, stall_count, mono_count,
             alpha) = consume_step(spec, s.X, s.U, X_cand, U_cand, ok,
                                   s.best_step, s.stall_count, s.mono_count,
                                   s.alpha, group, ordered)
            qp_iters = s.qp_iters + sol.iters
    return SolveState(X=X, U=U, X_prev=s.X, U_prev=s.U, gp=gp, it=s.it + 1,
                      status=sol.status, done=done, qp_ws=sol.state,
                      qp_valid=ok, qp_iters=qp_iters, qp_gap=sol.gap,
                      best_step=best_step, stall_count=stall_count,
                      mono_count=mono_count, alpha=alpha), x_diff, u_diff


def _go_on(spec: ProblemSpec, s: SolveState) -> bool:
    """Whether another iteration runs: none past ``max_sqp_iter``, else
    reads ``done`` and ``status`` (each a sync on the device).  Both are
    replicated under a group (reduced norms, the QP's reduced residual),
    so every rank takes the same branch."""
    if s.it >= spec.max_sqp_iter:
        return False
    obs.count(obs.SYNCS, "sqp._go_on:done", tally=False)
    if bool(s.done):
        return False
    obs.count(obs.SYNCS, "sqp._go_on:status", tally=False)
    return int(s.status) == 0


def solve(spec: ProblemSpec, env: Env, hyp: GPHyperArrays, ocp: OCPData,
          st_curr, X0, U0, gp0: GPState, eps_iters, qp_ws=None,
          qp_valid=None, group=None, ordered: bool = False) -> SolveState:
    """Full SQP solve for one MPC step.

    Args:
        st_curr: (nx,) measured state (x0 equality bound).
        X0, U0: warm-start iterate.
        eps_iters: (max_sqp_iter, ns, g_ny, H, Ty) epistemic draws.
        qp_ws, qp_valid: QP warm start from the previous MPC step.
        group, ordered: sample-axis group and sum mode (module docstring);
            X0, gp0's hall buffers, eps_iters, ocp.w_cost and qp_ws[1:]
            are then this shard's.
    """
    with obs.span("sqp.solve"):
        s = _initial_state(spec, X0, U0, gp0, qp_ws, qp_valid)
        while True:
            with obs.span("sqp.iteration"):
                T, Gamma, gp, sol, _ = _qp_step(
                    spec, env, hyp, ocp, st_curr, s.X, s.U, s.gp,
                    eps_iters[s.it], s.qp_ws, s.qp_valid, s.it == 0, group,
                    ordered)
                s = _advance(spec, s, T, Gamma, gp, sol, group, ordered)[0]
            with obs.span("sqp.go_on"):
                go_on = _go_on(spec, s)
            if not go_on:
                return s


def solve_recorded(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                   ocp: OCPData, st_curr, X0, U0, gp0: GPState, eps_iters,
                   qp_ws=None, qp_valid=None, probe_fn=None, group=None,
                   ordered: bool = False):
    """Debug twin of :func:`solve` that records every SQP iterate.

    The same iterations and stopping rule as ``solve`` (the same kernels
    on CUDA), plus, before each iteration, the posterior value moments of
    the model its samples are drawn from (ref: src/solver.py:153-154,
    194-352).  Every record syncs the device.

    Args:
        probe_fn: optional replacement for the moment probe,
            ``probe_fn(gp, Xt) -> (mean, std)``.
        group, ordered: as for :func:`solve`; the records hold this
            shard's samples.
    Returns:
        (SolveState, records): one dict per iteration with X, U (after
        the step), dg, mean, std (None where no GP sample is drawn),
        x_diff, u_diff, qp_iters, qp_gap, qp_status and qp.
    """
    if probe_fn is None:
        probe_fn = lambda gp, Xt: agent_mod.posterior_value_moments(
            spec, hyp, gp, Xt)
    # agent.sample_dynamics's predicate: the probe is skipped only when no
    # live GP sample is drawn at all
    oracle_only = (
        (spec.true_dyn_as_sample or spec.mean_as_dyn_sample) and spec.ns == 1
    ) or (spec.true_dyn_as_sample and spec.mean_as_dyn_sample
          and spec.ns == 2)
    s = _initial_state(spec, X0, U0, gp0, qp_ws, qp_valid)
    records = []
    while True:
        mean = std = None
        if not oracle_only:
            obs.count(obs.SYNCS, "sqp.solve_recorded:g_idx_inputs",
                      tally=False)
            Xt = _linearization_inputs(spec, ocp, s.X, s.U)[
                ..., list(spec.g_idx_inputs)]
            mean, std = probe_fn(s.gp, Xt)
        T, Gamma, gp, sol, dbg = _qp_step(
            spec, env, hyp, ocp, st_curr, s.X, s.U, s.gp, eps_iters[s.it],
            s.qp_ws, s.qp_valid, s.it == 0, group, ordered)
        s, x_diff, u_diff = _advance(spec, s, T, Gamma, gp, sol, group,
                                     ordered)
        records.append({
            "X": s.X, "U": s.U, "dg": dbg["dg"], "mean": mean, "std": std,
            "x_diff": float(x_diff), "u_diff": float(u_diff),
            "qp_iters": int(sol.iters), "qp_gap": float(sol.gap),
            "qp_status": int(sol.status), "qp": dbg["qp"]})
        if not _go_on(spec, s):
            return s, records
