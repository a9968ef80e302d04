"""Forward-sampling reachability + dynamics-consistency rejection.

Counterpart of ``sampling_gpmpc_tpu/reachability.py``:

* :func:`forward_sample_rollout` — propagate ns GP function realizations
  one step at a time under a fixed input trajectory, appending each step's
  sampled value back into its realization's conditioning set so the same
  function is consistently re-sampled (ref:
  benchmarking/simulate_forward_sampling_car.py:117-137).  The factor of
  the hallucination buffer is built once and extended by one point per
  step (``gp/exact.py`` append_rows_update, O(t^2)), with one step of
  iterative refinement per triangular solve and the relative Schur floor:
  the float32 hardening that keeps the beta = 30 rollout bounded.
* :func:`reject_and_resample` — the dynamics-rejection step
  (ref: src/agent.py:331-443): realizations whose predictions leave the
  tube around the plan are discarded and their hallucinated datasets
  replaced by those of surviving realizations.

The JAX package runs this path in XLA, with no Pallas kernel; so does the
port (plain torch, ``torch.linalg`` solves).  Solves against the shared
real-data factor fold the sample axis into the right-hand-side columns
(``exact.solve_tri_shared``) instead of broadcasting the factor.  Draws are
injectable (``eps``); otherwise they come from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from sampling_gpmpc_torch import agent as agent_mod
from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.agent import GPState
from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import Env
from sampling_gpmpc_torch.gp import exact
from sampling_gpmpc_torch.gp.exact import GPHyperArrays

_UF_KEYS = ("C", "L_s", "w_h", "mask_h")


def _sample_at_points_uf(spec: ProblemSpec, hyp: GPHyperArrays,
                         gp: GPState, ufs, Xt, eps):
    """Jointly sample at per-sample points from the carried w-form factors.

    Args:
        ufs: per output j, {"C", "L_s", "w_h", "mask_h"} over (ns,).
        Xt: (ns, P, D) GP inputs (P points per sample).
        eps: (ns, g_ny, P, Ty) base draws.
    Returns:
        (ns, g_ny, P, Ty) sampled rows.
    """
    ns, P = Xt.shape[:2]
    Ty = spec.Ty
    Z = Y = None
    if hyp.min_data_dist >= 0.0:
        Z, Y = agent_mod.full_train_set(spec, gp)
    dgs = []
    for j in range(spec.g_ny):
        ls, os_ = hyp.lengthscale[j], hyp.outputscale[j]
        # refine=True: f32 variance accuracy below the true-variance scale
        # (long beta=30 rollouts destabilize on the raw f32 noise floor)
        mean, cov = exact.predict_from_w(
            Xt, gp.real_Z, gp.hall_Z[:, j], agent_mod._output_factor(gp, j),
            ufs[j], ls, os_, spec.use_derivatives, refine=True)
        dgs.append(exact.sample_with_overrides(
            Xt, None if Z is None else Z[:, j], None if Y is None else Y[:, j],
            mean, cov, eps[:, j].reshape(ns, P * Ty), hyp, Ty,
            prior_var=exact.prior_task_variances(ls, os_, Ty)))
    return torch.stack(dgs, dim=1)


def _propagate(spec: ProblemSpec, env: Env, x, u, dg):
    """Per-sample state update x+ = value column of the assembled jacobian.

    Args:
        x: (ns, nx); u: (ns, nu); dg: (ns, g_ny, 1, Ty).
    """
    xu = torch.cat([x, u], dim=-1)
    return env.assemble_val_jac(xu, dg[:, :, 0, :])[..., 0]


def forward_sample_rollout(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                           gp: GPState, x0, U, generator=None,
                           use_feedback: Optional[dict] = None, eps=None):
    """Roll ns sampled dynamics under inputs U with iterative conditioning.

    Args:
        gp: GP state whose hallucination buffer has room for len(U) more
            points; typically ``init_gp_state(spec, env, capacity=T)``.
        x0: (nx,) or (ns, nx) initial state(s).
        U: (T, nu) input trajectory (the plan's inputs).
        generator: ``torch.Generator`` for the truncated-normal draws when
            ``eps`` is not given (seeded with the config's seed if absent).
        use_feedback: optional dict(K=..., x_eq=...) applying the ancillary
            feedback u_eff = U[t] - K(x_eq - x) per sample
            (ref: simulate_forward_sampling_car.py:122).
        eps: optional base draws (T, ns, g_ny, 1, Ty): the reference's
            loadable epistemic vectors, and what makes comparisons with
            shared draws possible.
    Returns:
        X_traj: (T+1, ns, nx) sampled trajectories; final GPState.
    """
    device, dtype = gp.real_Z.device, gp.real_Z.dtype
    if device.type == "cuda":
        setup.full_precision()
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    ns, Ty, T = spec.ns, spec.Ty, len(U)
    U = t_(U)
    x = t_(x0).expand(ns, spec.nx)
    if eps is None:
        if generator is None:
            generator = torch.Generator().manual_seed(spec.seed)
        eps = agent_mod.truncated_normal((T, ns, spec.g_ny, 1, Ty),
                                         spec.gp.beta, generator, device,
                                         dtype)
    eps = t_(eps)
    K = x_eq = None
    if use_feedback is not None:
        K, x_eq = t_(use_feedback["K"]), t_(use_feedback["x_eq"])

    # factor whatever is already in the buffer ONCE; each step then extends
    # the factor by its one new point instead of refactorizing the capacity
    uf0 = agent_mod.batched_update_factor(spec, hyp, gp)
    ufs = [{k: uf0[k][:, j].contiguous() for k in _UF_KEYS}
           for j in range(spec.g_ny)]
    del uf0
    g_idx = list(spec.g_idx_inputs)
    traj = [x]
    for t in range(T):
        u = U[t].expand(ns, spec.nu)
        if K is not None:
            u = u - (x_eq - x) @ K.T
        Xt = torch.cat([x, u], dim=-1)[:, g_idx][:, None, :]   # (ns, 1, D)
        dg = _sample_at_points_uf(spec, hyp, gp, ufs, Xt, eps[t])
        x = _propagate(spec, env, x, u, dg)
        # append value-only observations (gradients NaN-masked, ref:
        # src/agent.py:402) to each realization's conditioning set
        newY = torch.full_like(dg, float("nan"))
        newY[..., 0] = dg[..., 0]
        dist = None
        if hyp.min_data_dist >= 0.0:
            Z = agent_mod.full_train_set(spec, gp)[0]
            dist = torch.linalg.norm(
                Xt[:, None, :, None, :] - Z[:, :, None, :, :], dim=-1)
        newZ, newY = agent_mod.filter_near_duplicates(spec, hyp, Xt, newY,
                                                      dist=dist)
        pos = gp.hall_n * Ty
        gp = agent_mod.append_hall_raw(gp, newZ, newY)
        for j in range(spec.g_ny):
            exact.append_rows_update(
                agent_mod._output_factor(gp, j), ufs[j], gp.real_Z,
                gp.hall_Z[:, j], newZ[:, j], newY[:, j], pos,
                hyp.lengthscale[j], hyp.outputscale[j], hyp.noise_diag,
                hyp.jitter, spec.use_derivatives, refine=True)
        traj.append(x)
    return torch.stack(traj), gp


def reject_and_resample(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                        gp: GPState, X_plan, U_plan, x_next, ci,
                        var_eps: float, generator=None,
                        use_feedback: Optional[dict] = None, donors=None):
    """Dynamics-consistency rejection after a closed-loop step.

    Forward-samples each realization from the measured next state along the
    remaining plan and rejects realizations whose predictions leave the
    per-stage tube |x_pred_i - X_plan_{k+1}| < c_k (ref:
    src/agent.py:331-443).  Rejected realizations get the hallucinated
    dataset of a surviving realization drawn uniformly.

    Args:
        X_plan: (H+1, ns, nx) the solver's plan; U_plan: (H, nu).
        x_next: (nx,) measured state after applying u0.
        ci: (H,) tube radii; var_eps: stage-0 tube.
        generator: ``torch.Generator`` for the rollout's draws and the
            donors (unless ``donors`` is given).
        donors: optional (ns,) donor index of each realization, used where
            it is rejected.
    Returns:
        updated GPState, number of surviving realizations (int).
    """
    H, ns = spec.H, spec.ns
    device, dtype = gp.hall_Z.device, gp.hall_Z.dtype
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    X_plan, x_next = t_(X_plan), t_(x_next)
    if generator is None:
        generator = torch.Generator().manual_seed(spec.seed + 1)

    # stage-1 check: plan's x_{1|k} vs measured x(k+1)
    alive = torch.all(torch.abs(X_plan[1] - x_next[None]) < var_eps, dim=-1)

    # forward-sample the realizations from x(k+1) under U[1:], on a
    # temporarily enlarged conditioning buffer (the FS data is discarded
    # afterwards, ref: src/agent.py:438-441 restores the SQP model)
    extraZ = torch.full(gp.hall_Z.shape[:2] + (H, gp.hall_Z.shape[3]),
                        agent_mod.FAR, dtype=dtype, device=device)
    extraY = torch.full(gp.hall_Y.shape[:2] + (H, gp.hall_Y.shape[3]),
                        float("nan"), dtype=dtype, device=device)
    gp_fs = gp._replace(hall_Z=torch.cat([gp.hall_Z, extraZ], dim=2),
                        hall_Y=torch.cat([gp.hall_Y, extraY], dim=2))
    X_traj, _ = forward_sample_rollout(
        spec, env, hyp, gp_fs, x_next, t_(U_plan)[1:], generator,
        use_feedback=use_feedback)

    # tube checks against the plan's stages 2..H: X_traj[i] is the
    # realization's prediction of stage i+1, whose radius is ci[i]
    diff = X_plan[2:H + 1] - X_traj[1:H]                 # (H-1, ns, nx)
    radii = t_(ci)[1:H, None, None]
    alive = alive & torch.all(torch.abs(diff) < radii, dim=2).all(dim=0)
    n_alive = int(alive.sum())

    # resample rejected realizations' datasets from the survivors; when
    # nothing survives the data stays untouched (ref: src/agent.py:418)
    if n_alive in (0, ns):
        return gp, n_alive
    if donors is None:
        ids = torch.nonzero(alive.cpu())[:, 0]
        donors = ids[torch.randint(n_alive, (ns,), generator=generator)]
    src = torch.where(alive, torch.arange(ns, device=device),
                      torch.as_tensor(donors, device=device))
    return gp._replace(hall_Z=gp.hall_Z[src], hall_Y=gp.hall_Y[src]), n_alive
