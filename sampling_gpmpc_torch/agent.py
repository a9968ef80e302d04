"""Sampling engine: epistemic draws, GP state, dynamics jacobians.

Counterpart of ``sampling_gpmpc_tpu/agent.py`` (ref: src/agent.py:18-730).
The GP state holds the real training data with its factor (computed once)
and a static-capacity "hallucinated" append buffer whose empty slots sit at
a far-away input (FAR) with NaN observations.  SQP iteration 0 runs on an
empty buffer (by construction) and conditions on the real factor alone;
later iterations condition each sample on its filled buffer by the block
Cholesky update of gp/exact.py (the hall-block stage).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sampling_gpmpc_torch import obs, setup
from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import Env
from sampling_gpmpc_torch.gp import exact
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.gp.kernel import kernel_matrix
from sampling_gpmpc_torch.ops import gp_hall, gp_sample
from sampling_gpmpc_torch.parallel.collectives import sample_offset

FAR = 1.0e5   # input coordinate of empty hallucination slots


class GPState(NamedTuple):
    real_Z: torch.Tensor    # (N, D)
    real_Y: torch.Tensor    # (g_ny, N, Ty)
    real_fact: dict         # per-output {"L", "w", "mask", "Linv", "alpha"}
    hall_Z: torch.Tensor    # (ns, g_ny, Mh, D)
    hall_Y: torch.Tensor    # (ns, g_ny, Mh, Ty)  (NaN = empty/masked)
    hall_n: int             # fill count


def init_gp_state(spec: ProblemSpec, env: Env, device=None, dtype=None,
                  capacity: int = None, hyp: GPHyperArrays = None) -> GPState:
    device, dtype = setup.resolve(device, dtype)
    X, Y = env.training_grid()
    Y = Y[:, :, :spec.Ty]
    Mh = capacity if capacity is not None else spec.H * max(spec.max_sqp_iter, 1)
    real_Z = torch.as_tensor(X, dtype=dtype, device=device)
    real_Y = torch.as_tensor(Y, dtype=dtype, device=device)
    if hyp is None:
        hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)
    facts = [exact.factor_real(real_Z, real_Y[j], hyp.lengthscale[j],
                               hyp.outputscale[j], hyp.noise_diag, hyp.jitter,
                               spec.use_derivatives)
             for j in range(spec.g_ny)]
    rf = {k: torch.stack([f[k] for f in facts]) for k in facts[0]}
    return reset_hall(GPState(
        real_Z=real_Z, real_Y=real_Y, real_fact=rf,
        hall_Z=torch.empty((spec.ns, spec.g_ny, Mh, spec.n_gp_inputs),
                           dtype=dtype, device=device),
        hall_Y=torch.empty((spec.ns, spec.g_ny, Mh, spec.Ty), dtype=dtype,
                           device=device),
        hall_n=0))


def reset_hall(gp: GPState) -> GPState:
    return gp._replace(hall_Z=torch.full_like(gp.hall_Z, FAR),
                       hall_Y=torch.full_like(gp.hall_Y, float("nan")),
                       hall_n=0)


def full_train_set(spec: ProblemSpec, gp: GPState):
    """(ns, g_ny, M, D), (ns, g_ny, M, Ty) concatenated real+hallucinated."""
    Z = gp.real_Z.expand((spec.ns, spec.g_ny) + gp.real_Z.shape)
    Y = gp.real_Y.expand((spec.ns,) + gp.real_Y.shape)
    return (torch.cat([Z, gp.hall_Z], dim=2), torch.cat([Y, gp.hall_Y], dim=2))


def make_epistemic(spec: ProblemSpec, generator: torch.Generator = None,
                   device=None, dtype=None) -> torch.Tensor:
    """Truncated-normal base draws on [-beta, beta] for every (mpc, sqp)
    iteration (ref: src/agent.py:76-104 rejection-samples whole blocks;
    for iid entries that equals a per-entry truncated normal).  Drawn on
    the CPU from ``generator`` by the inverse CDF, then moved."""
    device, dtype = setup.resolve(device, dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(spec.seed)
    shape = (spec.num_mpc_iter, spec.max_sqp_iter, spec.ns, spec.g_ny,
             spec.H, spec.Ty)
    return truncated_normal(shape, spec.gp.beta, generator, device, dtype)


def truncated_normal(shape, beta: float, generator: torch.Generator,
                     device, dtype) -> torch.Tensor:
    """Standard normal draws truncated to [-beta, beta], by the inverse CDF
    of uniforms drawn on the CPU from ``generator``, then moved."""
    beta = torch.tensor(beta, dtype=torch.float64)
    normal = torch.distributions.Normal(0.0, 1.0)
    lo, hi = normal.cdf(-beta), normal.cdf(beta)
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = torch.special.ndtri(lo + (hi - lo) * u).clamp(-beta, beta)
    return x.to(device=device, dtype=dtype)


def empty_stage_inputs(spec: ProblemSpec, hyp: GPHyperArrays, gp: GPState,
                       Xt, eps, j: int) -> dict:
    """Arguments of ``gp_sample.sample_empty_one`` for GP output j: the
    masked cross-covariance and test blocks (plain torch, as the JAX
    package leaves them to XLA), the base draws and the real-data factor."""
    H, Ty, ns = spec.H, spec.Ty, spec.ns
    R = gp.real_fact["mask"].shape[-1]
    ls, os_ = hyp.lengthscale[j], hyp.outputscale[j]
    Zb = gp.real_Z.expand((ns,) + gp.real_Z.shape)
    Kall = kernel_matrix(Xt, torch.cat([Zb, Xt], dim=1), ls, os_,
                         spec.use_derivatives)
    return dict(
        Kxm=(Kall[..., :R] * gp.real_fact["mask"][j]).contiguous(),
        Ktt=Kall[..., R:].contiguous(),
        eps=eps[:, j].reshape(ns, H * Ty).contiguous(),
        Linv=gp.real_fact["Linv"][j].contiguous(),
        alpha=gp.real_fact["alpha"][j].contiguous(),
        prior_var=exact.prior_task_variances(ls, os_, Ty).repeat(H)
        .contiguous(),
        jitter=max(hyp.jitter, 1e-6),   # safe_cholesky's f32 first attempt
        beta=hyp.beta, var_zero=hyp.variance_is_zero, rel_floor=1e-5, ty=Ty)


def empty_stage_inputs_all(spec: ProblemSpec, hyp: GPHyperArrays,
                           gp: GPState, Xt, eps, md=None) -> dict:
    """Arguments of ``gp_sample.sample_empty``: every output's
    :func:`empty_stage_inputs` stacked on a leading output axis, with the
    min-dist override rows ``md`` = (close, ynear), each (ns, g_ny, Ht), or
    None."""
    return _stack_outputs([empty_stage_inputs(spec, hyp, gp, Xt, eps, j)
                           for j in range(spec.g_ny)], gp_sample.STACKED, md)


def _stack_outputs(kws, stacked, md) -> dict:
    """One stage call's arguments from each output's: the per-output ones
    (``stacked``) stacked on a leading axis, the shared ones from the
    first, and the min-dist rows ``md`` moved to output-major order."""
    out = {k: (torch.stack([kw[k] for kw in kws]) if k in stacked else v)
           for k, v in kws[0].items()}
    if md is not None:
        out.update(close=md[0].transpose(0, 1).contiguous(),
                   ynear=md[1].transpose(0, 1).contiguous())
    return out


def _fused_sample_empty(spec: ProblemSpec, hyp: GPHyperArrays, gp: GPState,
                        Xt, eps, md=None):
    """Empty-hall GP stage through the fused kernel (ops/gp_sample.py):
    posterior, Cholesky, pathwise draw and override tail, every output in
    one launch."""
    with obs.span("gp.inputs"):
        kw = empty_stage_inputs_all(spec, hyp, gp, Xt, eps, md)
    with obs.span("gp.kernel"):
        dg = gp_sample.sample_empty(**kw)
    return dg.transpose(0, 1).reshape(spec.ns, spec.g_ny, spec.H, spec.Ty)


def hall_stage_inputs(spec: ProblemSpec, hyp: GPHyperArrays, gp: GPState,
                      Xt, eps, j: int) -> dict:
    """Arguments of ``gp_hall.sample_hall_one`` for GP output j: the masked
    real, hall and test kernel blocks over the whole capacity
    (``gp_hall.hall_blocks_one``), the base draws and the real-data
    factor.  With :func:`hall_stage_inputs_all` and
    ``gp_hall.sample_hall_plain_stacked`` it is the plain twin of the stage
    the agent runs (:func:`hall_point_inputs`)."""
    H, Ty, ns = spec.H, spec.Ty, spec.ns
    ls, os_ = hyp.lengthscale[j], hyp.outputscale[j]
    blocks = gp_hall.hall_blocks_one(
        gp.real_Z, gp.real_fact["mask"][j], gp.hall_Z[:, j], gp.hall_Y[:, j],
        Xt, ls, os_, hyp.noise_diag, spec.use_derivatives)
    return dict(
        nh=gp.hall_n * Ty, **blocks,
        eps=eps[:, j].reshape(ns, H * Ty).contiguous(),
        Linv=gp.real_fact["Linv"][j].contiguous(),
        w_r=gp.real_fact["w"][j].contiguous(),
        prior_var=exact.prior_task_variances(ls, os_, Ty).repeat(H)
        .contiguous(),
        jitter=max(hyp.jitter, 1e-6),   # safe_cholesky's f32 first attempt
        beta=hyp.beta, var_zero=hyp.variance_is_zero, rel_floor=1e-5, ty=Ty)


def hall_stage_inputs_all(spec: ProblemSpec, hyp: GPHyperArrays,
                          gp: GPState, Xt, eps, md=None) -> dict:
    """Arguments of ``gp_hall.sample_hall``: every output's
    :func:`hall_stage_inputs` stacked on a leading output axis, with the
    min-dist override rows ``md`` = (close, ynear), each (ns, g_ny, Ht), or
    None."""
    return _stack_outputs([hall_stage_inputs(spec, hyp, gp, Xt, eps, j)
                           for j in range(spec.g_ny)], gp_hall.STACKED, md)


def hall_point_inputs(spec: ProblemSpec, hyp: GPHyperArrays, gp: GPState,
                      Xt, eps, md=None) -> dict:
    """Arguments of ``gp_hall.sample_hall_points``: the points, masks,
    hyperparameters and real factor as the state holds them (no copy), the
    base draws, and the min-dist override rows ``md`` = (close, ynear),
    each (ns, g_ny, Ht), or None, in output-major order."""
    kw = dict(nh=gp.hall_n * spec.Ty, real_Z=gp.real_Z,
              m_r=gp.real_fact["mask"], hall_Z=gp.hall_Z, hall_Y=gp.hall_Y,
              Xt=Xt.contiguous(), eps=eps.contiguous(),
              lengthscale=hyp.lengthscale, outputscale=hyp.outputscale,
              noise_diag=hyp.noise_diag, Linv=gp.real_fact["Linv"],
              w_r=gp.real_fact["w"],
              jitter=max(hyp.jitter, 1e-6),  # safe_cholesky's f32 first try
              beta=hyp.beta, var_zero=hyp.variance_is_zero, rel_floor=1e-5,
              ty=spec.Ty)
    if md is not None:
        kw.update(close=md[0].transpose(0, 1).contiguous(),
                  ynear=md[1].transpose(0, 1).contiguous())
    return kw


def _fused_sample_hall(spec: ProblemSpec, hyp: GPHyperArrays, gp: GPState,
                       Xt, eps, md=None):
    """Hall-block GP stage (SQP iterations >= 1) through the fused kernels
    (ops/gp_hall.py): the kernel blocks from the points, the products, one
    blocked Cholesky of each bordered matrix, pathwise draw and override
    tail, every output in one call."""
    with obs.span("gp.hall.inputs"):
        kw = hall_point_inputs(spec, hyp, gp, Xt, eps, md)
    with obs.span("gp.hall.kernel"):
        dg = gp_hall.sample_hall_points(**kw)
    return dg.transpose(0, 1).reshape(spec.ns, spec.g_ny, spec.H, spec.Ty)


def _output_factor(gp: GPState, j: int) -> dict:
    return {k: v[j] for k, v in gp.real_fact.items()}


def batched_update_factor(spec: ProblemSpec, hyp: GPHyperArrays,
                          gp: GPState) -> dict:
    """Block-update factorization of every sample's hallucination buffer:
    per output, one (R_h, R_h) Schur factorization batched over samples.
    Returns the condition_update dict with leading (ns, g_ny) dimensions."""
    ufs = [exact.condition_update(
        _output_factor(gp, j), gp.real_Z, gp.hall_Z[:, j], gp.hall_Y[:, j],
        hyp.lengthscale[j], hyp.outputscale[j], hyp.noise_diag, hyp.jitter,
        spec.use_derivatives) for j in range(spec.g_ny)]
    return {k: torch.stack([u[k] for u in ufs], dim=1) for k in ufs[0]}


def _batched_posterior_incremental(spec: ProblemSpec, hyp: GPHyperArrays,
                                   gp: GPState, Xt):
    """Posterior conditioned on the real data and each sample's hall rows
    through the block update on the cached real factor: mean
    (ns, g_ny, Ht), cov (ns, g_ny, Ht, Ht)."""
    uf = batched_update_factor(spec, hyp, gp)
    means, covs = [], []
    for j in range(spec.g_ny):
        m, c = exact.predict_update(
            Xt, gp.real_Z, gp.hall_Z[:, j], _output_factor(gp, j),
            {k: v[:, j] for k, v in uf.items()}, hyp.lengthscale[j],
            hyp.outputscale[j], spec.use_derivatives)
        means.append(m)
        covs.append(c)
    return torch.stack(means, dim=1), torch.stack(covs, dim=1)


def _batched_posterior_real(spec: ProblemSpec, hyp: GPHyperArrays,
                            gp: GPState, Xt):
    """Posterior from the real factor only: mean (ns, g_ny, Ht), cov."""
    means, covs = [], []
    for j in range(spec.g_ny):
        m, c = exact.predict_real(Xt, gp.real_Z, _output_factor(gp, j),
                                  hyp.lengthscale[j],
                                  hyp.outputscale[j], spec.use_derivatives)
        means.append(m)
        covs.append(c)
    return torch.stack(means, dim=1), torch.stack(covs, dim=1)


def _batched_posterior(spec: ProblemSpec, hyp: GPHyperArrays, Z, Y, Xt):
    """Condition and predict from scratch on a given training set, per
    sample and output (``exact.factor_real``, ``exact.predict_real``).

    Args:
        Z: (ns, g_ny, M, D); Y: (ns, g_ny, M, Ty) (NaN = masked);
        Xt: (ns, ..., H, D) test points, any batch dimensions after ns.
    Returns:
        fact (dict of (ns, g_ny, ...) factors), mean (ns, g_ny, ..., Ht),
        cov (ns, g_ny, ..., Ht, Ht).
    """
    facts, means, covs = [], [], []
    for s in range(Z.shape[0]):
        for j in range(spec.g_ny):
            ls, os_ = hyp.lengthscale[j], hyp.outputscale[j]
            rf = exact.factor_real(Z[s, j], Y[s, j], ls, os_,
                                   hyp.noise_diag, hyp.jitter,
                                   spec.use_derivatives)
            m, c = exact.predict_real(Xt[s], Z[s, j], rf, ls, os_,
                                      spec.use_derivatives)
            facts.append(rf)
            means.append(m)
            covs.append(c)
    lead = (Z.shape[0], spec.g_ny)
    stack = lambda ts: torch.stack(ts).reshape(lead + ts[0].shape)  # noqa
    fact = {k: stack([f[k] for f in facts]) for k in facts[0]}
    return fact, stack(means), stack(covs)


def uses_gp_kernels(spec: ProblemSpec, device) -> bool:
    """Whether a GP stage on ``device`` runs the CUDA kernels
    (``ops/gp_sample.py``, ``ops/gp_hall.py``), which raise where they
    cannot take it, or the reference body (``posterior`` +
    ``exact.sample_with_overrides``).  CPU tensors take the reference
    body.  So does ``mean_as_dyn_sample`` on every device: its override
    needs the posterior mean, which the kernels do not return, and the
    JAX package's own gate keeps that config off its Pallas kernel for the
    same reason ("mean-as-sample needs the posterior mean returned — stays
    XLA", ``sampling_gpmpc_tpu/ops/pallas_gp.py:97``)."""
    return torch.device(device).type != "cpu" and not spec.mean_as_dyn_sample


def sample_dynamics(spec: ProblemSpec, env: Env, hyp: GPHyperArrays,
                    gp: GPState, Xt: torch.Tensor, eps: torch.Tensor,
                    hall_empty: bool = False,
                    group=None) -> Tuple[torch.Tensor, GPState]:
    """One SQP iteration's GP function-sample draw + hallucination append.

    Mirrors get_batch_gp_sensitivities (ref: src/agent.py:566-627).

    Args:
        Xt: (ns, H, D) GP inputs along the current iterate.
        eps: (ns, g_ny, H, Ty) epistemic base draws for this iteration.
        hall_empty: SQP iteration 0, whose buffer is empty: condition on the
            real factor alone; otherwise on each sample's filled buffer too.
        group: sample-axis group; ``spec.ns`` is then this shard's count,
            and the debug overrides address global sample indices.
    Returns:
        dg: (ns, g_ny, H, Ty) sampled values(+gradients); updated GPState.
    """
    H, Ty, ns = spec.H, spec.Ty, spec.ns
    oracle_only = (
        (spec.true_dyn_as_sample or spec.mean_as_dyn_sample) and ns == 1
    ) or (spec.true_dyn_as_sample and spec.mean_as_dyn_sample and ns == 2)

    def true_rows(Xt_one):
        return env.g_prior(Xt_one).transpose(0, 1)[..., :Ty]  # (g_ny, H, Ty)

    if oracle_only and not spec.mean_as_dyn_sample:
        return true_rows(Xt[0])[None], gp
    # the kernels, or the reference body by the JAX gate's rule
    # (pallas_gp.py:97, see uses_gp_kernels)
    use_fused = not oracle_only and uses_gp_kernels(spec, Xt.device)
    posterior = (_batched_posterior_real if hall_empty
                 else _batched_posterior_incremental)
    # the spans of the stage on the plain route, as the kernels' wrappers
    # name theirs: the moments, then the draw
    spans = "gp." if hall_empty else "gp.hall."
    if not (oracle_only or hall_empty):
        obs.count(obs.HALL_ROWS, gp.hall_n * Ty, tally=False)

    need_train_set = hyp.min_data_dist >= 0.0
    if need_train_set:
        Z, Y = full_train_set(spec, gp)
        dist = torch.linalg.norm(
            Xt[:, None, :, None, :] - Z[:, :, None, :, :], dim=-1)
    else:
        Z = Y = dist = None
    mean = None
    if use_fused:
        md = None
        if need_train_set:
            row_invalid = torch.isnan(Y).any(-1)                 # (ns,g_ny,M)
            dmask = torch.where(row_invalid[:, :, None, :],
                                torch.full_like(dist, float("inf")), dist)
            clo = torch.any(dmask <= hyp.min_data_dist, dim=-1)
            nearest = torch.argmin(dmask, dim=-1)                # (ns,g_ny,H)
            ynear = torch.take_along_dim(Y, nearest[..., None], dim=2)
            sh = (ns, spec.g_ny, H * Ty)
            md = (clo[..., None].expand(clo.shape + (Ty,)).reshape(sh)
                  .to(Xt.dtype), ynear.reshape(sh))
        fused = _fused_sample_empty if hall_empty else _fused_sample_hall
        dg = fused(spec, hyp, gp, Xt, eps, md=md)
    elif oracle_only:
        mean, _ = posterior(spec, hyp, gp, Xt)
        dg = torch.zeros((ns, spec.g_ny, H, Ty), dtype=Xt.dtype,
                         device=Xt.device)
    else:
        with obs.span(spans + "inputs"):
            mean, cov = posterior(spec, hyp, gp, Xt)
        with obs.span(spans + "kernel"):
            pv = exact.prior_task_variances(
                hyp.lengthscale, hyp.outputscale, Ty)[None, :, None, :]
            Xb = Xt[:, None].expand(ns, spec.g_ny, H, Xt.shape[-1])
            dg = exact.sample_with_overrides(
                Xb, Z, Y, mean, cov, eps.reshape(ns, spec.g_ny, H * Ty), hyp,
                Ty, prior_var=pv, dist=dist)

    # the overrides address GLOBAL samples 0 (and 1): under a group they
    # live on the first shard(s) (JAX agent.py:378-379)
    idx = 0
    gidx = (sample_offset(group, ns)
            + torch.arange(ns, device=Xt.device))[:, None, None, None]
    if spec.true_dyn_as_sample:
        dg = torch.where(gidx == idx, true_rows(Xt[0])[None], dg)
        idx += 1
    if spec.mean_as_dyn_sample:
        dg = torch.where(gidx == idx, mean[min(idx, ns - 1)].reshape(
            spec.g_ny, H, Ty)[None], dg)
        idx += 1

    if not oracle_only:
        with obs.span("gp.append"):
            gp = append_hall(spec, hyp, gp, Xt, dg, dist=dist)
    return dg, gp


def filter_near_duplicates(spec: ProblemSpec, hyp: GPHyperArrays, Xt, dg,
                           dist=None):
    """NaN-mask observations at new points within min_data_dist of any
    existing conditioning point (ref: src/agent.py:164-202)."""
    newZ = Xt[:, None].expand((spec.ns, spec.g_ny) + Xt.shape[1:])
    newY = dg
    if hyp.min_data_dist >= 0.0:
        too_close = torch.any(dist <= hyp.min_data_dist, dim=-1)  # (ns,g_ny,P)
        newY = torch.where(too_close[..., None],
                           torch.full_like(newY, float("nan")), newY)
    return newZ, newY


def append_hall_raw(gp: GPState, newZ, newY) -> GPState:
    """Write pre-filtered rows (ns, g_ny, P, ...) into the hallucination
    buffer at hall_n (into copies: the caller's state stays as it was)."""
    n, P = gp.hall_n, newZ.shape[2]
    hall_Z, hall_Y = gp.hall_Z.clone(), gp.hall_Y.clone()
    hall_Z[:, :, n:n + P] = newZ
    hall_Y[:, :, n:n + P] = newY
    return gp._replace(hall_Z=hall_Z, hall_Y=hall_Y, hall_n=n + P)


def append_hall(spec: ProblemSpec, hyp: GPHyperArrays, gp: GPState, Xt, dg,
                dist=None) -> GPState:
    """Append this iteration's samples to the hallucination buffer."""
    newZ, newY = filter_near_duplicates(spec, hyp, Xt, dg, dist=dist)
    return append_hall_raw(gp, newZ, newY)


def posterior_value_moments(spec: ProblemSpec, hyp: GPHyperArrays,
                            gp: GPState, Xt: torch.Tensor):
    """Posterior VALUE mean and standard deviation along an iterate, for
    the per-SQP-iterate debug plots (ref: src/solver.py:247-287 plots
    mean +/- 2 sqrt(var) of each sample's conditioned model).  Runs on the
    gp state as it ENTERS the iteration, the model each function sample is
    drawn from; an empty buffer (iteration 0) conditions on the real data
    alone through the same block update.

    Args:
        Xt: (ns, H, D) GP inputs along the current iterate.
    Returns:
        mean, std: (ns, g_ny, H) value-column posterior moments.
    """
    mean, cov = _batched_posterior_incremental(spec, hyp, gp, Xt)
    H, Ty = Xt.shape[1], spec.Ty
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    mean_v = mean.reshape(spec.ns, spec.g_ny, H, Ty)[..., 0]
    std_v = torch.sqrt(torch.clamp(
        var.reshape(spec.ns, spec.g_ny, H, Ty)[..., 0], min=0.0))
    return mean_v, std_v

