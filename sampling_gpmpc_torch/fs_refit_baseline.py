"""Reference-shaped float64 CPU baseline of forward-sampling reachability.

The port's copy of ``benchmarking/torch_fs_baseline.py``'s ``run``, built
on the port's ``envs`` and ``config``: the bench's ``fs_vs_baseline``
divides by it.  The reference runs this workload on torch/GPyTorch, and
EVERY rollout step rebuilds the exact GP on the real data plus the
hallucinated points so far and refactorizes the whole kernel matrix
(``agent.train_hallucinated_dynGP`` called per step, ref:
benchmarking/simulate_forward_sampling_car.py:117-137), in float64 (ref:
src/agent.py:15).  This reproduces that pipeline shape in plain torch on the
host CPU: a full refit per step, kernel algebra batched over (ns, g_ny), a
value-only GP, mu +/- beta sigma clipping, iterative conditioning and the
ancillary feedback.  Its cost grows as O(t^3) a step, the reference's
profile, where ``reachability.forward_sample_rollout`` extends a cached
factor by one point a step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sampling_gpmpc_torch.config import ProblemData, ProblemSpec
from sampling_gpmpc_torch.envs import make_env


def rbf_kernel(X1, X2, ls, os_):
    """Batched ARD-RBF: X1 (..., N, D), X2 (..., M, D) -> (..., N, M);
    ls (..., D) and os_ (...,) broadcast over the batch dimensions (the
    value-only kernel of the reference's ``use_model_without_derivatives``
    mode)."""
    d = (X1.unsqueeze(-2) - X2.unsqueeze(-3)) / ls.unsqueeze(-2).unsqueeze(-2)
    return os_[..., None, None] * torch.exp(-0.5 * (d ** 2).sum(-1))


def gp_posterior(Z, y, x, ls, os_, noise):
    """Posterior mean and variance at ONE point per batch element, from a
    full refit: Z (B, N, D), y (B, N), x (B, 1, D) -> mean (B,), var (B,).
    Factorizes the whole (N, N) kernel matrix per call."""
    K = rbf_kernel(Z, Z, ls, os_)
    K = K + noise[..., None, None] * torch.eye(Z.shape[-2], dtype=Z.dtype)
    L = torch.linalg.cholesky(K)
    kx = rbf_kernel(Z, x, ls, os_)                      # (B, N, 1)
    alpha = torch.cholesky_solve(y.unsqueeze(-1), L)    # (B, N, 1)
    mean = (kx.squeeze(-1) * alpha.squeeze(-1)).sum(-1)
    v = torch.linalg.solve_triangular(L, kx, upper=False)
    var = (os_ - (v.squeeze(-1) ** 2).sum(-1)).clamp_min(0.0)
    return mean, var


def run(params: dict, spec: ProblemSpec, data: ProblemData, ns: int,
        steps: int, U: np.ndarray, seed: int = 0) -> dict:
    """Roll ns sampled car-residual dynamics for ``steps`` steps in torch
    float64 on the CPU, under the inputs U (steps, nu).

    The semantics of ``reachability.forward_sample_rollout`` with the
    reference's per-step refit.  The draws come from a generator seeded
    with ``seed`` (the stream ``torch.manual_seed(seed)`` gives).  Returns
    the trajectories ``X_traj`` (steps + 1, ns, nx), the wall ``seconds``,
    ``steps_per_s`` (ns * steps / seconds) and ``nan_frac``.
    """
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    dt = spec.dt
    g_ny = spec.g_ny
    env = make_env(spec, params)
    Z0, Y0 = env.training_grid()                 # (N, 2), (g_ny, N, 1+D)
    Z0 = torch.as_tensor(np.asarray(Z0), dtype=f64)
    y0 = torch.as_tensor(np.asarray(Y0)[..., 0], dtype=f64)

    gp = spec.gp
    ls = torch.as_tensor(np.asarray(gp.lengthscale), dtype=f64)
    os_ = torch.as_tensor(np.asarray(gp.outputscale), dtype=f64)
    noise = torch.full((g_ny,), float(gp.noise) + float(gp.task_noises[0]),
                       dtype=f64)
    beta = float(gp.beta)

    # batched over (ns, g_ny): a shared real set, hallucinations per
    # realization
    B = ns * g_ny
    Zb = Z0.unsqueeze(0).expand(B, -1, -1).clone()       # (B, N, 2)
    yb = y0.unsqueeze(0).expand(ns, -1, -1).reshape(B, -1).clone()
    lsb = ls.unsqueeze(0).expand(ns, -1, -1).reshape(B, 2)
    osb = os_.unsqueeze(0).expand(ns, -1).reshape(B)
    nsb = noise.unsqueeze(0).expand(ns, -1).reshape(B)

    x = torch.as_tensor(np.asarray(data.start),
                        dtype=f64).expand(ns, -1).clone()
    Ut = torch.as_tensor(U[:steps], dtype=f64)
    use_fb = spec.use_feedback and data.K_fb is not None
    if use_fb:
        K_fb = torch.as_tensor(np.asarray(data.K_fb), dtype=f64)
        x_eq = torch.as_tensor(np.asarray(data.goal), dtype=f64)

    traj = [x.numpy().copy()]
    t0 = time.perf_counter()
    for t in range(steps):
        u = Ut[t].expand(ns, -1)
        if use_fb:
            u = u - (x_eq.unsqueeze(0) - x) @ K_fb.T
        # the GP inputs (phi, delta) of each realization
        zq = torch.stack([x[:, 2], u[:, 0]], dim=1)          # (ns, 2)
        zb = zq.unsqueeze(1).expand(ns, g_ny, 2).reshape(B, 1, 2)
        # the reference rebuilds and refactorizes the whole GP here
        mean, var = gp_posterior(Zb, yb, zb, lsb, osb, nsb)
        sd = var.sqrt()
        samp = mean + sd * torch.randn(B, dtype=f64, generator=gen)
        samp = torch.clamp(samp, mean - beta * sd, mean + beta * sd)
        samp = torch.where(var <= float(gp.variance_is_zero), mean, samp)

        g = samp.reshape(ns, g_ny)
        # x+ = f_known + v I(4x3) g  (ref: car_model_residual.py:184-209)
        v = x[:, 3]
        x = torch.stack([
            x[:, 0] + v * g[:, 0],
            x[:, 1] + v * g[:, 1],
            x[:, 2] + v * g[:, 2],
            x[:, 3] + u[:, 1] * dt,
        ], dim=1)
        traj.append(x.numpy().copy())
        # iterative conditioning: append the sampled values
        Zb = torch.cat([Zb, zb], dim=1)
        yb = torch.cat([yb, samp.unsqueeze(1)], dim=1)
    seconds = time.perf_counter() - t0
    X = np.stack(traj)
    return {"X_traj": X, "seconds": seconds,
            "steps_per_s": ns * steps / seconds,
            "nan_frac": float(np.isnan(X).mean())}
