"""Bayesian linear regression over feature maps (approx sampling MPC).

Port of ``sampling_gpmpc_tpu/approx/blr.py``.  Per output j the dynamics
are x+_j = phi_j(x, u) @ w_j with a Gaussian weight posterior from
ridge-regularized least squares (ref:
extra/approx_sampling_mpc/src/agent.py:793-885):

    A = Phi'Phi + lambda I,   mu = A^{-1} Phi'y,   Sigma = noise_var A^{-1}.

The sufficient statistics (A, b) stay on the host in float64 numpy, as in
the JAX package; the posterior goes to the device.  Weight samples come
from standard-normal draws the caller passes in (``sample_weights``), so
the JAX package's ``jax.random`` draws can be replayed.  Feature dims
differ per output, so weights are stored zero-padded to the max dim with a
mask.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class BLRPosterior(NamedTuple):
    mu: torch.Tensor      # (g_ny, F) zero-padded means
    chol: torch.Tensor    # (g_ny, F, F) padded Cholesky factors of Sigma
    mask: torch.Tensor    # (g_ny, F) valid-feature mask


class BLRStats(NamedTuple):
    """Host-side per-output sufficient statistics of the weight posterior:
    A_j = Phi_j'Phi_j + lambda I, b_j = Phi_j'y_j (a new observation is a
    rank-1 update, ``stats_update``)."""
    A: tuple     # per-output (F_j, F_j) numpy
    b: tuple     # per-output (F_j,) numpy


def _phi(f, x, u) -> np.ndarray:
    """A feature map on host float64 inputs, as numpy."""
    return f(torch.as_tensor(np.asarray(x), dtype=torch.float64),
             torch.as_tensor(np.asarray(u), dtype=torch.float64)).numpy()


def stats_fit(feats: List, X: np.ndarray, Y: np.ndarray,
              lambda_reg: float) -> BLRStats:
    """Sufficient statistics from a batch dataset: X (N, nx+nu) training
    inputs, Y (N, g_ny) next-state targets."""
    nx = Y.shape[1]
    As, bs = [], []
    for j, f in enumerate(feats):
        Phi = _phi(f, X[:, :nx], X[:, nx:])
        As.append(Phi.T @ Phi + lambda_reg * np.eye(Phi.shape[1]))
        bs.append(Phi.T @ Y[:, j])
    return BLRStats(A=tuple(As), b=tuple(bs))


def stats_update(stats: BLRStats, feats: List, x, u,
                 y: np.ndarray) -> BLRStats:
    """Absorb ONE observed transition (x, u) -> y (rank-1 per output)."""
    phis = [_phi(f, x, u) for f in feats]
    return BLRStats(
        A=tuple(A + np.outer(p, p) for A, p in zip(stats.A, phis)),
        b=tuple(b + p * y[j] for j, (b, p) in enumerate(
            zip(stats.b, phis))))


def posterior_from_stats(stats: BLRStats, noise_var: float, device,
                         dtype=torch.float64) -> BLRPosterior:
    """Padded weight posterior mu = A^-1 b, Sigma = noise_var A^-1 (host
    float64, then to ``device`` in ``dtype``)."""
    per = []
    F = 0
    for A, b in zip(stats.A, stats.b):
        mu = np.linalg.solve(A, b)
        Sigma = noise_var * np.linalg.inv(A)
        L = np.linalg.cholesky(Sigma + 1e-18 * np.eye(A.shape[0]))
        per.append((mu, L))
        F = max(F, A.shape[0])
    mus, chols, masks = [], [], []
    for mu, L in per:
        d = mu.shape[0]
        mu_p = np.zeros(F)
        mu_p[:d] = mu
        L_p = np.zeros((F, F))
        L_p[:d, :d] = L
        m = np.zeros(F)
        m[:d] = 1.0
        mus.append(mu_p)
        chols.append(L_p)
        masks.append(m)
    t = lambda a: torch.as_tensor(np.stack(a), dtype=dtype, device=device)
    return BLRPosterior(mu=t(mus), chol=t(chols), mask=t(masks))


def fit(feats: List, X: np.ndarray, Y: np.ndarray, lambda_reg: float,
        noise_var: float, device, dtype=torch.float64) -> BLRPosterior:
    """Fit per-output weight posteriors (batch convenience wrapper)."""
    return posterior_from_stats(stats_fit(feats, X, Y, lambda_reg),
                                noise_var, device, dtype)


def sample_weights(post: BLRPosterior, z: torch.Tensor) -> torch.Tensor:
    """(n, g_ny, F) weight draws w = mu + L z from standard-normal draws z
    (n, g_ny, F) (ref: agent.py:821-848)."""
    return post.mu[None] + torch.einsum("jab,njb->nja", post.chol, z)


def make_dynamics(feats, nx: int):
    """Weight-parameterized dynamics step and value+jacobian rows.

    Returns:
        step(x, u, W): next state for weights W (..., g_ny, F), any leading
            batch dimensions shared by x, u and W.
        val_jac(x, u, W): (nx, 1+nx+nu) rows [value, d/dx, d/du] of one
            (x, u) (forward-mode derivatives, as the JAX package's jacfwd).
    """
    def step(x, u, W):
        batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1],
                                       W.shape[:-2])
        x = x.expand(batch + x.shape[-1:])
        u = u.expand(batch + u.shape[-1:])
        outs = []
        for j, f in enumerate(feats):
            phi = f(x, u)
            outs.append((phi * W[..., j, :phi.shape[-1]]).sum(-1))
        return torch.stack(outs, dim=-1)

    def val_jac(x, u, W):
        val = step(x, u, W)
        Jx = torch.func.jacfwd(step, argnums=0)(x, u, W)
        Ju = torch.func.jacfwd(step, argnums=1)(x, u, W)
        return torch.cat([val[:, None], Jx, Ju], dim=1)

    return step, val_jac


def rollout(step, x0, U, W):
    """Propagate weights W from x0 under inputs U (H, nu): (..., H+1, nx),
    batched over leading dimensions of x0 and W."""
    X = [x0]
    for k in range(U.shape[0]):
        X.append(step(X[-1], U[k], W))
    return torch.stack(torch.broadcast_tensors(*X), dim=-2)
