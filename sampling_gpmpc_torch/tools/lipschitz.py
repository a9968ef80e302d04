"""Closed-loop Lipschitz / contraction constant estimation.

Replaces extra/Lipschitz_constant.py: the YAML constant
``agent.tight.Lipschitz`` is the maximal P-weighted closed-loop Jacobian
norm over a state-input grid,

    L = max_{x, u} || P^{1/2} (A(x,u) + B(x,u) K) P^{-1/2} ||_2 ,

with (A, B) the true-dynamics Jacobians: ``torch.func.jacfwd`` of the
environment's plant step, under ``torch.func.vmap`` over the grid.  (They
equal the analytic prior's Jacobian rows, which the JAX package reads, to
rounding.)
"""

from __future__ import annotations

import numpy as np
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.envs.base import Env


def true_jacobians(env: Env, xu: torch.Tensor):
    """(A, B) of the true plant step at the (N, nx+nu) points ``xu``:
    (N, nx, nx) and (N, nx, nu)."""
    nx = env.spec.nx
    J = torch.func.vmap(torch.func.jacfwd(
        lambda p: env.discrete_dyn(p[:nx], p[nx:])))(xu)
    return J[..., :nx], J[..., nx:]


def closed_loop_jacobian(env: Env, xu: torch.Tensor, K: torch.Tensor):
    """A + B K at one (nx+nu,) point from the true dynamics.

    K follows the config convention (the controller applies
    u = -K(x_eq - x), so du/dx = +K; the YAML gains are the *negated*
    DARE gains, e.g. params_pendulum1D_samples.yaml terminal_tightening.K).
    """
    A, B = true_jacobians(env, xu[None])
    return A[0] + B[0] @ K


def _psd_sqrt(P: torch.Tensor):
    """P^{1/2} and P^{-1/2} of a symmetric positive definite P."""
    w, V = torch.linalg.eigh(P)
    return ((V * torch.sqrt(w)) @ V.T, (V / torch.sqrt(w)) @ V.T)


def estimate_lipschitz(env: Env, P, K, x_grid, u_grid, device=None,
                       dtype=torch.float64) -> float:
    """Max weighted spectral norm over the grid.

    Args:
        P: (nx, nx) terminal metric; K: (nu, nx) feedback gain.
        x_grid: (N, nx) state samples; u_grid: (N, nu) input samples.
        device: where the Jacobians and norms run (CUDA unless given).
    """
    dev = setup.resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    P_half, P_half_inv = _psd_sqrt(t(P))
    K = t(K)
    closed = torch.func.vmap(lambda xu: closed_loop_jacobian(env, xu, K))(
        torch.cat([t(x_grid), t(u_grid)], dim=-1))
    W = P_half @ closed @ P_half_inv
    return float(torch.linalg.matrix_norm(W, ord=2).max())


def grid_around(lo, hi, n) -> np.ndarray:
    """Tensor grid between lo and hi with n points per dim, flattened."""
    axes = [np.linspace(l, h, n) for l, h in zip(lo, hi)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1)
