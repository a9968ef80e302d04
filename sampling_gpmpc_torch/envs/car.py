"""Kinematic bicycle car, full unknown g on (phi, v, delta).

Decomposition (ref: src/environments/car_model.py):
    state (X, Y, phi, v), input (delta, a)
    known part: X+=X, Y+=Y, phi+=phi, v+ = v + a*dt
    unknown g(phi, v, delta) = [v cos(phi+b) dt, v sin(phi+b) dt, v sin(b) dt/lr],
        b = atan(lr tan(delta) / (lf+lr))
    B_d = I(4x3), g_idx_inputs = [2, 3, 4], pad_g = [0, 3, 4, 5]
"""

from __future__ import annotations

import numpy as np
import torch

from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import (Env, grid_training_data,
                                            identity_transform)

# GP input filter / jacobian scatter slots (ref: src/environments/car_model.py:11-12)
G_IDX_INPUTS = (2, 3, 4)
PAD_G = (0, 3, 4, 5)


def _beta_terms(delta, lf, lr):
    """Slip angle b(delta) and d b / d delta."""
    beta_in = lr * torch.tan(delta) / (lf + lr)
    beta = torch.arctan(beta_in)
    term = ((lr / torch.cos(delta) ** 2) / (lf + lr)) / (1 + beta_in ** 2)
    return beta, term


def make_f_val_jac(spec: ProblemSpec):
    dt = spec.dt
    nx, nu = spec.nx, spec.nu

    def f_val_jac(xu):
        out = xu.new_zeros(xu.shape[:-1] + (nx, 1 + nx + nu))
        out[..., :3, 0] = xu[..., :3]                 # X, Y, phi carried
        out[..., 3, 0] = xu[..., 3] + xu[..., 5] * dt  # v + a dt
        for r in range(nx):
            out[..., r, 1 + r] = 1.0
        out[..., 3, 6] = dt
        return out

    return f_val_jac


def make(spec: ProblemSpec, params: dict) -> Env:
    ep = params["env"]["params"]
    lf, lr = float(ep["lf"]), float(ep["lr"])
    dt = spec.dt

    def g_val(z):
        phi, v, delta = z[..., 0], z[..., 1], z[..., 2]
        beta, _ = _beta_terms(delta, lf, lr)
        return torch.stack([v * torch.cos(phi + beta) * dt,
                            v * torch.sin(phi + beta) * dt,
                            v * torch.sin(beta) * dt / lr], dim=-1)

    def g_prior(z):
        phi, v, delta = z[..., 0], z[..., 1], z[..., 2]
        beta, term = _beta_terms(delta, lf, lr)
        zero = 0 * phi
        # rows per output: [value, d/dphi, d/dv, d/ddelta]
        # (ref: car_model.py:62-99)
        c, s = torch.cos(phi + beta), torch.sin(phi + beta)
        sb = torch.sin(beta)
        return torch.stack([
            torch.stack([v * c * dt, -v * s * dt, c * dt, -v * s * dt * term],
                        dim=-1),
            torch.stack([v * s * dt, v * c * dt, s * dt, v * c * dt * term],
                        dim=-1),
            torch.stack([v * sb * dt / lr, zero, sb * dt / lr,
                         v * torch.cos(beta) * dt * term / lr], dim=-1),
        ], dim=-2)

    B = np.eye(spec.nx, spec.g_ny)

    def B_d(xu):
        Bt = torch.as_tensor(B, dtype=xu.dtype, device=xu.device)
        return Bt.expand(xu.shape[:-1] + Bt.shape)

    def training_grid():
        opt = params["optimizer"]
        n_x, n_u = params["env"]["n_data_x"], params["env"]["n_data_u"]

        def centered(lo, hi, n):      # cell-centred grids (ref: car_model.py:33-47)
            d = (hi - lo) / n
            return np.linspace(lo + d / 2, hi - d / 2, n)

        phi = centered(opt["x_min"][2], opt["x_max"][2], n_x)
        v = centered(opt["x_min"][3], opt["x_max"][3], n_x)
        delta = centered(opt["u_min"][0], opt["u_max"][0], n_u)
        return grid_training_data(spec, [phi, v, delta], g_prior)

    return Env(spec=spec, f_val_jac=make_f_val_jac(spec), g_val=g_val,
               g_prior=g_prior, B_d=B_d,
               transform_sensitivity=identity_transform,
               training_grid=training_grid)
