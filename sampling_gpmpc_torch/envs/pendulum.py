"""Pendulum (2D GP): fully-unknown dynamics, B_d = I.

Decomposition (ref: src/environments/pendulum.py):
    known part zero; the GP models the full discrete map on (x1, x2, u):
        x1+ = x1 + x2*dt
        x2+ = x2 - g*sin(x1)*dt/l + u*dt/l^2
    g_idx_inputs = [0, 1, 2], pad_g = [0, 1, 2, 3]
"""

from __future__ import annotations

import numpy as np
import torch

from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import (Env, grid_training_data,
                                            identity_transform)

G_IDX_INPUTS = (0, 1, 2)
PAD_G = (0, 1, 2, 3)


def make(spec: ProblemSpec, params: dict) -> Env:
    ep = params["env"]["params"]
    length, grav = float(ep["l"]), float(ep["g"])
    dt = spec.dt
    nx = spec.nx

    def f_val_jac(xu):
        return xu.new_zeros(xu.shape[:-1] + (nx, 1 + spec.nx + spec.nu))

    def g_val(z):
        x1, x2, u = z[..., 0], z[..., 1], z[..., 2]
        return torch.stack([
            x1 + x2 * dt,
            x2 - grav * torch.sin(x1) * dt / length + u * dt / (length * length),
        ], dim=-1)

    def g_prior(z):
        x1 = z[..., 0]
        one, zero = torch.ones_like(x1), torch.zeros_like(x1)
        v = g_val(z)
        # (..., g_ny=2, 1+D): rows [value, d/dx1, d/dx2, d/du] per output
        return torch.stack([
            torch.stack([v[..., 0], one, dt * one, zero], dim=-1),
            torch.stack([v[..., 1], -grav * torch.cos(x1) * dt / length, one,
                         dt / (length * length) * one], dim=-1),
        ], dim=-2)

    B = np.eye(nx, spec.g_ny)

    def B_d(xu):
        Bt = torch.as_tensor(B, dtype=xu.dtype, device=xu.device)
        return Bt.expand(xu.shape[:-1] + Bt.shape)

    def training_grid():
        opt = params["optimizer"]
        n_x, n_u = params["env"]["n_data_x"], params["env"]["n_data_u"]
        x1 = np.linspace(opt["x_min"][0], opt["x_max"][0], n_x)
        x2 = np.linspace(opt["x_min"][1], opt["x_max"][1], n_x)
        u = np.linspace(opt["u_min"][0], opt["u_max"][0], n_u)
        return grid_training_data(spec, [x1, x2, u], g_prior)

    return Env(spec=spec, f_val_jac=f_val_jac, g_val=g_val, g_prior=g_prior,
               B_d=B_d, transform_sensitivity=identity_transform,
               training_grid=training_grid)
