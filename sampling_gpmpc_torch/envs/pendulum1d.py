"""Pendulum1D: scalar GP on (theta, u), known kinematic integrator.

Decomposition (ref: src/environments/pendulum1D.py):
    known part   theta+ = theta + omega*dt ; omega+ = omega
    unknown part d_omega = -g*sin(theta)*dt/l + u*dt        (GP input (theta, u))
    B_d = [0, 1]^T, g_idx_inputs = [0, 2], pad_g = [0, 1, 3]
"""

from __future__ import annotations

import numpy as np
import torch

from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import (Env, grid_training_data,
                                            identity_transform)

G_IDX_INPUTS = (0, 2)
PAD_G = (0, 1, 3)


def make(spec: ProblemSpec, params: dict) -> Env:
    ep = params["env"]["params"]
    length, grav = float(ep["l"]), float(ep["g"])
    dt = spec.dt
    nx = spec.nx

    def f_val_jac(xu):
        theta, omega = xu[..., 0], xu[..., 1]
        one, zero = torch.ones_like(theta), torch.zeros_like(theta)
        # rows: [value, d/dtheta, d/domega, d/du]
        return torch.stack([
            torch.stack([theta + omega * dt, one, dt * one, zero], dim=-1),
            torch.stack([omega, zero, one, zero], dim=-1),
        ], dim=-2)

    def g_val(z):
        theta, u = z[..., 0], z[..., 1]
        return (-grav * torch.sin(theta) * dt / length + u * dt)[..., None]

    def g_prior(z):
        theta = z[..., 0]
        # (..., g_ny=1, 1+D): [value, d/dtheta, d/du]
        return torch.stack([
            g_val(z)[..., 0],
            -grav * torch.cos(theta) * dt / length,
            dt + 0 * theta,
        ], dim=-1)[..., None, :]

    B = np.zeros((nx, spec.g_ny))
    B[1, 0] = 1.0

    def B_d(xu):
        Bt = torch.as_tensor(B, dtype=xu.dtype, device=xu.device)
        return Bt.expand(xu.shape[:-1] + Bt.shape)

    def training_grid():
        opt = params["optimizer"]
        x1 = np.linspace(opt["x_min"][0], opt["x_max"][0],
                         params["env"]["n_data_x"])
        u = np.linspace(opt["u_min"][0], opt["u_max"][0],
                        params["env"]["n_data_u"])
        return grid_training_data(spec, [x1, u], g_prior)

    return Env(spec=spec, f_val_jac=f_val_jac, g_val=g_val, g_prior=g_prior,
               B_d=B_d, transform_sensitivity=identity_transform,
               training_grid=training_grid)
