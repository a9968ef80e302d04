"""Residual bicycle car (``bicycle_Bdx``): velocity-factored unknown part.

Decomposition (ref: src/environments/car_model_residual.py):
    g(phi, delta) = [cos(phi+b) dt, sin(phi+b) dt, sin(b) dt/lr]  (no v)
    B_d(x) = v * I(4x3)   — state-dependent disturbance input matrix
    g_idx_inputs = [2, 4], pad_g = [0, 3, 4, 5]

The sampled sensitivity (g_ny, [val, d/dphi, d/ddelta]) becomes
(g_ny, [val, d/dphi, d/dv, d/ddelta]) by scaling with v and injecting the
d/dv column (the raw value, since the full residual is v*g), so the
jacobian assembly uses a constant identity B_d and the true dynamics
``B_d_dyn`` = v * I (ref: car_model_residual.py:184-186, 211-224).
"""

from __future__ import annotations

import numpy as np
import torch

from sampling_gpmpc_torch import obs
from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.envs.base import Env, grid_training_data
from sampling_gpmpc_torch.envs.car import _beta_terms, make_f_val_jac

# GP input filter / jacobian scatter slots
# (ref: src/environments/car_model_residual.py:14-16)
G_IDX_INPUTS = (2, 4)
PAD_G = (0, 3, 4, 5)


def make(spec: ProblemSpec, params: dict) -> Env:
    ep = params["env"]["params"]
    lf, lr = float(ep["lf"]), float(ep["lr"])
    dt = spec.dt

    def g_val(z):
        phi, delta = z[..., 0], z[..., 1]
        beta, _ = _beta_terms(delta, lf, lr)
        return torch.stack([torch.cos(phi + beta) * dt,
                            torch.sin(phi + beta) * dt,
                            torch.sin(beta) * dt / lr], dim=-1)

    def g_prior(z):
        phi, delta = z[..., 0], z[..., 1]
        beta, term = _beta_terms(delta, lf, lr)
        zero = 0 * phi
        c, s = torch.cos(phi + beta), torch.sin(phi + beta)
        # rows per output: [value, d/dphi, d/ddelta]
        # (ref: car_model_residual.py:62-99)
        return torch.stack([
            torch.stack([c * dt, -s * dt, -s * dt * term], dim=-1),
            torch.stack([s * dt, c * dt, c * dt * term], dim=-1),
            torch.stack([torch.sin(beta) * dt / lr, zero,
                         torch.cos(beta) * dt * term / lr], dim=-1),
        ], dim=-2)

    eye = np.eye(spec.nx, spec.g_ny)

    def B_d_const(xu):
        # jacobian-assembly matrix: constant identity; the v-scaling is done
        # by transform_sensitivity (ref: car_model_residual.py:26,211-224);
        # a copy from pageable host memory: the host waits for the device
        obs.count(obs.SYNCS, "envs.car_residual.B_d_const", tally=False)
        E = torch.as_tensor(eye, dtype=xu.dtype, device=xu.device)
        return E.expand(xu.shape[:-1] + E.shape)

    def B_d_dyn(xu):
        # true-dynamics matrix B_d(x) = v * I (a synchronising copy, as above)
        obs.count(obs.SYNCS, "envs.car_residual.B_d_dyn", tally=False)
        E = torch.as_tensor(eye, dtype=xu.dtype, device=xu.device)
        return xu[..., 3, None, None] * E

    def transform_sensitivity(dg, xu):
        """(..., g_ny, Ty) -> (..., g_ny, 4):
        [v*val, v*dphi, val, v*ddelta]."""
        v = xu[..., 3, None]                              # (..., 1)
        out = dg.new_zeros(dg.shape[:-1] + (4,))
        out[..., 0] = v * dg[..., 0]
        out[..., 2] = dg[..., 0]
        if dg.shape[-1] > 1:
            out[..., 1] = v * dg[..., 1]
            out[..., 3] = v * dg[..., 2]
        # value-only GP (Ty = 1, the forward-sampling path): the gradient
        # slots stay zero
        return out

    def training_grid():
        opt = params["optimizer"]
        n_x, n_u = params["env"]["n_data_x"], params["env"]["n_data_u"]
        # plain endpoints grid (ref: car_model_residual.py:36-50, d*=0)
        phi = np.linspace(opt["x_min"][2], opt["x_max"][2], n_x)
        delta = np.linspace(opt["u_min"][0], opt["u_max"][0], n_u)
        return grid_training_data(spec, [phi, delta], g_prior)

    return Env(spec=spec, f_val_jac=make_f_val_jac(spec), g_val=g_val,
               g_prior=g_prior, B_d=B_d_const,
               transform_sensitivity=transform_sensitivity,
               training_grid=training_grid, B_d_dyn=B_d_dyn)
