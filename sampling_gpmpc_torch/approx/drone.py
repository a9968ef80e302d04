"""Planar-quadrotor (drone) model of the approximate sampling MPC.

Port of ``sampling_gpmpc_tpu/approx/drone.py`` (ref:
extra/approx_sampling_mpc/src/environments/drone.py): fully-unknown
discrete dynamics modeled by per-output Bayesian linear regression over
hand-crafted feature maps.  States (px, py, phi, vx, vy, phidot), inputs
(u1, u2).  The dynamics and the feature maps take tensors with any leading
batch dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DroneModel:
    params: dict
    nx: int = 6
    nu: int = 2

    @property
    def phys(self):
        return self.params["env"]["params"]

    def discrete_dyn(self, x, u):
        """True discrete dynamics (ref: drone.py:125-144)."""
        p = self.phys
        m, l, g, d, J = (p["m"], p["l"], p["g"], p["d"], p["J"])
        dt = self.params["optimizer"]["dt"]
        px, py, phi, vx, vy, pd = x.unbind(-1)
        u1, u2 = u.unbind(-1)
        c, s = torch.cos(phi), torch.sin(phi)
        return torch.stack([
            px + (vx * c - vy * s) * dt,
            py + (vx * s + vy * c) * dt,
            phi + pd * dt,
            vx + (vy * pd - g * s + c * d) * dt,
            vy + (-vx * pd - g * c + u1 / m + u2 / m - s * d) * dt,
            pd + (u1 - u2) * l / J * dt,
        ], dim=-1)

    def features(self) -> List[Callable]:
        """Per-output feature maps phi_j(x, u) (ref: drone.py:333-349)."""
        def f_px(x, u):
            return torch.stack([x[..., 0], x[..., 3] * torch.cos(x[..., 2]),
                                x[..., 4] * torch.sin(x[..., 2])], dim=-1)

        def f_py(x, u):
            return torch.stack([x[..., 1], x[..., 3] * torch.sin(x[..., 2]),
                                x[..., 4] * torch.cos(x[..., 2])], dim=-1)

        def f_phi(x, u):
            return torch.stack([x[..., 2], x[..., 5]], dim=-1)

        def f_vx(x, u):
            return torch.stack([x[..., 3], x[..., 4] * x[..., 5],
                                torch.sin(x[..., 2]), torch.cos(x[..., 2])],
                               dim=-1)

        def f_vy(x, u):
            return torch.stack([x[..., 4], x[..., 3] * x[..., 5],
                                torch.cos(x[..., 2]), torch.sin(x[..., 2]),
                                u[..., 0], u[..., 1]], dim=-1)

        def f_phidot(x, u):
            return torch.stack([x[..., 5], u[..., 0], u[..., 1]], dim=-1)

        return [f_px, f_py, f_phi, f_vx, f_vy, f_phidot]

    def gt_weights(self) -> List[np.ndarray]:
        """Ground-truth feature weights (ref: drone.py:146-160)."""
        p = self.phys
        m, l, g, d, J = (p["m"], p["l"], p["g"], p["d"], p["J"])
        dt = self.params["optimizer"]["dt"]
        return [np.array(w) for w in [
            [1.0, dt, -dt],
            [1.0, dt, dt],
            [1.0, dt],
            [1.0, dt, -g * dt, d * dt],
            [1.0, -dt, -g * dt, -d * dt, dt / m, dt / m],
            [1.0, dt * l / J, -dt * l / J],
        ]]

    def training_grid(self) -> Tuple[np.ndarray, np.ndarray]:
        """Tensor-grid training data over (x, u) (ref: drone.py:29-64),
        its targets from the true dynamics in float64 on the host."""
        opt = self.params["optimizer"]
        n_x = self.params["env"]["n_data_x"]
        n_u = self.params["env"]["n_data_u"]
        axes = [np.linspace(opt["x_min"][i], opt["x_max"][i], n_x)
                for i in range(self.nx)]
        axes += [np.linspace(opt["u_min"][i], opt["u_max"][i], n_u)
                 for i in range(self.nu)]
        mesh = np.meshgrid(*axes, indexing="ij")
        XU = np.stack([m.reshape(-1) for m in mesh], axis=1)
        z = torch.as_tensor(XU, dtype=torch.float64)
        Y = self.discrete_dyn(z[:, :self.nx], z[:, self.nx:]).numpy()
        return XU, Y

    def path_generator(self, st: int, length: int = None) -> np.ndarray:
        """Heart-curve reference path (ref: drone.py:626-638)."""
        if length is None:
            length = self.params["optimizer"]["H"] + 1
        s = np.linspace(0, 4 * np.pi, 1000)
        t = s[st:st + length]
        x = 8 * np.sin(t) ** 3 / 1.5 + 1
        y = (10 * np.cos(t) - 5 * np.cos(2 * t) - 2 * np.cos(3 * t)
             - np.cos(4 * t)) / 2
        return np.stack([x, y], axis=1)

    def obstacles(self) -> np.ndarray:
        obs = self.params["env"].get("obstacles", {}) or {}
        return np.asarray([obs[k] for k in obs],
                          dtype=np.float64).reshape(-1, 3)
