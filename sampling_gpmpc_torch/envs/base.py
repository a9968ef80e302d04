"""Environment protocol: the dynamics decomposition as batched torch functions.

Every environment implements the decomposition of the reference
(SURVEY §2.1-C12):

    x_{k+1} = f_known(x, u) + B_d(x) @ g(x_g, u_g)

where ``g`` is the unknown part modeled by the GP, evaluated on the filtered
inputs ``(x, u)[g_idx_inputs]``.  The JAX package writes per-point functions
and vmaps them; here every function takes any number of leading batch
dimensions, written out.

Conventions (trailing dimensions):
    xu        : (..., nx+nu) concatenated state-input
    f_val_jac : (..., nx, 1+nx+nu) — per next-state row [value, d/dx, d/du]
    g_val     : (..., D) -> (..., g_ny)
    g_prior   : (..., D) -> (..., g_ny, 1+D) analytic value+gradient
    B_d       : (..., nx+nu) -> (..., nx, g_ny)
    transform_sensitivity : sampled (..., g_ny, Ty) GP rows -> (..., g_ny, P)
                rows scattered into the pad_g slots of the jacobian layout
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from sampling_gpmpc_torch.config import ProblemSpec


@dataclasses.dataclass(frozen=True)
class Env:
    spec: ProblemSpec
    f_val_jac: Callable
    g_val: Callable
    g_prior: Callable
    B_d: Callable
    transform_sensitivity: Callable
    training_grid: Callable        # () -> (X (N, D), Y (g_ny, N, 1+D)) numpy
    B_d_dyn: Callable = None       # true-dynamics disturbance matrix

    def __post_init__(self):
        if self.B_d_dyn is None:
            object.__setattr__(self, "B_d_dyn", self.B_d)

    def g_inputs(self, xu: torch.Tensor) -> torch.Tensor:
        """Filter (..., nx+nu) points down to the GP input dims."""
        return xu[..., list(self.spec.g_idx_inputs)]

    def discrete_dyn(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """True plant step for (..., nx) states and (..., nu) inputs."""
        xu = torch.cat([x, u], dim=-1)
        f = self.f_val_jac(xu)[..., 0]
        g = self.g_val(self.g_inputs(xu))
        return f + (self.B_d_dyn(xu) @ g[..., None])[..., 0]

    def assemble_val_jac(self, xu: torch.Tensor,
                         dg: torch.Tensor) -> torch.Tensor:
        """Known jacobian plus the (transformed, padded) GP rows.

        Args:
            xu: (..., nx+nu) linearization points.
            dg: (..., g_ny, Ty) sampled GP value(+gradient) rows.
        Returns:
            (..., nx, 1+nx+nu) combined [value, d/dx, d/du] rows.
        """
        spec = self.spec
        tg = self.transform_sensitivity(dg, xu)
        pad = tg.new_zeros(tg.shape[:-1] + (1 + spec.nx + spec.nu,))
        pad[..., list(spec.pad_g)] = tg
        return self.f_val_jac(xu) + self.B_d(xu) @ pad


def identity_transform(dg: torch.Tensor, xu: torch.Tensor) -> torch.Tensor:
    """Pass-through sensitivity transform."""
    return dg


def grid_training_data(spec: ProblemSpec, axes,
                        g_prior) -> Tuple[np.ndarray, np.ndarray]:
    """Tensor-grid prior training data (ref: *.initial_training_data).

    Evaluated in float64 on the CPU; the caller moves the result.

    Returns:
        X: (N, D); Y: (g_ny, N, 1+D) with gradient entries NaN-ed out when
        the config says training data has no derivatives.
    """
    mesh = np.meshgrid(*axes, indexing="ij")
    X = np.stack([m.reshape(-1) for m in mesh], axis=1)
    Y = g_prior(torch.as_tensor(X, dtype=torch.float64)).numpy()  # (N,g_ny,1+D)
    Y = np.transpose(Y, (1, 0, 2)).copy()
    if not spec.train_data_has_derivatives:
        Y[:, :, 1:] = np.nan
    return X, Y
