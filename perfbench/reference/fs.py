"""Forward-sampling reachability, plain: realizations of the GP dynamics
propagated under a fixed plan, each step conditioning every realization on
its own sampled values.

A frozen plain counterpart of the measured program's forward-sampling
rollout (the paper's ``benchmarking/simulate_forward_sampling_car.py``,
lines 117-138), in any dtype on any device: a value-only GP per output
(ARD RBF kernel, the observation noise on the diagonal) on the real data;
at step t a realization's posterior at its GP input is formed from scratch
on the real data plus its own rows 0..t-1 (no incremental factor); the
draw is the pathwise one from the base draws with the sampling pipeline of
``gp.sample``; the ancillary feedback u = U_t - K (x_eq - x); the plant's
step x+ = f(x, u) + B_d(x) g (``problem.Plant.propagate``).  ``Model``
holds what is worked out once from the configuration file, whose
``replayed_U`` holds the plan the rollout replays.  Imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import gp, problem

REPLAYED = "replayed_U"     # the configuration file's key of the plan


@dataclasses.dataclass
class Model:
    spec: problem.Spec
    plant: problem.Plant
    ls: torch.Tensor          # (g_ny, D)
    os_: torch.Tensor         # (g_ny,)
    noise: float              # the value observations' noise variance
    Z: torch.Tensor           # (N, D) real training inputs
    Y: torch.Tensor           # (g_ny, N) real value observations
    start: torch.Tensor       # (nx,)
    U: torch.Tensor           # (T, nu) the replayed plan
    K: torch.Tensor           # (nu, nx) ancillary feedback gain
    x_eq: torch.Tensor        # (nx,) its equilibrium
    T: int                    # propagation steps
    device: torch.device
    dtype: torch.dtype

    @classmethod
    def from_file(cls, path: str, device, dtype) -> "Model":
        params = problem.load(path)
        spec = problem.make_spec(params, rollout=True)
        if spec.Ty != 1 or not spec.use_feedback:
            raise ValueError("the rollout reference takes a value-only GP "
                             "with the ancillary feedback")
        plant = problem.make_plant(spec, params)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64),  # noqa
                                      dtype=dtype, device=device)
        T = int(params["common"]["num_MPC_itrs"])
        X, Y = plant.training_data()
        tt = params["optimizer"]["terminal_tightening"]
        return cls(spec, plant, t(spec.lengthscale), t(spec.outputscale),
                   float(spec.noise_diag[0]), t(X), t(Y[:, :, 0]),
                   t(params["env"]["start"]),
                   t(np.asarray(params[REPLAYED])[:T]), t(tt["K"]),
                   t(params["env"]["goal_state"]), T, torch.device(device),
                   dtype)

    def prior_std(self):
        """(g_ny,) prior standard deviation of each output."""
        return torch.sqrt(self.os_)


def rbf(X, Z, ls, os_):
    """(..., N, M) ARD RBF kernel of X (..., N, D) and Z (..., M, D)."""
    d = (X[..., :, None, :] - Z[..., None, :, :]) / ls
    return os_ * torch.exp(-0.5 * torch.sum(d * d, dim=-1))


def inputs(m: Model, x, t: int):
    """The input with the ancillary feedback, (..., nu), and the GP input,
    (..., D), of states x (..., nx) at step t."""
    u = m.U[t] - (m.x_eq - x) @ m.K.T
    return u, torch.cat([x, u], dim=-1)[..., list(m.spec.g_idx_inputs)]


def posterior(m: Model, Zh, Yh, z):
    """Posterior mean and variance, (..., g_ny) each, at z (..., D) of
    every output, conditioned on the real data and the rows Zh (..., n,
    D), Yh (..., g_ny, n), from scratch: one Cholesky factor of the
    (N + n) points' covariance per output and realization."""
    s = m.spec
    lead = z.shape[:-1]
    Zall = torch.cat([m.Z.expand(lead + m.Z.shape), Zh], dim=-2)
    eye = torch.eye(Zall.shape[-2], dtype=m.dtype, device=m.device)
    means, variances = [], []
    for j in range(s.g_ny):
        y = torch.cat([m.Y[j].expand(lead + m.Y[j].shape), Yh[..., j, :]],
                      dim=-1)
        L = gp.safe_cholesky(rbf(Zall, Zall, m.ls[j], m.os_[j])
                             + m.noise * eye, s.jitter)
        k = rbf(z[..., None, :], Zall, m.ls[j], m.os_[j])     # (..., 1, N+n)
        v = torch.linalg.solve_triangular(L, k.transpose(-1, -2), upper=False)
        w = torch.linalg.solve_triangular(L, y[..., None], upper=False)
        means.append((v.transpose(-1, -2) @ w)[..., 0, 0])
        variances.append(m.os_[j] - (v.transpose(-1, -2) @ v)[..., 0, 0])
    return torch.stack(means, dim=-1), torch.stack(variances, dim=-1)


def draw(m: Model, mean, var, eps):
    """The sampled values (..., g_ny) from the posterior mean and variance
    and the base draws eps (..., g_ny), by ``gp.sample``'s pipeline (a
    one-point draw: the variance floor, the clip to mean +/- beta std)."""
    s = m.spec
    y = gp.sample(mean[..., None], var[..., None, None], eps[..., None], 1, 1,
                  s.beta, s.jitter, s.variance_is_zero, m.os_[:, None, None])
    return y[..., 0, 0]


def rollout(m: Model, eps):
    """Free-running rollout of n realizations from the start under the
    plan on base draws eps (T, n, g_ny, 1, 1): the states (T+1, n, nx),
    the GP inputs (n, T, D) and the sampled values (n, g_ny, T)."""
    s, n = m.spec, eps.shape[1]
    x = m.start.expand(n, s.nx)
    Zh = x.new_zeros((n, m.T, s.D))
    Yh = x.new_zeros((n, s.g_ny, m.T))
    X = [x]
    for t in range(m.T):
        u, z = inputs(m, x, t)
        mean, var = posterior(m, Zh[:, :t], Yh[..., :t], z)
        y = draw(m, mean, var, eps[t].reshape(n, s.g_ny).to(m.dtype))
        Zh[:, t], Yh[..., t] = z, y
        x = m.plant.propagate(x, u, y)
        X.append(x)
    return torch.stack(X), Zh, Yh
