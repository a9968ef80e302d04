"""The problem from a configuration file: sizes, cost, bounds, plant, GP data.

A frozen plain copy of what the measured program derives from the same
file (its configuration loader, the plants the benchmark's configurations
name, the reachable-set tightening and the OCP data), kept here so that
the reference works everything out again from the file and imports
nothing of the program.  Only what the benchmark's configurations use is
kept: the Pendulum1D, bicycle and residual bicycle (``bicycle_Bdx``, with
its value-only GP, the forward-sampling rollout's) plants, the expected
cost, no input generation (a forward-sampling rollout replays a fixed
plan), no dynamics rejection, no sample overrides and no minimum data
distance; anything else raises.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """Static sizes and switches of one configuration."""

    env_name: str
    nx: int
    nu: int
    g_ny: int
    g_nx: int
    g_nu: int
    ns: int
    H: int
    dt: float
    Ty: int
    g_idx_inputs: Tuple[int, ...]
    pad_g: Tuple[int, ...]
    max_sqp_iter: int
    tol_nlp: float
    levenberg_marquardt: float
    shift_soln: bool
    use_tightening: bool
    use_feedback: bool
    has_terminal_ellipse: bool
    n_ellipses: int
    lengthscale: Tuple[Tuple[float, ...], ...]
    outputscale: Tuple[float, ...]
    noise_diag: Tuple[float, ...]
    beta: float
    jitter: float
    variance_is_zero: float

    @property
    def D(self) -> int:
        return self.g_nx + self.g_nu


# GP input filter and jacobian scatter slots of each plant
PLANTS = {"Pendulum1D": ((0, 2), (0, 1, 3)),
          "bicycle": ((2, 3, 4), (0, 3, 4, 5)),
          "bicycle_Bdx": ((2, 4), (0, 3, 4, 5))}


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def make_spec(params: dict, rollout: bool = False) -> Spec:
    """The sizes and switches of a configuration; with ``rollout``, of a
    forward-sampling rollout (``fs.py``), which replays a fixed plan, so
    that the MPC's input generation does not arise, and which takes the
    value-only GP and the residual bicycle."""
    ag, opt, env = params["agent"], params["optimizer"], params["env"]
    dyn = env["dynamics"]
    if dyn not in PLANTS:
        raise ValueError(f"the reference has no plant {dyn!r}")
    unsupported = {
        "agent.input_generation": (ag.get("input_generation", False)
                                   and not rollout),
        "agent.mean_as_dyn_sample": ag.get("mean_as_dyn_sample", False),
        "agent.true_dyn_as_sample": ag.get("true_dyn_as_sample", False),
        "common.dynamics_rejection":
            params["common"].get("dynamics_rejection", False),
        # the MPC reference's GP takes derivative tasks and its
        # linearization no state-dependent B_d: a rollout's alone here
        "env.use_model_without_derivatives": (
            env.get("use_model_without_derivatives", False) and not rollout),
        "env.dynamics bicycle_Bdx": dyn == "bicycle_Bdx" and not rollout,
        "env.train_data_has_derivatives":
            env.get("train_data_has_derivatives", False),
        "optimizer.cost": opt.get("cost", "expected") != "expected",
        "agent.Dyn_gp_min_data_dist >= 0":
            float(ag["Dyn_gp_min_data_dist"]) >= 0.0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the reference does not implement {bad}")
    g_ny = ag["g_dim"]["ny"]
    g_nx, g_nu = ag["g_dim"]["nx"], ag["g_dim"]["nu"]
    D = g_nx + g_nu
    Ty = 1 if env.get("use_model_without_derivatives", False) else 1 + D
    ls = np.asarray(ag["Dyn_gp_lengthscale"]["both"], dtype=np.float64)
    ls = np.broadcast_to(ls.reshape(-1, D)[-g_ny:] if ls.size == g_ny * D
                         else ls.reshape(1, D), (g_ny, D))
    os_ = np.asarray(ag["Dyn_gp_outputscale"]["both"],
                     dtype=np.float64).reshape(-1)
    os_ = np.broadcast_to(os_ if os_.size == g_ny else os_[:1], (g_ny,))
    tn = np.asarray(ag["Dyn_gp_task_noises"]["val"],
                    dtype=np.float64).reshape(-1)[:Ty]
    tn = tn * float(ag["Dyn_gp_task_noises"]["multiplier"])
    tight = ag.get("tight", {"use": False})
    g_idx, pad_g = PLANTS[dyn]
    return Spec(
        env_name=dyn, nx=ag["dim"]["nx"], nu=ag["dim"]["nu"], g_ny=g_ny,
        g_nx=g_nx, g_nu=g_nu, ns=ag["num_dyn_samples"], H=opt["H"],
        dt=float(opt["dt"]), Ty=Ty, g_idx_inputs=g_idx, pad_g=pad_g,
        max_sqp_iter=opt["SEMPC"]["max_sqp_iter"],
        tol_nlp=float(opt["SEMPC"]["tol_nlp"]),
        levenberg_marquardt=float(opt["options"]["levenberg_marquardt"]),
        shift_soln=bool(ag.get("shift_soln", True)),
        use_tightening=bool(tight.get("use", False)),
        use_feedback=bool(ag.get("feedback", {"use": False})["use"]),
        has_terminal_ellipse=(dyn == "Pendulum1D"
                              and opt.get("terminal_tightening") is not None),
        n_ellipses=len(env.get("ellipses", {}) or {}),
        lengthscale=tuple(tuple(r) for r in ls.tolist()),
        outputscale=tuple(os_.tolist()),
        noise_diag=tuple((tn + float(ag["Dyn_gp_noise"])).tolist()),
        beta=float(ag["Dyn_gp_beta"]), jitter=float(ag["Dyn_gp_jitter"]),
        variance_is_zero=float(ag["Dyn_gp_variance_is_zero"]))


# --------------------------------------------------------------------------
# plants: x+ = f_known(x, u) + B_d g(x_g, u_g), rows [value, d/dx, d/du]
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plant:
    spec: Spec
    f_val_jac: Callable      # (..., nx+nu) -> (..., nx, 1+nx+nu)
    g_val: Callable          # (..., D) -> (..., g_ny)
    g_prior: Callable        # (..., D) -> (..., g_ny, 1+D)
    B_d: np.ndarray          # (nx, g_ny)
    train_axes: list         # the training grid's axes
    v_scaled: bool = False   # B_d(x) = v B_d (the residual bicycle)

    def g_inputs(self, xu):
        return xu[..., list(self.spec.g_idx_inputs)]

    def step(self, x, u):
        """The true plant step."""
        xu = torch.cat([x, u], dim=-1)
        return self.propagate(x, u, self.g_val(self.g_inputs(xu)))

    def propagate(self, x, u, g):
        """The known part's step plus B_d(x) g, for GP values g (...,
        g_ny)."""
        xu = torch.cat([x, u], dim=-1)
        B = torch.as_tensor(self.B_d, dtype=x.dtype, device=x.device)
        d = (B @ g[..., None])[..., 0]
        if self.v_scaled:
            d = x[..., 3, None] * d
        return self.f_val_jac(xu)[..., 0] + d

    def val_jac(self, xu, dg):
        """Known rows plus the sampled GP rows dg (..., g_ny, Ty) scattered
        into the jacobian layout."""
        spec = self.spec
        pad = dg.new_zeros(dg.shape[:-1] + (1 + spec.nx + spec.nu,))
        pad[..., list(spec.pad_g)] = dg
        B = torch.as_tensor(self.B_d, dtype=xu.dtype, device=xu.device)
        return self.f_val_jac(xu) + B @ pad

    def training_data(self):
        """Tensor-grid training inputs (N, D) and value observations
        (g_ny, N, Ty), the gradient columns unobserved (NaN)."""
        mesh = np.meshgrid(*self.train_axes, indexing="ij")
        X = np.stack([m.reshape(-1) for m in mesh], axis=1)
        Y = self.g_prior(torch.as_tensor(X, dtype=torch.float64)).numpy()
        Y = np.transpose(Y, (1, 0, 2)).copy()
        Y[:, :, 1:] = np.nan
        return X, Y


def _pendulum1d(spec: Spec, params: dict) -> Plant:
    ep = params["env"]["params"]
    length, grav, dt = float(ep["l"]), float(ep["g"]), spec.dt

    def f_val_jac(xu):
        th, om = xu[..., 0], xu[..., 1]
        one, zero = torch.ones_like(th), torch.zeros_like(th)
        return torch.stack([
            torch.stack([th + om * dt, one, dt * one, zero], dim=-1),
            torch.stack([om, zero, one, zero], dim=-1)], dim=-2)

    def g_val(z):
        return (-grav * torch.sin(z[..., 0]) * dt / length
                + z[..., 1] * dt)[..., None]

    def g_prior(z):
        th = z[..., 0]
        return torch.stack([g_val(z)[..., 0],
                            -grav * torch.cos(th) * dt / length,
                            dt + 0 * th], dim=-1)[..., None, :]

    opt, env = params["optimizer"], params["env"]
    axes = [np.linspace(opt["x_min"][0], opt["x_max"][0], env["n_data_x"]),
            np.linspace(opt["u_min"][0], opt["u_max"][0], env["n_data_u"])]
    B = np.zeros((spec.nx, spec.g_ny))
    B[1, 0] = 1.0
    return Plant(spec, f_val_jac, g_val, g_prior, B, axes)


def _bicycle_terms(spec: Spec, params: dict):
    """(lr, dt, the slip angle's terms, the known part: x, y and phi kept,
    v + a dt) of the bicycle and the residual bicycle."""
    ep = params["env"]["params"]
    lf, lr, dt = float(ep["lf"]), float(ep["lr"]), spec.dt
    nx, nu = spec.nx, spec.nu

    def beta_terms(delta):
        b_in = lr * torch.tan(delta) / (lf + lr)
        term = ((lr / torch.cos(delta) ** 2) / (lf + lr)) / (1 + b_in ** 2)
        return torch.arctan(b_in), term

    def f_val_jac(xu):
        out = xu.new_zeros(xu.shape[:-1] + (nx, 1 + nx + nu))
        out[..., :3, 0] = xu[..., :3]
        out[..., 3, 0] = xu[..., 3] + xu[..., 5] * dt
        for r in range(nx):
            out[..., r, 1 + r] = 1.0
        out[..., 3, 6] = dt
        return out
    return lr, dt, beta_terms, f_val_jac


def _bicycle(spec: Spec, params: dict) -> Plant:
    nx = spec.nx
    lr, dt, beta_terms, f_val_jac = _bicycle_terms(spec, params)

    def g_val(z):
        phi, v, delta = z[..., 0], z[..., 1], z[..., 2]
        b, _ = beta_terms(delta)
        return torch.stack([v * torch.cos(phi + b) * dt,
                            v * torch.sin(phi + b) * dt,
                            v * torch.sin(b) * dt / lr], dim=-1)

    def g_prior(z):
        phi, v, delta = z[..., 0], z[..., 1], z[..., 2]
        b, term = beta_terms(delta)
        c, s, sb, zero = (torch.cos(phi + b), torch.sin(phi + b),
                          torch.sin(b), 0 * phi)
        return torch.stack([
            torch.stack([v * c * dt, -v * s * dt, c * dt, -v * s * dt * term],
                        dim=-1),
            torch.stack([v * s * dt, v * c * dt, s * dt, v * c * dt * term],
                        dim=-1),
            torch.stack([v * sb * dt / lr, zero, sb * dt / lr,
                         v * torch.cos(b) * dt * term / lr], dim=-1),
        ], dim=-2)

    opt, env = params["optimizer"], params["env"]

    def centered(lo, hi, n):
        d = (hi - lo) / n
        return np.linspace(lo + d / 2, hi - d / 2, n)

    axes = [centered(opt["x_min"][2], opt["x_max"][2], env["n_data_x"]),
            centered(opt["x_min"][3], opt["x_max"][3], env["n_data_x"]),
            centered(opt["u_min"][0], opt["u_max"][0], env["n_data_u"])]
    return Plant(spec, f_val_jac, g_val, g_prior, np.eye(nx, spec.g_ny), axes)


def _bicycle_bdx(spec: Spec, params: dict) -> Plant:
    """The residual bicycle: g(phi, delta) = [cos(phi + b) dt, sin(phi +
    b) dt, sin(b) dt / lr], without v, and B_d(x) = v I; trained on the
    plain endpoint grid of (phi, delta)."""
    lr, dt, beta_terms, f_val_jac = _bicycle_terms(spec, params)

    def g_val(z):
        b, _ = beta_terms(z[..., 1])
        return torch.stack([torch.cos(z[..., 0] + b) * dt,
                            torch.sin(z[..., 0] + b) * dt,
                            torch.sin(b) * dt / lr], dim=-1)

    def g_prior(z):
        phi, delta = z[..., 0], z[..., 1]
        b, term = beta_terms(delta)
        c, s = torch.cos(phi + b), torch.sin(phi + b)
        return torch.stack([
            torch.stack([c * dt, -s * dt, -s * dt * term], dim=-1),
            torch.stack([s * dt, c * dt, c * dt * term], dim=-1),
            torch.stack([torch.sin(b) * dt / lr, 0 * phi,
                         torch.cos(b) * dt * term / lr], dim=-1)], dim=-2)

    opt, env = params["optimizer"], params["env"]
    axes = [np.linspace(opt["x_min"][2], opt["x_max"][2], env["n_data_x"]),
            np.linspace(opt["u_min"][0], opt["u_max"][0], env["n_data_u"])]
    return Plant(spec, f_val_jac, g_val, g_prior, np.eye(spec.nx, spec.g_ny),
                 axes, v_scaled=True)


def make_plant(spec: Spec, params: dict) -> Plant:
    return {"Pendulum1D": _pendulum1d, "bicycle": _bicycle,
            "bicycle_Bdx": _bicycle_bdx}[spec.env_name](spec, params)


# --------------------------------------------------------------------------
# tightening and OCP data
# --------------------------------------------------------------------------

def tightenings(params: dict, H: int) -> np.ndarray:
    """Per-stage (H+1, nx+nu+1) reachable-set ball tightenings: state
    tightenings, input tightenings, radius."""
    opt = params["optimizer"]
    P = np.asarray(opt["terminal_tightening"]["P"], dtype=np.float64)
    K = np.asarray(opt["terminal_tightening"]["K"], dtype=np.float64)
    tight = params["agent"]["tight"]
    L = float(tight["Lipschitz"])
    var_eps = float(tight["dyn_eps"]) + float(tight["w_bound"])
    Bd_norm = np.sum(np.sqrt(np.diag(P)[:3]))
    P_inv = np.linalg.inv(P)
    x_scale = np.sqrt(np.diag(P_inv))
    u_scale = np.sqrt(np.diag(K @ P_inv @ K.T))
    rows = [np.zeros(x_scale.size + u_scale.size + 1)]
    geo = 0.0
    for stage in range(1, H + 1):
        geo += L ** (stage - 1)
        r = var_eps * Bd_norm * geo
        rows.append(np.concatenate([x_scale * r, u_scale * r, [r]]))
    return np.stack(rows)


@dataclasses.dataclass
class OCP:
    """Cost, bounds and penalties as tensors on one device and dtype."""

    Q: torch.Tensor           # (nx, nx) stage and terminal state weight
    Qu: torch.Tensor          # (nu, nu)
    goal: torch.Tensor        # (nx,) reference and feedback equilibrium
    w_cost: torch.Tensor      # (ns,) 1/ns
    lm: float
    u_lo: torch.Tensor
    u_hi: torch.Tensor
    x_lo: torch.Tensor        # (H+1, nx)
    x_hi: torch.Tensor
    fb_lo: torch.Tensor       # (H, nu)
    fb_hi: torch.Tensor
    K_fb: torch.Tensor        # (nu, nx), zeros without feedback
    P_term: torch.Tensor
    delta_sq: float
    ellipses: torch.Tensor    # (n_ell, 5)
    start: torch.Tensor
    pen_term: tuple           # (zl, zu, Zl, Zu)
    pen_path: tuple


def make_ocp(spec: Spec, params: dict, device, dtype) -> OCP:
    opt, env, ag = params["optimizer"], params["env"], params["agent"]
    H, nx, nu = spec.H, spec.nx, spec.nu
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)
    x_min, x_max = np.asarray(opt["x_min"], float), np.asarray(opt["x_max"],
                                                               float)
    u_min, u_max = np.asarray(opt["u_min"], float), np.asarray(opt["u_max"],
                                                               float)
    x_lo, x_hi = np.tile(x_min, (H + 1, 1)), np.tile(x_max, (H + 1, 1))
    fb_lo, fb_hi = np.tile(u_min, (H, 1)), np.tile(u_max, (H, 1))
    tt = opt.get("terminal_tightening")
    if spec.use_tightening:
        te = tightenings(params, H)
        x_lo, x_hi = x_lo + te[:, :nx], x_hi - te[:, :nx]
        if spec.env_name == "Pendulum1D":
            fb_lo = fb_lo + te[:H, nx:nx + nu]
            fb_hi = fb_hi - te[:H, nx:nx + nu]
    if spec.use_feedback:
        u_lo, u_hi = ag["feedback"]["v_min"], ag["feedback"]["v_max"]
        K = np.asarray(tt["K"], float)
    else:
        u_lo, u_hi = u_min, u_max
        K = np.zeros((nu, nx))
    P = (np.asarray(tt["P"], float) if tt and "P" in tt
         else np.zeros((nx, nx)))
    delta = float(tt.get("delta", 0.0)) if tt else 0.0
    ell = env.get("ellipses", {}) or {}
    ellipses = np.asarray([ell[k] for k in ell], float).reshape(-1, 5)
    return OCP(
        Q=f(np.diag(np.asarray(opt["Qx"], float))),
        Qu=f(np.diag(np.asarray(opt["Qu"], float))),
        goal=f(env["goal_state"]), w_cost=f(np.full(spec.ns, 1.0 / spec.ns)),
        lm=spec.levenberg_marquardt, u_lo=f(u_lo), u_hi=f(u_hi),
        x_lo=f(x_lo), x_hi=f(x_hi), fb_lo=f(fb_lo), fb_hi=f(fb_hi), K_fb=f(K),
        P_term=f(P), delta_sq=delta ** 2, ellipses=f(ellipses),
        start=f(env["start"]),
        # acados' slack penalties: terminal set and path constraints
        pen_term=(1e7, 1e6, 1e7, 1e6), pen_path=(1e6, 1e5, 1e6, 1e5))
