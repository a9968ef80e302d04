"""Approximate sampling-based MPC: nominal model + sampled tightenings.

Port of ``sampling_gpmpc_tpu/approx/solver.py``.  Instead of the augmented
multi-sample OCP, solve a *single* nominal MPC (BLR mean-weight dynamics)
whose constraints are tightened per stage by the spread of sampled-weight
trajectory rollouts:

    Delta_k = max_n | x_k^n - x_k^mu |        (per state dimension)

(ref: extra/approx_sampling_mpc/README.md, src/solver.py:77-135,215-400).
The path-tracking cost follows a per-stage reference (heart curve), the
obstacle circles are tightened by ||Delta_k[:2]|| and the terminal
(vx, vy) set is an ellipse.  Built on the port's condensing
(``ocp/condense.condense`` on a batch of one sample) and structured QP
(``ocp/qp.solve_qp_soft``): on CUDA the pessimistic planner's QP (nU =
H nu = 60, soft obstacle rows) takes the IPM kernels' soft build, the
optimistic planner's (nU = H (nu + nx) = 240, no soft rows) their wide
hard-only build.

The weight draws of the tightening are standard-normal tensors (n_tight,
g_ny, F) the caller passes in (``draws``) or that ``run`` makes from a
``torch.Generator``: the port cannot reproduce ``jax.random``, so the
tests replay the JAX package's draws.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.approx import blr
from sampling_gpmpc_torch.approx.drone import DroneModel
from sampling_gpmpc_torch.ocp.condense import condense
from sampling_gpmpc_torch.ocp.qp import boxes_to_rows, solve_qp_soft


def _condense_one(A, B, r, dx0):
    """condense() on one sample: T (H+1, nx), Gamma (H+1, nx, H nu)."""
    T, Gamma = condense(A[None], B[None], r[None], dx0[None])
    return T[0], Gamma[0]


class ApproxMPC:
    def __init__(self, params: dict, device=None, dtype=None):
        self.params = params
        self.device, self.dtype = setup.resolve(device, dtype)
        dev, dtype = self.device, self.dtype
        self.model = DroneModel(params)
        self.feats = self.model.features()
        self.step_fn, self.val_jac_fn = blr.make_dynamics(self.feats,
                                                          self.model.nx)
        self._val_jac = torch.func.vmap(self.val_jac_fn, in_dims=(0, 0, None))
        opt = params["optimizer"]
        ag = params["agent"]
        self.H = opt["H"]
        self.nx, self.nu = self.model.nx, self.model.nu
        self.max_sqp_iter = opt["SEMPC"]["max_sqp_iter"]
        self.lm = float(opt["options"]["levenberg_marquardt"])
        self.n_tight = int(ag.get("num_samples_tightening", 100))
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                      dtype=dtype, device=dev)
        self._t = t
        self.Qx = t(np.diag(opt["Qx"]))                     # on (px, py)
        self.Qu = t(np.diag(opt["Qu"]))
        self.x_min, self.x_max = t(opt["x_min"]), t(opt["x_max"])
        self.u_min, self.u_max = t(opt["u_min"]), t(opt["u_max"])
        self.obstacles = t(self.model.obstacles())
        tt = opt["terminal_tightening"]
        self.P_term = t(tt["P"])                            # on (vx, vy)
        self.delta = float(tt["delta"])
        self.x_term = t(params["env"]["terminate_state"])

        # BLR posterior over the prior dataset, kept as sufficient
        # statistics so active learning can absorb observed transitions
        # (ref: extra/approx_sampling_mpc/src/DEMPC.py:75-81)
        X, Y = self.model.training_grid()
        self._noise_var = float(ag["BLR"]["noise_var"])
        self._stats = blr.stats_fit(self.feats, X, Y,
                                    float(ag["BLR"]["lambda_reg"]))
        self.post = blr.posterior_from_stats(self._stats, self._noise_var,
                                             dev, dtype)
        run = ag.get("run", {})
        self._use_gt_weights = bool(run.get("true_param_as_sample", False))
        if self._use_gt_weights:
            self.W_nominal = self._pad_weights(self.model.gt_weights())
        else:
            # nominal = posterior mean (ref mean_as_dyn_sample=True path)
            self.W_nominal = self.post.mu
        al = params["common"].get("active_learning", {}) or {}
        self.al_use = bool(al.get("use", False))
        self.al_freq = max(1, int(al.get("frequency", 1)))

    def _pad_weights(self, w_list):
        F = self.post.mu.shape[1]
        W = np.zeros((self.nx, F))
        for j, w in enumerate(w_list):
            W[j, :len(w)] = w
        return self._t(W)

    def observe(self, x, u) -> None:
        """Online-learn one true transition (active learning): the true
        dynamics at (x, u) in the working dtype, absorbed into the host
        statistics as a rank-1 update; the posterior and the nominal model
        are refreshed (ref DEMPC.py:75-81 / agent.py:270-273)."""
        y = self.model.discrete_dyn(self._t(x), self._t(u)).cpu().numpy()
        self._stats = blr.stats_update(self._stats, self.feats,
                                       np.asarray(x), np.asarray(u), y)
        self.post = blr.posterior_from_stats(self._stats, self._noise_var,
                                             self.device, self.dtype)
        if not self._use_gt_weights:
            self.W_nominal = self.post.mu

    def _tightening(self, x0, U, z, post, W_nom):
        """Delta_k = max_n |x^n_k - x^mu_k| over the weight draws mu + L z
        (ref: solver.py:84-135): (H+1, nx)."""
        Ws = blr.sample_weights(post, z)
        X_mu = blr.rollout(self.step_fn, x0, U, W_nom)
        X_s = blr.rollout(self.step_fn, x0, U, Ws)
        return torch.amax(torch.abs(X_s - X_mu[None]), dim=0)

    def _cost(self, X, U, T, Gamma, wpath, Qx, Qu, lm, nu):
        """Condensed path-tracking cost on (px, py) per stage, terminal
        included, plus the input cost: (H_U, g_U)."""
        H, nx = self.H, self.nx
        dev, dtype = self.device, self.dtype
        Qfull = X.new_zeros((nx, nx))
        Qfull[:2, :2] = Qx
        xref = X.new_zeros((H + 1, nx))
        xref[:, :2] = wpath
        eye_x = torch.eye(nx, dtype=dtype, device=dev)
        Hx = 2.0 * Qfull[None] + lm * eye_x[None]
        xerr = X + T - xref
        grad_x = 2.0 * torch.einsum("ab,kb->ka", Qfull, xerr) + lm * T
        H_U = torch.einsum("kau,kab,kbv->uv", Gamma, Hx, Gamma)
        g_U = torch.einsum("kau,ka->u", Gamma, grad_x)
        Hu = 2.0 * Qu + lm * torch.eye(nu, dtype=dtype, device=dev)
        H_U = H_U + torch.kron(torch.eye(H, dtype=dtype, device=dev), Hu)
        g_U = g_U + (2.0 * U @ Qu).reshape(H * nu)
        return H_U, g_U

    def _sqp_iteration(self, x0, X, U, wpath, delta, W_nom):
        H, nx, nu = self.H, self.nx, self.nu
        nU = H * nu
        dev, dtype = self.device, self.dtype

        vj = self._val_jac(X[:H], U, W_nom)
        val, A, B = vj[:, :, 0], vj[:, :, 1:1 + nx], vj[:, :, 1 + nx:]
        r = val - X[1:]
        T, Gamma = _condense_one(A, B, r, x0 - X[0])
        H_U, g_U = self._cost(X, U, T, Gamma, wpath, self.Qx, self.Qu,
                              self.lm, nu)

        xpred = X + T
        rows_G, rows_lo, rows_hi = [], [], []
        # input box
        rows_G.append(torch.eye(nU, dtype=dtype, device=dev))
        rows_lo.append((self.u_min[None] - U).reshape(nU))
        rows_hi.append((self.u_max[None] - U).reshape(nU))
        # tightened state box stages 1..H
        rows_G.append(Gamma[1:].reshape(H * nx, nU))
        rows_lo.append((self.x_min[None] + delta[1:] - xpred[1:]).reshape(-1))
        rows_hi.append((self.x_max[None] - delta[1:] - xpred[1:]).reshape(-1))
        # terminal (vx, vy) ellipse <= delta
        ve = X[H, 3:5] - self.x_term
        q0 = ve @ self.P_term @ ve
        J = 2.0 * self.P_term @ ve                     # (2,)
        Gt = (J[None, :] @ Gamma[H, 3:5]).reshape(1, nU)
        const = q0 + J @ T[H, 3:5]
        rows_G.append(Gt)
        rows_lo.append((0.0 - const).reshape(1))
        rows_hi.append((self.delta - const).reshape(1))
        C_h, d_h = boxes_to_rows(torch.cat(rows_G), torch.cat(rows_lo),
                                 torch.cat(rows_hi))

        # obstacle circles (soft, heavily penalized: the reference's hard
        # rows rely on HPIPM surviving transient infeasibility)
        if self.obstacles.shape[0]:
            cx, cy, rr = (self.obstacles[:, 0], self.obstacles[:, 1],
                          self.obstacles[:, 2])
            pos_t = torch.linalg.norm(delta[:, :2], dim=1)    # (H+1,)
            px = xpred[:, 0][:, None] - cx[None]
            py = xpred[:, 1][:, None] - cy[None]
            q = px * px + py * py                             # (H+1, n_obs)
            Gx = (2 * px[..., None] * Gamma[:, 0][:, None, :]
                  + 2 * py[..., None] * Gamma[:, 1][:, None, :])
            r_t = (rr[None] + pos_t[:, None]) ** 2
            m = (H + 1) * self.obstacles.shape[0]
            G_s = Gx.reshape(m, nU)
            lo_s = (r_t - q).reshape(m)
            hi_s = X.new_full((m,), 1e8)
            pen = X.new_full((m,), 1e6)
        else:
            G_s = X.new_zeros((0, nU))
            lo_s = hi_s = pen = X.new_zeros((0,))

        sol = solve_qp_soft(H_U, g_U, C_h, d_h, G_s, lo_s, hi_s,
                            pen, pen, pen, pen)
        dU = sol.z
        dX = T + torch.einsum("kau,u->ka", Gamma, dU)
        return X + dX, U + dU.reshape(H, nu), sol.status

    def _sqp_solve(self, x0, X, U, wpath, delta, W_nom):
        status = torch.zeros((), dtype=torch.long, device=self.device)
        for _ in range(self.max_sqp_iter):
            X, U, status = self._sqp_iteration(x0, X, U, wpath, delta, W_nom)
        return X, U, status

    # ------------------------------------------------------------------
    # Optimistic OCP: augment the input with per-stage eta in [-1, 1]^nx
    # scaling the weight posterior stds, so the optimizer may pick any
    # dynamics within the beta-confidence set (exploration planning,
    # ref: extra/approx_sampling_mpc/src/utils/optimistic_ocp.py,
    # src/agent.py:886-935).
    # ------------------------------------------------------------------

    def _opt_cfg(self):
        return self.params.get("optimistic_optimizer",
                               self.params["optimizer"])

    def optimistic_step(self, x, u, eta, post=None):
        """Dynamics with eta-scaled weights: w_j = mu_j + eta_j beta sigma_j."""
        post = self.post if post is None else post
        beta = float(self.params["agent"].get("Dyn_gp_beta", 2.0))
        sig = torch.sqrt(torch.diagonal(
            torch.einsum("jab,jcb->jac", post.chol, post.chol),
            dim1=-2, dim2=-1))
        W = post.mu + eta[..., :, None] * beta * sig * post.mask
        return self.step_fn(x, u, W)

    def solve_optimistic(self, x0, wpath=None, max_sqp_iter=None,
                         X0=None, U0=None):
        """Optimistic plan from x0; returns (X, U_aug, status).

        U_aug stacks (u, eta) per stage; eta is box-bounded to [-1, 1].
        X0/U0 optionally warm-start the SQP (the reference shifts the
        optimistic solution between MPC steps too)."""
        cfg = self._opt_cfg()
        H, nx = self.H, self.nx
        nu_a = self.nu + nx
        max_sqp_iter = max_sqp_iter or cfg["SEMPC"]["max_sqp_iter"]
        if wpath is None:
            wpath = self._t(self.model.path_generator(0))
        x0 = self._t(x0) if not torch.is_tensor(x0) else x0.to(
            self.device, self.dtype)
        X = (x0[None].expand(H + 1, nx).clone() if X0 is None
             else torch.as_tensor(X0, dtype=self.dtype, device=self.device))
        U = (x0.new_zeros((H, nu_a)) if U0 is None
             else torch.as_tensor(U0, dtype=self.dtype, device=self.device))
        status = torch.zeros((), dtype=torch.long, device=self.device)
        for _ in range(max_sqp_iter):
            X, U, status = self._opt_iteration(X, U, x0, wpath, self.post)
        return X, U, int(status)

    def _opt_iteration(self, X, U, x0, wpath, post):
        """One optimistic SQP iteration (the JAX package's
        ``_build_opt_iteration``)."""
        cfg = self._opt_cfg()
        H, nx, nu = self.H, self.nx, self.nu
        nu_a = nu + nx
        dev, dtype = self.device, self.dtype
        lm = float(cfg["options"]["levenberg_marquardt"])
        Qx = self._t(np.diag(cfg["Qx"][:2]))
        Qu_a = X.new_zeros((nu_a, nu_a))
        Qu_a[:nu, :nu] = self._t(np.diag(cfg["Qu"][:nu]))

        def aug_step(x, ua):
            return self.optimistic_step(x, ua[..., :nu], ua[..., nu:], post)

        def val_jac(x, ua):
            val = aug_step(x, ua)
            Jx = torch.func.jacfwd(aug_step, argnums=0)(x, ua)
            Ju = torch.func.jacfwd(aug_step, argnums=1)(x, ua)
            return val, Jx, Ju

        val, A, B = torch.func.vmap(val_jac)(X[:H], U)
        r = val - X[1:]
        T, Gamma = _condense_one(A, B, r, x0 - X[0])
        H_U, g_U = self._cost(X, U, T, Gamma, wpath, Qx, Qu_a, lm, nu_a)

        # input box: physical u bounds + eta in [-1, 1]
        ones = torch.ones(nx, dtype=dtype, device=dev)
        u_lo = torch.cat([self.u_min, -ones])
        u_hi = torch.cat([self.u_max, ones])
        sel = torch.eye(H * nu_a, dtype=dtype, device=dev)
        lo = (u_lo[None] - U).reshape(-1)
        hi = (u_hi[None] - U).reshape(-1)
        # state box stages 1..H
        xpred = X + T
        Gx = Gamma[1:].reshape(H * nx, H * nu_a)
        lo_x = (self.x_min[None] - xpred[1:]).reshape(-1)
        hi_x = (self.x_max[None] - xpred[1:]).reshape(-1)
        C_h, d_h = boxes_to_rows(torch.cat([sel, Gx]), torch.cat([lo, lo_x]),
                                 torch.cat([hi, hi_x]))
        empty = X.new_zeros((0,))
        sol = solve_qp_soft(H_U, g_U, C_h, d_h, X.new_zeros((0, H * nu_a)),
                            empty, empty, empty, empty, empty, empty)
        dU = sol.z
        dX = T + torch.einsum("kau,u->ka", Gamma, dU)
        return X + dX, U + dU.reshape(H, nu_a), sol.status

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_iters=None, x0=None, generator=None, draws=None):
        """Closed loop (ref: demo_obstacle_avoidance.py).

        Planner selection mirrors the reference's flag pair (ref:
        extra/approx_sampling_mpc/src/DEMPC.py:56-61): `run.optimistic`
        plans with the eta-augmented exploration OCP, `run.pessimistic`
        (which wins when both are set) with the tightened nominal OCP.
        Step m's tightening uses ``draws[m]`` (n_tight, g_ny, F) when given,
        else standard-normal draws from ``generator`` (a CPU
        ``torch.Generator``, seeded from the config when None).  Each
        step's solver time ends in a device sync.
        """
        num_iters = num_iters or self.params["common"]["num_MPC_itrs"]
        if draws is None and generator is None:
            generator = torch.Generator().manual_seed(
                int(self.params["experiment"]["rnd_seed"]["value"]))
        run_cfg = self.params["agent"].get("run", {})
        pessimistic = bool(run_cfg.get("pessimistic", True))
        optimistic = bool(run_cfg.get("optimistic", False)) and \
            not pessimistic
        x = self._t(x0 if x0 is not None else self.params["env"]["start"])
        X = x[None].expand(self.H + 1, self.nx).clone()
        U = x.new_zeros((self.H, self.nu))
        shape = (self.n_tight,) + tuple(self.post.mu.shape)

        phys, times, plans, tight_hist = [], [], [], []
        X_aug = U_aug = None
        for m in range(num_iters):
            wpath = self._t(self.model.path_generator(m))
            if not optimistic:
                z = (torch.tensor(draws[m]) if draws is not None else
                     torch.randn(shape, generator=generator,
                                 dtype=torch.float64))
                z = z.to(self.device, self.dtype)
            self._sync()
            t0 = time.perf_counter()
            if optimistic:
                delta = x.new_zeros((self.H + 1, self.nx))
                X_a, U_a, status = self.solve_optimistic(
                    x, wpath=wpath, X0=X_aug, U0=U_aug)
                # shift-carry the augmented solution (ref shifts the
                # optimistic solver's iterate too)
                X_aug = torch.cat([X_a[1:], X_a[-1:]])
                U_aug = torch.cat([U_a[1:], U_a[-1:]])
                X, U = X_a, U_a[:, :self.nu]
            else:
                delta = self._tightening(x, U, z, self.post, self.W_nominal)
                X, U, status = self._sqp_solve(x, X, U, wpath, delta,
                                               self.W_nominal)
            self._sync()
            times.append(time.perf_counter() - t0)

            u0 = U[0]
            if self.al_use and m % self.al_freq == 0:
                # observe the true transition at (x, u0) BEFORE stepping
                # (ref DEMPC.py:72-81 learns at X_true_traj[0], U[0])
                self.observe(X[0].cpu().numpy(), u0.cpu().numpy())
            phys.append(x.cpu().numpy())
            plans.append(X.cpu().numpy())
            tight_hist.append(delta.cpu().numpy())
            x = self.model.discrete_dyn(X[0], u0)
            # warm-start shift
            X = torch.cat([X[1:], X[-1:]])
            U = torch.cat([U[1:], U[-1:]])

        return {"physical_state_traj": phys, "state_traj": plans,
                "solver_time": times, "tightenings": tight_hist,
                "final_state": x.cpu().numpy(), "status": int(status)}
