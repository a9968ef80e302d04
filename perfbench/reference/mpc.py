"""One SQP iteration of sampling-based GP-MPC, and the solve built on it.

A frozen plain copy of the measured program's solve path, in any dtype on
any device: the GP stage (real-data factor; iteration 0 conditions on it
alone, later ones on each sample's hallucinated rows too), the per-sample
linearization with the ancillary feedback's chain rule, sequential
condensing onto the stacked input, the cost, hard and soft rows of the
condensed QP, its solution (``qp.solve``, cold), and the step with the
relative-change convergence test.  ``Model`` holds what is worked out once
from the configuration file.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from perfbench.reference import gp, problem, qp

FAR = 1.0e5        # input coordinate of empty hallucination slots


class GPData(NamedTuple):
    Z: torch.Tensor          # (N, D) real training inputs
    facts: list              # per output: the real factor
    hall_Z: torch.Tensor     # (ns, g_ny, Mh, D)
    hall_Y: torch.Tensor     # (ns, g_ny, Mh, Ty), NaN = empty
    hall_n: int


@dataclasses.dataclass
class Model:
    spec: problem.Spec
    plant: problem.Plant
    ocp: problem.OCP
    ls: torch.Tensor          # (g_ny, D)
    os_: torch.Tensor         # (g_ny,)
    noise: torch.Tensor       # (Ty,)
    gp0: GPData               # real factor, empty hall buffer
    device: torch.device
    dtype: torch.dtype

    @classmethod
    def from_file(cls, path: str, device, dtype) -> "Model":
        params = problem.load(path)
        spec = problem.make_spec(params)
        plant = problem.make_plant(spec, params)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        ls, os_, noise = (t(spec.lengthscale), t(spec.outputscale),
                          t(spec.noise_diag))
        X, Y = plant.training_data()
        Z, Y = t(X), t(Y)
        facts = [gp.factor_real(Z, Y[j], ls[j], os_[j], noise, spec.jitter)
                 for j in range(spec.g_ny)]
        Mh = spec.H * max(spec.max_sqp_iter, 1)
        gp0 = GPData(Z, facts,
                     torch.full((spec.ns, spec.g_ny, Mh, spec.D), FAR,
                                dtype=dtype, device=device),
                     torch.full((spec.ns, spec.g_ny, Mh, spec.Ty),
                                float("nan"), dtype=dtype, device=device), 0)
        return cls(spec, plant, problem.make_ocp(spec, params, device, dtype),
                   ls, os_, noise, gp0, torch.device(device), dtype)

    def tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def prior_std(self):
        """(g_ny, Ty) prior standard deviation of each output and task."""
        return torch.sqrt(gp.prior_task_variances(self.ls, self.os_,
                                                  self.spec.Ty))


def init_iterate(m: Model):
    """The start state over every stage and sample, zero inputs."""
    s = m.spec
    X = m.ocp.start.expand(s.H + 1, s.ns, s.nx).clone()
    return X, torch.zeros((s.H, s.nu), dtype=m.dtype, device=m.device)


def realized_inputs(m: Model, X, U):
    """Per-sample (x, u) points of the iterate, the ancillary feedback
    applied: (ns, H, nx+nu)."""
    s = m.spec
    Xs = X[:s.H].transpose(0, 1)
    Ub = U[None].expand((s.ns,) + U.shape)
    if s.use_feedback:
        Ub = Ub - (m.ocp.goal[None, None] - Xs) @ m.ocp.K_fb.T
    return torch.cat([Xs, Ub], dim=-1)


def gp_inputs(m: Model, X, U):
    return realized_inputs(m, X, U)[..., list(m.spec.g_idx_inputs)]


def with_hall(gp0: GPData, hall_Z, hall_Y, n: int) -> GPData:
    """gp0 with the first n rows of a hallucination buffer filled."""
    Z, Y = gp0.hall_Z.clone(), gp0.hall_Y.clone()
    Z[:, :, :n] = hall_Z[:, :, :n]
    Y[:, :, :n] = hall_Y[:, :, :n]
    return gp0._replace(hall_Z=Z, hall_Y=Y, hall_n=n)


def gp_stage(m: Model, g: GPData, Xt, eps, moments: bool = False):
    """Sampled GP rows dg (ns, g_ny, H, Ty) at Xt (ns, H, D) from the base
    draws eps (ns, g_ny, H, Ty), conditioned on the real data and, when
    the buffer holds rows, on each sample's hallucinated rows; with
    ``moments`` also the posterior mean and standard deviation, alike, and
    the covariance (ns, g_ny, H Ty, H Ty) over each sample's points and
    tasks (point-major)."""
    s = m.spec
    dg, mu, sd, cv = [], [], [], []
    for j in range(s.g_ny):
        if g.hall_n == 0:
            mean, cov = gp.predict_real(Xt, g.Z, g.facts[j], m.ls[j],
                                        m.os_[j])
        else:
            mean, cov = gp.predict_hall(Xt, g.Z, g.hall_Z[:, j],
                                        g.hall_Y[:, j], g.facts[j], m.ls[j],
                                        m.os_[j], m.noise, s.jitter)
        pv = gp.prior_task_variances(m.ls[j], m.os_[j], s.Ty)
        dg.append(gp.sample(mean, cov, eps[:, j].reshape(s.ns, -1), s.H, s.Ty,
                            s.beta, s.jitter, s.variance_is_zero, pv))
        mu.append(mean.reshape(s.ns, s.H, s.Ty))
        sd.append(torch.sqrt(torch.clamp(torch.diagonal(
            cov, dim1=-2, dim2=-1), min=0.0)).reshape(s.ns, s.H, s.Ty))
        cv.append(cov)
    if moments:
        return (torch.stack(dg, dim=1), torch.stack(mu, dim=1),
                torch.stack(sd, dim=1), torch.stack(cv, dim=1))
    return torch.stack(dg, dim=1)


def append_hall(g: GPData, Xt, dg) -> GPData:
    n, P = g.hall_n, Xt.shape[1]
    Z, Y = g.hall_Z.clone(), g.hall_Y.clone()
    Z[:, :, n:n + P] = Xt[:, None]
    Y[:, :, n:n + P] = dg
    return g._replace(hall_Z=Z, hall_Y=Y, hall_n=n + P)


def linearize(m: Model, x0, X, U, dg):
    """Per-sample affine dynamics at the iterate from the sampled rows,
    condensed onto the stacked input: T (ns, H+1, nx), Gamma (ns, H+1,
    nx, H nu) with dx_k = T_k + Gamma_k dU."""
    s = m.spec
    xu = realized_inputs(m, X, U)
    vj = m.plant.val_jac(xu, dg.transpose(1, 2))
    val, A, B = vj[..., 0], vj[..., 1:1 + s.nx], vj[..., 1 + s.nx:]
    if s.use_feedback:
        A = A + B @ m.ocp.K_fb
    r = val - X[1:].transpose(0, 1)
    dx0 = x0[None].expand(s.ns, s.nx) - X[0]
    T, G = [dx0], [A.new_zeros((s.ns, s.nx, s.H * s.nu))]
    for k in range(s.H):
        G_n = A[:, k] @ G[-1]
        G_n[:, :, k * s.nu:(k + 1) * s.nu] = B[:, k]
        T.append((A[:, k] @ T[-1][..., None])[..., 0] + r[:, k])
        G.append(G_n)
    return torch.stack(T, dim=1), torch.stack(G, dim=1)


def assemble(m: Model, T, Gamma, X, U):
    """The condensed QP (H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu):
    the expected tracking cost with Levenberg-Marquardt, the input box, the
    per-sample state box (soft where obstacle ellipses exist), the realized
    feedback-input rows, the terminal ellipse and the obstacle ellipses."""
    s, o = m.spec, m.ocp
    H, nx, nu, ns = s.H, s.nx, s.nu, s.ns
    nU = H * nu
    dt, dev = T.dtype, T.device
    eye_x = torch.eye(nx, dtype=dt, device=dev)
    Hx = 2.0 * o.w_cost[:, None, None] * o.Q[None] + o.lm * eye_x
    xpred = X.transpose(0, 1) + T
    grad_x = (2.0 * o.w_cost[:, None, None] * ((xpred - o.goal) @ o.Q.T)
              + o.lm * T)
    H_U = torch.einsum("ikau,iab,ikbv->uv", Gamma, Hx, Gamma)
    g_U = torch.einsum("ikau,ika->u", Gamma, grad_x)
    H_U = H_U + torch.kron(torch.eye(H, dtype=dt, device=dev),
                           2.0 * o.Qu + o.lm * torch.eye(nu, dtype=dt,
                                                         device=dev))
    g_U = g_U + (2.0 * U @ o.Qu).reshape(nU)

    sel = torch.eye(nU, dtype=dt, device=dev)
    Gs = [sel]
    los, his = [(o.u_lo - U).reshape(nU)], [(o.u_hi - U).reshape(nU)]
    if s.n_ellipses == 0:
        Gs.append(Gamma[:, 1:].reshape(ns * H * nx, nU))
        los.append((o.x_lo[None, 1:] - xpred[:, 1:]).reshape(-1))
        his.append((o.x_hi[None, 1:] - xpred[:, 1:]).reshape(-1))
    if s.use_feedback:
        KG = torch.einsum("ua,ikab->ikub", o.K_fb, Gamma[:, :H])
        Gs.append((KG + sel.reshape(H, nu, nU)[None]).reshape(-1, nU))
        h_bar = U[None] - (o.goal - xpred[:, :H]) @ o.K_fb.T
        los.append((o.fb_lo[None] - h_bar).reshape(-1))
        his.append((o.fb_hi[None] - h_bar).reshape(-1))
    G_box, lo_box, hi_box = torch.cat(Gs), torch.cat(los), torch.cat(his)
    G_h = torch.cat([G_box, -G_box])
    d_h = torch.cat([hi_box, -lo_box])

    G_s, lo_s, hi_s, pen = [], [], [], []
    if s.has_terminal_ellipse:
        xe = X[H] - o.goal
        J = 2.0 * xe @ o.P_term
        const = torch.einsum("ia,ab,ib->i", xe, o.P_term, xe) + torch.einsum(
            "ia,ia->i", J, T[:, H])
        G_s.append(torch.einsum("ia,iau->iu", J, Gamma[:, H]))
        lo_s.append(-const)
        hi_s.append(o.delta_sq - const)
        pen.append((o.pen_term, ns))
    if s.n_ellipses:
        e = o.ellipses
        px = xpred[:, :, 0, None] - e[:, 0]
        py = xpred[:, :, 1, None] - e[:, 1]
        q0 = px * px / e[:, 2] + py * py / e[:, 3]
        G = (2 * px / e[:, 2])[..., None] * Gamma[:, :, 0, None] + (
            2 * py / e[:, 3])[..., None] * Gamma[:, :, 1, None]
        nrow = ns * (H + 1) * s.n_ellipses
        G_s.append(G.reshape(nrow, nU))
        lo_s.append((e[:, 4] - q0).reshape(nrow))
        hi_s.append(torch.full((nrow,), 1e8, dtype=dt, device=dev))
        pen.append((o.pen_path, nrow))
        G_s.append(Gamma[:, 1:].reshape(ns * H * nx, nU))
        lo_s.append((o.x_lo[None, 1:] - xpred[:, 1:]).reshape(-1))
        hi_s.append((o.x_hi[None, 1:] - xpred[:, 1:]).reshape(-1))
        pen.append((o.pen_path, ns * H * nx))
    pens = [torch.cat([torch.full((n,), p[i], dtype=dt, device=dev)
                       for p, n in pen]) for i in range(4)]
    return (H_U, g_U, G_h, d_h, torch.cat(G_s), torch.cat(lo_s),
            torch.cat(hi_s), *pens)


class Solve(NamedTuple):
    """What a solve hands back: the iterate after and entering the last
    iteration, the GP data with every iteration's rows, the iterations,
    the last QP's status, the summed QP iterations and the step scale."""
    X: torch.Tensor
    U: torch.Tensor
    X_prev: torch.Tensor
    U_prev: torch.Tensor
    gp: GPData
    it: int
    status: int
    qp_iters: int
    alpha: float


def solve(m: Model, x0, X, U, eps_iters) -> Solve:
    """The SQP solve of one MPC step from the iterate (X, U) at the state
    x0 with the draws eps_iters (max_sqp_iter, ns, g_ny, H, Ty): every QP
    from a cold start, the full step, stopping on the relative-change test
    or a failed QP."""
    s = m.spec
    g, qp_iters, it = m.gp0, 0, 0
    while True:
        Xt = gp_inputs(m, X, U)
        dg = gp_stage(m, g, Xt, eps_iters[it])
        g = append_hall(g, Xt, dg)
        T, Gamma = linearize(m, x0, X, U, dg)
        du, status, n = qp.solve(assemble(m, T, Gamma, X, U))
        qp_iters += n
        it += 1
        X_prev, U_prev = X, U
        if status != 0:
            return Solve(X, U, X_prev, U_prev, g, it, status, qp_iters, 1.0)
        X = X + (T + torch.einsum("ikau,u->ika", Gamma, du)).transpose(0, 1)
        U = U + du.reshape(s.H, s.nu)
        x_diff = (torch.linalg.norm(X[:s.H] - X_prev[:s.H])
                  / (torch.linalg.norm(X_prev[:s.H]) + 1e-6))
        u_diff = torch.linalg.norm(U - U_prev) / (torch.linalg.norm(U_prev)
                                                  + 1e-6)
        done = bool(x_diff < s.tol_nlp) and bool(u_diff < s.tol_nlp)
        if it >= s.max_sqp_iter or done:
            return Solve(X, U, X_prev, U_prev, g, it, 0, qp_iters, 1.0)


def applied_input(m: Model, X, U):
    """The plan's first input with the ancillary feedback at X[0, 0]."""
    u0 = U[0]
    if m.spec.use_feedback:
        u0 = u0 - (m.ocp.goal - X[0, 0]) @ m.ocp.K_fb.T
    return u0


def shift(X, U):
    """Stages one step forward, the last repeated."""
    return torch.cat([X[1:], X[-1:]]), torch.cat([U[1:], U[-1:]])
