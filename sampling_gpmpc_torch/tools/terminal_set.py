"""Terminal set / ancillary gain synthesis.

Produces the (P, K, delta, rho) terminal ingredients consumed by the YAML
configs.  The reference solves a min -logdet LMI with cvxpy over gridded
(A, B) vertices (ref: extra/pendulum_mpi.py:106-165, car_mpi.py:14-60).
Two synthesis routes:

- ``synthesize_lmi``: the reference's SDP itself — max logdet E subject to
  the vertex contraction LMIs — solved from scratch with a log-barrier
  Newton method in float64, its gradient and Hessian from ``torch.func``
  (no SDP solver needed).
- ``synthesize``: the classical Riccati route (scipy's DARE in float64),
  which *verifies* the same contraction and constraint-containment
  conditions a posteriori over sampled vertices:

  1. (A0, B0) = true-dynamics Jacobians at the equilibrium; K = dLQR gain,
     P = DARE solution.
  2. rho = max_i || P^{1/2} (A_i + B_i K) P^{-1/2} ||_2 over sampled
     linearizations — must be < 1 for invariance.
  3. delta = largest ellipse radius such that {x : (x-xe)' P (x-xe) <= d^2}
     satisfies the state box and the feedback-input box.

The Jacobians run on the device (CUDA unless the caller asks for another);
the DARE and the a-posteriori checks are numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.linalg
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.envs.base import Env
from sampling_gpmpc_torch.tools.lipschitz import true_jacobians

F64 = torch.float64


class TerminalSet(NamedTuple):
    P: np.ndarray
    K: np.ndarray
    delta: float
    rho: float


def vertex_jacobians(env: Env, pts, device=None) -> list:
    """(A, B) true-dynamics Jacobians (numpy) at sampled (nx+nu,) points —
    the vertex set the reference builds from sampled GP gradients
    (ref: pendulum_mpi.py:33-57)."""
    dev = setup.resolve_device(device)
    A, B = true_jacobians(env, torch.as_tensor(
        np.asarray(pts, np.float64).reshape(-1, env.spec.nx + env.spec.nu),
        dtype=F64, device=dev))
    return list(zip(A.cpu().numpy(), B.cpu().numpy()))


def equilibrium_jacobians(env: Env, x_eq, u_eq, device=None):
    return vertex_jacobians(env, np.concatenate([x_eq, u_eq])[None],
                            device)[0]


def _weighted_rho(P, AB, K) -> float:
    """max over the vertices of || P^{1/2} (A + B K) P^{-1/2} ||_2."""
    w, V = np.linalg.eigh(P)
    P_half = V @ np.diag(np.sqrt(w)) @ V.T
    P_half_inv = V @ np.diag(1.0 / np.sqrt(w)) @ V.T
    rho = 0.0
    for A, B in AB:
        rho = max(rho, np.linalg.norm(P_half @ (A + B @ K) @ P_half_inv, 2))
    return float(rho)


def synthesize(env: Env, x_eq, u_eq, Qx, Qu, x_min, x_max, u_min, u_max,
               vertices=None, device=None) -> TerminalSet:
    """Riccati-based terminal ingredients with vertex verification.

    Args:
        vertices: optional (N, nx+nu) linearization points for the
            contraction check (defaults to the equilibrium only).
    """
    A0, B0 = equilibrium_jacobians(env, x_eq, u_eq, device)
    Qx = np.asarray(Qx, dtype=np.float64)
    Qu = np.asarray(Qu, dtype=np.float64)
    P = scipy.linalg.solve_discrete_are(A0, B0, Qx, Qu)
    # negate the DARE gain into the config convention: the controller
    # applies u = -K(x_eq - x), so the stabilizing config gain is -K_dare
    # (matching the signs of the published terminal_tightening.K values)
    K = -np.linalg.inv(Qu + B0.T @ P @ B0) @ (B0.T @ P @ A0)

    pts = (np.asarray(vertices) if vertices is not None
           else np.concatenate([x_eq, u_eq])[None])
    rho = _weighted_rho(P, vertex_jacobians(env, pts, device), K)

    # largest delta with the ellipse inside the state box and the feedback
    # inputs -K(x_eq - x) inside the input box:
    # support of the ellipse along e_i is sqrt(e_i' P^-1 e_i) * delta
    P_inv = np.linalg.inv(P)
    x_eq = np.asarray(x_eq)
    deltas = []
    for i in range(P.shape[0]):
        r = np.sqrt(P_inv[i, i])
        if r > 1e-12:
            deltas.append((x_max[i] - x_eq[i]) / r)
            deltas.append((x_eq[i] - x_min[i]) / r)
    KPK = K @ P_inv @ K.T
    u_eq_fb = np.asarray(u_eq)
    for i in range(K.shape[0]):
        r = np.sqrt(KPK[i, i])
        if r > 1e-12:
            deltas.append((u_max[i] - u_eq_fb[i]) / r)
            deltas.append((u_eq_fb[i] - u_min[i]) / r)
    delta = float(max(min(deltas), 0.0)) if deltas else 0.0
    return TerminalSet(P=P, K=K, delta=delta, rho=rho)


# ---------------------------------------------------------------------------
# min -logdet LMI synthesis (the reference's cvxpy SDP, re-implemented as a
# log-barrier Newton method; ref: extra/pendulum_mpi.py:106-165,
# car_mpi.py:14-60).  The problem is a MAXDET program over
#     E (nx,nx) PSD,  Y (nu,nx):
#   max  logdet E
#   s.t. [[rho^2 E, (A_v E + B_v Y)'], [A_v E + B_v Y, E]] >= 0   per vertex
#        a_i' E a_i <= b_i^2                                      state rows
#        [[b_u^2, a_u' Y], [Y' a_u, E]] >= 0                      input rows
# Variables number ~nx(nx+1)/2 + nu*nx (<= ~20 for the shipped envs), so a
# dense damped-Newton barrier method with torch.func.hessian is exact.


def _logdet_psd(M):
    """logdet via Cholesky; NaN outside the cone (the line search rejects
    it)."""
    L, info = torch.linalg.cholesky_ex(M)
    ld = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return torch.where(info == 0, ld, torch.full_like(ld, float("nan")))


def synthesize_lmi(env: Env, x_eq, u_eq, rho: float, x_min, x_max,
                   u_min, u_max, vertices=None, mu_final: float = 1e-7,
                   newton_iters: int = 60, device=None) -> TerminalSet:
    """Maximum-volume invariant ellipse {(x-xe)' P (x-xe) <= 1} with gain K.

    Where :func:`synthesize` picks the Riccati P and only VERIFIES the
    certificate, this OPTIMIZES the set volume subject to it, like the
    reference's SDP.  Float64 on ``device``.  Returns TerminalSet(P=E^-1,
    K=Y E^-1, delta=1, rho).
    """
    dev = setup.resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=F64,
                                  device=dev)
    nx, nu = env.spec.nx, env.spec.nu
    x_eq = np.asarray(x_eq, dtype=np.float64)
    u_eq = np.asarray(u_eq, dtype=np.float64)
    pts = (vertices if vertices is not None
           else np.concatenate([x_eq, u_eq])[None])
    AB = vertex_jacobians(env, pts, dev)
    A_list = t(np.stack([ab[0] for ab in AB]))
    B_list = t(np.stack([ab[1] for ab in AB]))

    # axis-aligned box rows around the equilibrium
    bx = t(np.minimum(np.asarray(x_max, np.float64) - x_eq,
                      x_eq - np.asarray(x_min, np.float64)))
    bu = t(np.minimum(np.asarray(u_max, np.float64) - u_eq,
                      u_eq - np.asarray(u_min, np.float64)))

    iu, ju = np.triu_indices(nx)
    n_e = len(iu)
    iu_t, ju_t = t(iu).long(), t(ju).long()

    def unpack(z):
        E = torch.zeros((nx, nx), dtype=F64, device=dev).index_put(
            (iu_t, ju_t), z[:n_e])
        E = E + E.T - torch.diag(torch.diagonal(E))
        return E, z[n_e:].reshape(nu, nx)

    rho2 = float(rho) ** 2

    def barrier(z, mu):
        E, Y = unpack(z)
        f = -_logdet_psd(E)
        AEBY = A_list @ E + B_list @ Y                      # (V, nx, nx)
        Eb = E.expand_as(AEBY)
        lmi = torch.cat([torch.cat([rho2 * Eb, AEBY.transpose(-1, -2)], -1),
                         torch.cat([AEBY, Eb], -1)], -2)
        f = f - mu * torch.sum(_logdet_psd(lmi))
        # state rows: slack s_i = b_i^2 - E_ii  (a_i = e_i)
        f = f - mu * torch.sum(torch.log(bx * bx - torch.diagonal(E)))
        # input rows: Schur scalar  b_u^2 - a_u' Y E^-1 Y' a_u >= 0
        quad = torch.diagonal(Y @ torch.linalg.solve(E, Y.T))  # (nu,)
        return f - mu * torch.sum(torch.log(bu * bu - quad))

    grad = torch.func.grad(barrier)
    hess = torch.func.hessian(barrier)

    # strictly feasible start: a small copy of the RICCATI ellipse
    # E = c P0^-1 with the Riccati gain.  (With Y = K E the contraction
    # block reduces to ||E^-1/2 (A+BK) E^1/2|| <= rho, so the start's
    # shape matters: a ball tests the raw spectral norm, which exceeds 1
    # for perfectly stable closed loops — the P-weighted norm is the one
    # the certificate bounds.)  Shrink c until every barrier is finite.
    ts0 = synthesize(env, x_eq, u_eq, np.eye(nx), np.eye(nu),
                     np.asarray(x_min), np.asarray(x_max),
                     np.asarray(u_min), np.asarray(u_max),
                     vertices=vertices, device=dev)
    P0_inv = np.linalg.inv(ts0.P)
    P0_inv = P0_inv / np.linalg.norm(P0_inv, 2)
    c = 1e-2 * float(torch.min(bx) ** 2)
    z = None
    for _ in range(40):
        E0 = c * P0_inv
        Y0 = np.asarray(ts0.K) @ E0
        cand = t(np.concatenate([E0[iu, ju], Y0.ravel()]))
        if np.isfinite(float(barrier(cand, 1.0))):
            z = cand
            break
        c *= 0.5
    if z is None:
        raise ValueError(
            "no strictly feasible start: the Riccati gain does not achieve "
            f"the requested contraction rho={rho} on the vertex set "
            f"(its P-weighted vertex rho is {ts0.rho:.4f}); pass a larger "
            "rho or a tighter vertex set")

    eye = torch.eye(z.shape[0], dtype=F64, device=dev)
    mu = 1.0
    while mu >= mu_final:
        for _ in range(newton_iters):
            g = grad(z, mu)
            step = torch.linalg.solve(hess(z, mu) + 1e-10 * eye, g)
            # backtracking: stay strictly inside every cone
            s, f0 = 1.0, float(barrier(z, mu))
            for _ls in range(50):
                z_new = z - s * step
                f_new = float(barrier(z_new, mu))
                if np.isfinite(f_new) and f_new < f0 + 1e-12:
                    break
                s *= 0.5
            else:
                break
            z = z_new
            if float(torch.dot(g, step)) < 1e-10:
                break
        mu *= 0.1

    E, Y = unpack(z)
    P = np.linalg.inv(E.cpu().numpy())
    K = Y.cpu().numpy() @ P
    # a-posteriori contraction over the vertex set (certificate check)
    return TerminalSet(P=P, K=K, delta=1.0, rho=_weighted_rho(P, AB, K))
