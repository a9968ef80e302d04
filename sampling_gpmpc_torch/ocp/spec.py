"""OCP data: cost weights, references, bounds, penalties.

Built once from the host :class:`ProblemData`.  The per-stage cost is

    sum_i w_i (x_i,k - xref_k)' Qs (x_i,k - xref_k)  +  u_k' Qu u_k

which covers the reference's "expected" cost (ref: src/utils/ocp.py:148-156,
w_i = 1/ns, xref = goal) and the input-generation lane-change cost
(ref: src/utils/ocp.py:141-146).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.config import ProblemData, ProblemSpec


class OCPData(NamedTuple):
    Qs: torch.Tensor          # (nx, nx) stage state weight
    Qe: torch.Tensor          # (nx, nx) terminal state weight
    Qu: torch.Tensor          # (nu, nu)
    xref: torch.Tensor        # (H+1, nx); row H is the terminal reference
    w_cost: torch.Tensor      # (ns,) per-sample cost weights
    lm: torch.Tensor          # scalar Levenberg-Marquardt
    u_lo: torch.Tensor        # (nu,) bounds on the OCP input variable
    u_hi: torch.Tensor
    x_lo: torch.Tensor        # (H+1, nx) per-stage (tightened) state bounds
    x_hi: torch.Tensor
    fb_lo: torch.Tensor       # (H, nu) bounds on the realized feedback input
    fb_hi: torch.Tensor
    K_fb: torch.Tensor        # (nu, nx) ancillary gain (zeros if unused)
    x_eq: torch.Tensor        # (nx,) feedback equilibrium (goal state)
    P_term: torch.Tensor      # (nx, nx) terminal ellipse metric (zeros if unused)
    delta_sq: torch.Tensor    # scalar delta^2
    ellipses: torch.Tensor    # (n_ell, 5)
    start: torch.Tensor       # (nx,)
    # soft-constraint penalties (acados z/Z convention: z's + 0.5 s'Zs)
    zl_term: torch.Tensor
    zu_term: torch.Tensor
    Zl_term: torch.Tensor
    Zu_term: torch.Tensor
    zl_path: torch.Tensor
    zu_path: torch.Tensor
    Zl_path: torch.Tensor
    Zu_path: torch.Tensor


def make_ocp_data(spec: ProblemSpec, data: ProblemData, device=None,
                  dtype=None) -> OCPData:
    device, dtype = setup.resolve(device, dtype)
    H, nx, nu, ns = spec.H, spec.nx, spec.nu, spec.ns
    Qx = np.asarray(data.Qx)
    if spec.input_generation:
        Qs = np.zeros((nx, nx))
        Qs[1, 1] = Qx[1, 1]
        Qs[3, 3] = Qx[3, 3]
        Qe = np.zeros((nx, nx))
        Qe[1, 1] = Qx[1, 1]
        xref = np.zeros((H + 1, nx))
        xref[:, 1] = data.w_profile
        xref[:, 3] = data.x_max[3]
        xref[H] = 0.0
        xref[H, 1] = 1.95
        w_cost = np.zeros(ns)
        w_cost[0] = 1.0 / ns
    else:
        Qs = Qx
        Qe = Qx
        xref = np.tile(data.goal, (H + 1, 1))
        if spec.cost_mean_only:
            w_cost = np.zeros(ns)
            w_cost[0] = 1.0
        else:
            w_cost = np.full(ns, 1.0 / ns)

    x_lo = np.tile(data.x_min, (H + 1, 1))
    x_hi = np.tile(data.x_max, (H + 1, 1))
    fb_lo = np.tile(data.u_min, (H, 1))
    fb_hi = np.tile(data.u_max, (H, 1))
    if spec.use_tightening:
        x_lo = x_lo + data.tilde_eps[:, :nx]
        x_hi = x_hi - data.tilde_eps[:, :nx]
        if spec.env_name == "Pendulum1D":
            fb_lo = fb_lo + data.tilde_eps[:H, nx:nx + nu]
            fb_hi = fb_hi - data.tilde_eps[:H, nx:nx + nu]

    if spec.use_feedback:
        u_lo, u_hi = data.v_min, data.v_max
        K = data.K_fb
    else:
        u_lo, u_hi = data.u_min, data.u_max
        K = np.zeros((nu, nx))

    P_term = data.P_term if data.P_term is not None else np.zeros((nx, nx))

    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    return OCPData(
        Qs=f(Qs), Qe=f(Qe), Qu=f(data.Qu), xref=f(xref), w_cost=f(w_cost),
        lm=f(spec.levenberg_marquardt),
        u_lo=f(u_lo), u_hi=f(u_hi), x_lo=f(x_lo), x_hi=f(x_hi),
        fb_lo=f(fb_lo), fb_hi=f(fb_hi),
        K_fb=f(K), x_eq=f(data.goal),
        P_term=f(P_term), delta_sq=f(data.delta_term ** 2),
        ellipses=f(data.ellipses), start=f(data.start),
        # acados slack penalties (ref: ocp.py:205-215 terminal, :279-287 path)
        zl_term=f(1e7), zu_term=f(1e6), Zl_term=f(1e7), Zu_term=f(1e6),
        zl_path=f(1e6), zu_path=f(1e5), Zl_path=f(1e6), Zu_path=f(1e5),
    )
