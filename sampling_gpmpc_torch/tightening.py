"""Finite-sample reachability constraint tightenings.

Host-side numpy re-derivation of the reachable-set ball construction
(ref: src/utils/reachable_set.py:3-39 and the velocity-scaled variant at
src/environments/car_model_residual.py:226-263).

Per stage k >= 1 the epistemic error ball in the P-metric has radius

    B_eps_k = var_eps * ||B_d||_k * sum_{j=0}^{k-1} L^j,

with ``var_eps = dyn_eps + w_bound`` and the (possibly velocity-dependent)
norm of the disturbance input matrix.  The box-constraint tightening per
state is then sqrt(diag(P^-1)) * B_eps_k and per input
sqrt(diag(K P^-1 K^T)) * B_eps_k.
"""

from __future__ import annotations

import numpy as np


def reachable_set_ball(params: dict, V_k: np.ndarray, eps_vec=None):
    """Compute per-stage tightening vectors and tube radii.

    Args:
        params: full experiment config dict.
        V_k: (H+1,) scale profile for ||B_d|| per stage (ones for constant
            B_d; the velocity trajectory for the residual car model).
        eps_vec: optional per-output epsilons replacing the uniform dyn_eps.

    Returns:
        tilde_eps: (H+1, nx+nu+1) array; per stage the state tightenings,
            input tightenings, and the raw ball radius B_eps_k.
        ci: (H,) per-stage tube radii used for dynamics rejection.
    """
    opt = params["optimizer"]
    H = opt["H"]
    V_k = np.asarray(V_k, dtype=np.float64)
    assert V_k.shape[0] == H + 1
    P = np.asarray(opt["terminal_tightening"]["P"], dtype=np.float64)
    K = np.asarray(opt["terminal_tightening"]["K"], dtype=np.float64)
    tight = params["agent"]["tight"]
    L = float(tight["Lipschitz"])
    var_eps = float(tight["dyn_eps"]) + float(tight["w_bound"])

    sqrtP = np.sqrt(np.diag(P)[:3])
    if eps_vec is not None:
        Bd_norm = (sqrtP @ np.asarray(eps_vec) / var_eps) * V_k
    else:
        Bd_norm = np.sum(sqrtP) * V_k

    P_inv = np.linalg.inv(P)
    x_scale = np.sqrt(np.diag(P_inv))
    u_scale = np.sqrt(np.diag(K @ P_inv @ K.T))

    rows = [np.concatenate([x_scale * 0.0, u_scale * 0.0, [0.0]])]
    ci = []
    geo = 0.0
    for stage in range(1, H + 1):
        geo += L ** (stage - 1)
        B_eps = var_eps * Bd_norm[stage - 1] * geo
        rows.append(np.concatenate([x_scale * B_eps, u_scale * B_eps, [B_eps]]))
        ci.append(B_eps)
    return np.stack(rows), np.asarray(ci)
