"""Robust-tube GP-MPC baseline (B6): Koller one-step ellipsoidal reachability.

Counterpart of ``benchmarking/robust_tube_baseline.py``, the outer-ellipsoid
propagation of Koller et al. 2018 ("Learning-based MPC for safe
exploration") that the reference pulls from the safe-exploration repo
(ref: benchmarking/robust_tube_based_GPMPC_koller.py:27-28,295-307).  For
the tube E_k = {x : (x-c)' Q^-1 (x-c) <= 1} under the ancillary feedback
u = u_ff + k_fb (c - x_equi) (ref script :276-279):

    z_bar  = (c, u_eff)                      linearization point
    c+     = mu(z_bar)                       posterior-mean dynamics
    A_cl   = d mu/dx + d mu/du @ k_fb        closed-loop Jacobian
    r      = sup_{x in E_k} ||(x-c, k_fb(x-c))||        joint deviation
    b_lin  = 0.5 * l_mu * r^2                Taylor remainder, per dim
    b_sig  = beta * (sigma(z_bar) + l_sigma * r)        GP confidence on E_k
    Q+     = mink(A_cl Q A_cl', nx * diag((b_lin+b_sig)^2))

with per-dimension Lipschitz constants l_mu (of the mean Jacobian) and
l_sigma (of the posterior std) estimated from the recorded trajectory by
the pairwise-ratio estimator (ref script :35-44,202-236).  Plain torch on
the card, as the JAX package leaves it to XLA.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.robust_tube_baseline \\
        -param params_car_residual -i 42 [--steps 30] [--no-feedback]
    ... --device cpu   # float64 on the CPU

Writes the reference's four overlays (:313-325): koller_ellipse_data.pkl
(per-stage (2, 100) polylines), koller_ellipse_center_data.pkl,
koller_mean_data.pkl and koller_true_data.pkl, next to run ``-i``'s
artifact (or into ``--out``), which ``sampling_gpmpc_torch.visu_main
--plot-koller`` overlays.
"""

import argparse
import os
import pickle

import numpy as np
import torch


def minkowski_ellipsoid(Q1, Q2, eps=1e-12):
    """Outer ellipsoid of E(Q1) + E(Q2): (1+1/p) Q1 + (1+p) Q2 with the
    trace-optimal p = sqrt(tr Q2 / tr Q1)."""
    t1 = torch.trace(Q1)
    t2 = torch.trace(Q2)
    p = torch.sqrt((t2 + eps) / (t1 + eps))
    Q_sum = (1.0 + 1.0 / p) * Q1 + (1.0 + p) * Q2
    Q_sum = torch.where(t1 <= eps, Q2, Q_sum)
    return torch.where(t2 <= eps, Q1, Q_sum)


def mean_dyn_and_sigma(spec, env, hyp, Z, Y, xu):
    """Posterior-mean dynamics value+Jacobian and full-state std.

    ``xu`` (..., nx+nu): every point is predicted alone.  Returns (comb
    (..., nx, 1+nx+nu), sigma (..., nx)): the derivative GP's posterior
    mean of the gradient tasks is the gradient of the posterior mean, so
    ``assemble_val_jac`` on the mean rows gives the closed-form Jacobian
    the reference gets from autograd (:243-246)."""
    from sampling_gpmpc_torch.linearization_baseline import posterior_rows
    rows, var = posterior_rows(spec, hyp, Z[:1], Y[:1], xu)
    comb = env.assemble_val_jac(xu, rows)
    Bd = env.B_d_dyn(xu)
    sig_g = torch.sqrt(torch.clamp(var[..., 0], min=0.0))
    S = Bd @ torch.diag_embed(sig_g * sig_g) @ Bd.transpose(-1, -2)
    sigma = torch.sqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1),
                                   min=0.0))
    return comb, sigma


def pairwise_lipschitz(x_grid, f_grid):
    """max over pairs of ||f_a - f_b|| / ||x_a - x_b|| (ref script :35-44).

    ``x_grid`` (N, d), ``f_grid`` (N, ...) the function on that grid."""
    dx = torch.linalg.norm(x_grid[:, None, :] - x_grid[None, :, :], dim=-1)
    f = f_grid.reshape(f_grid.shape[0], -1)
    df = torch.linalg.norm(f[:, None, :] - f[None, :, :], dim=-1)
    return torch.max(df / (dx + 1e-6))


def estimate_lipschitz_from_traj(spec, env, hyp, Z, Y, X_traj, U_traj):
    """Per-state-dim l_mu (of the mean Jacobian) and l_sigma (of sigma)
    over the recorded trajectory grid (ref script :202-236).

    Args:
        X_traj: (T+1, nx) states; U_traj: (T, nu) inputs.
    """
    xu = torch.cat([X_traj[:-1], U_traj], dim=-1)
    comb, sigma = mean_dyn_and_sigma(spec, env, hyp, Z, Y, xu)
    jac = comb[:, :, 1:]                       # (T, nx, nx+nu)
    l_mu = torch.stack([pairwise_lipschitz(X_traj[:-1], jac[:, i])
                        for i in range(jac.shape[1])])
    l_sig = torch.stack([pairwise_lipschitz(X_traj[:-1], sigma[:, i, None])
                         for i in range(sigma.shape[1])])
    return torch.clamp(l_mu, min=1e-6), torch.clamp(l_sig, min=1e-6)


def spectral_norm(M):
    """Largest singular value; inf for a matrix that is not finite (where
    the JAX package's norm gives NaN, which the explosion freeze catches
    alike; LAPACK would refuse the matrix)."""
    finite = torch.isfinite(M).all()
    n = torch.linalg.matrix_norm(torch.where(finite, M, 0.0), ord=2)
    return torch.where(finite, n, float("inf"))


def propagate_tube(spec, env, hyp, gp, x0, U, k_fb, x_equi, l_mu, l_sig,
                   beta):
    """Koller one-step recursion over the horizon.

    Args:
        gp: GP state of a one-sample spec; x0 (nx,), U (T, nu), x_equi,
            l_mu, l_sig (nx,) tensors; k_fb (nu, nx) array or tensor.
    Returns:
        centers (T+1, nx), shapes Q (T+1, nx, nx), mean values (T, nx).
    """
    from sampling_gpmpc_torch import agent as agent_mod
    nx = spec.nx
    Z, Y = agent_mod.full_train_set(spec, gp)
    K = torch.as_tensor(k_fb, dtype=x0.dtype, device=x0.device)
    c = x0
    Q = torch.zeros((nx, nx), dtype=x0.dtype, device=x0.device)
    cs, Qs, means = [c], [Q], []
    for u_ff in U:
        u_eff = u_ff + K @ (c - x_equi)
        comb, sigma = mean_dyn_and_sigma(spec, env, hyp, Z, Y,
                                         torch.cat([c, u_eff]))
        c_next = comb[:, 0]
        A_cl = comb[:, 1:1 + nx] + comb[:, 1 + nx:] @ K
        # joint (x, u) deviation radius over E(Q) under the feedback: the
        # spectral norms, not the Frobenius
        lam_x = spectral_norm(Q)
        lam_u = spectral_norm(K @ Q @ K.T)
        r = torch.sqrt(torch.clamp(lam_x + lam_u, min=0.0))
        b = 0.5 * l_mu * r * r + beta * (sigma + l_sig * r)
        Q_next = minkowski_ellipsoid(A_cl @ Q @ A_cl.T,
                                     nx * torch.diag(b * b))
        # the recursion explodes on long horizons (the papers' comparison
        # point); once non-finite, keep the last finite tube, as the
        # reference's NaN guard does (ref script :288-292)
        ok = torch.isfinite(Q_next).all() & torch.isfinite(c_next).all()
        Q = torch.where(ok, Q_next, Q)
        c = torch.where(ok, c_next, c)
        cs.append(c)
        Qs.append(Q)
        means.append(c)
    return torch.stack(cs), torch.stack(Qs), torch.stack(means)


def ellipse_polyline(c, Q, dims=(0, 1), n=100):
    """(2, n) boundary polyline of the ellipsoid slice in plot dims
    (ref script :307-312 draws chol(Q)' applied to the unit circle)."""
    Qp = np.asarray(Q)[np.ix_(dims, dims)]
    w, V = np.linalg.eigh(Qp)
    R = V * np.sqrt(np.clip(w, 0.0, None))[None, :]
    t = np.linspace(0, 2 * np.pi, n)
    z = np.stack([np.cos(t), np.sin(t)])
    return R @ z + np.asarray(c)[list(dims)].reshape(-1, 1)


def true_rollout(env, x0, U, k_fb, x_equi):
    """The true dynamics along the same inputs and feedback: (T+1, nx)."""
    K = torch.as_tensor(k_fb, dtype=x0.dtype, device=x0.device)
    xs = [x0]
    for u in U:
        x = xs[-1]
        xs.append(env.discrete_dyn(x, u + K @ (x - x_equi)).reshape(-1))
    return torch.stack(xs)


def write_overlays(out_dir, cs, Qs, means, true_traj):
    """The four koller_*.pkl overlays of the reference script (:313-325)."""
    os.makedirs(out_dir, exist_ok=True)
    T = len(means)
    dump = {
        "koller_ellipse_data.pkl":
            [ellipse_polyline(cs[t], Qs[t]) for t in range(1, T + 1)],
        "koller_ellipse_center_data.pkl":
            [cs[t].reshape(-1, 1) for t in range(1, T + 1)],
        "koller_mean_data.pkl": [m.reshape(-1, 1) for m in means],
        "koller_true_data.pkl": [x.reshape(-1, 1) for x in true_traj[1:]],
    }
    for name, obj in dump.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            pickle.dump(obj, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description="robust-tube baseline")
    parser.add_argument("-param", default="params_car_residual")
    parser.add_argument("-env", type=int, default=0)
    parser.add_argument("-i", type=int, default=None,
                        help="run index: read its artifact and write the "
                             "koller_*.pkl overlays next to it")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--data", default=None)
    parser.add_argument("--no-feedback", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    args = parser.parse_args(argv)

    from sampling_gpmpc_torch import agent as agent_mod
    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.linearization_baseline import (
        first_inputs, one_sample_problem)
    device, dtype = setup.resolve(args.device)
    params, spec, data, env, hyp, gp = one_sample_problem(args.param,
                                                          device, dtype)
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run_dir = None
    data_path = args.data
    if args.i is not None:
        run_dir = os.path.join(here, "experiments",
                               params["experiment"]["folder"],
                               f"env_{args.env}", args.param, str(args.i))
        data_path = data_path or os.path.join(run_dir, "data.pkl")
    X_traj = None
    if data_path and os.path.exists(data_path):
        with open(data_path, "rb") as f:
            rec = pickle.load(f)
        U = t_(first_inputs(rec, args.steps))
        X_traj = t_(np.asarray(rec["physical_state_traj"])
                    [:args.steps + 1, :spec.nx])
    else:
        U = t_(np.zeros((args.steps, spec.nu)))
    x0 = t_(data.start)
    if args.no_feedback or data.K_fb is None:
        k_fb = np.zeros((spec.nu, spec.nx))
    else:
        # config convention u = -K(x_eq - x) = K(x - x_eq)
        k_fb = np.asarray(data.K_fb)
    x_equi = t_(data.goal)

    Z, Y = agent_mod.full_train_set(spec, gp)
    if X_traj is not None and X_traj.shape[0] > 2:
        l_mu, l_sig = estimate_lipschitz_from_traj(
            spec, env, hyp, Z, Y, X_traj, U[:X_traj.shape[0] - 1])
    else:
        l_mu = l_sig = t_(np.full(spec.nx, 0.1))
    cs, Qs, means = propagate_tube(spec, env, hyp, gp, x0, U, k_fb, x_equi,
                                   l_mu, l_sig, spec.gp.beta)
    true_traj = true_rollout(env, x0, U, k_fb, x_equi)
    cs, Qs, means, true_traj = (a.cpu().numpy()
                                for a in (cs, Qs, means, true_traj))
    out_dir = (run_dir if run_dir is not None else
               (args.out or os.path.join(here, "experiments",
                                         "reachability")))
    write_overlays(out_dir, cs, Qs, means, true_traj)
    print(f"l_mu = {l_mu.cpu().numpy()}")
    print(f"l_sigma = {l_sig.cpu().numpy()}")
    print(f"propagated {len(means)} stages on {device} {dtype} -> "
          f"{out_dir}/koller_*.pkl")
    print("final center:", cs[-1])
    print("final tube radii:", np.sqrt(np.abs(np.diag(Qs[-1]))))


if __name__ == "__main__":
    main()
