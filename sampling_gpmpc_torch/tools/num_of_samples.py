"""Sample-count calculator: how many GP dynamics samples does safety need?

End-to-end re-derivation of the reference's epsilon(N) workflow
(ref: extra/compute_num_samples/num_of_samples.py:1-73,
plot_SMP_eps.py:68-106) on the port's GP core, in float64 on the device:

1. C_D — the change-of-measure exponent between the posterior-mean-centered
   GP and the true function (true RKHS norm from a 10x-denser grid of the
   same analytic prior, num_of_samples.py:31-37).
2. B_phi(N_grid) — Monte-Carlo small-ball probability that a posterior draw
   stays within ``dyn_eps`` of the mean uniformly over an N_grid^D grid of
   the GP input box, swept over eps offsets (plot_SMP_eps.py:68-88).
3. eps(N_grid, p) — the deviation quantile achieving ball-probability p
   (helper.py:368-469, plot_SMP_eps.py:90-106).
4. N(delta) = log(delta) / log(1 - exp(-C_D) B_phi) — the headline count
   (num_of_samples.py:69).

Run:  python -m sampling_gpmpc_torch.tools.num_of_samples \
          -param params_pendulum1D_samples [--device cpu] [--out figures/]
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.tools import sample_complexity as sc


def _train_values(params, spec, gp_idx: int):
    """(Z, y): training inputs + VALUE observations of output ``gp_idx``."""
    from sampling_gpmpc_torch.envs import make_env
    X, Y = make_env(spec, params).training_grid()
    return np.asarray(X), np.asarray(Y[gp_idx, :, 0])


def _dense_params(params, factor: int = 10):
    dense = copy.deepcopy(params)
    dense["env"]["n_data_x"] *= factor
    dense["env"]["n_data_u"] *= factor
    return dense


def run(params, spec, data, gp_idx: int = 0, delta: float = 0.001,
        n_grid_max: int = 8, n_mc: int = 200_000, dense_factor: int = 10,
        eps_offsets=(-2e-4, 0.0, 2e-4), probs=(0.5, 0.7, 0.9),
        seed: int = 0, draws=None, device=None) -> dict:
    """Full pipeline for one config; returns every curve and the final N.

    Args:
        draws: optional {n_grid: (n_mc, n_grid^D) standard normals} used
            instead of the device generator's (seeded from ``seed`` and
            the grid size).
        device: where the posteriors and the draws run (CUDA unless given).
    """
    from sampling_gpmpc_torch.config import make_spec

    dev = setup.resolve_device(device)
    hyp = spec.gp
    ls = np.asarray(hyp.lengthscale[gp_idx])
    os_ = float(hyp.outputscale[gp_idx])
    lam = float(hyp.noise)
    lam_total = lam + float(hyp.task_noises[0])
    tight = params["agent"]["tight"]
    w_bound = float(tight.get("w_bound", 0.0))
    dyn_eps = float(tight.get("dyn_eps", 0.0))

    Z, y = _train_values(params, spec, gp_idx)
    dense = _dense_params(params, dense_factor)
    Z_dense, y_dense = _train_values(dense, make_spec(dense), gp_idx)

    cd = sc.change_of_measure_cd(Z, y, Z_dense, y_dense, ls, os_, lam,
                                 lam_total, w_bound, dev)
    beta = sc.info_beta(Z, ls, os_, lam, device=dev)

    grids = list(range(1, n_grid_max + 1))
    # one deviation draw per grid size, reused across the eps sweep and the
    # quantile curves (the reference redraws 1e6 samples per (eps, N) cell;
    # the sweep only needs the order statistics of ONE draw per N)
    devs = {}
    for n in grids:
        grid = sc.gp_input_grid(spec, data, n)
        gen = None
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(
                1_000_003 * seed + n)
        devs[n] = sc.max_deviation_samples_chunked(
            Z, y, grid, ls, os_, lam, n_mc, gen,
            eps=None if draws is None else draws[n], device=dev)

    b_phi = {off: [float(np.mean(devs[n] <= dyn_eps + off)) for n in grids]
             for off in eps_offsets}
    eps_curves = {p: [float(np.quantile(devs[n], p)) for n in grids]
                  for p in probs}

    # the headline N(delta) uses the small-ball probability AT dyn_eps
    # itself (offset 0), independent of which sweep offsets were requested
    p_ball = float(np.mean(devs[grids[-1]] <= dyn_eps))
    n_req = sc.num_samples_with_measure_shift(cd["Cd"], p_ball, delta)
    return {"grids": grids, "b_phi": b_phi, "eps_curves": eps_curves,
            "Cd": cd, "beta": beta, "p_ball": p_ball, "delta": delta,
            "dyn_eps": dyn_eps, "num_samples": n_req, "n_mc": n_mc}


def plot(result: dict, out_dir: str) -> list:
    """The two sweep figures of plot_SMP_eps.py (B_phi vs N; eps vs N)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    fig, ax = plt.subplots(figsize=(5, 3.4))
    for off, curve in result["b_phi"].items():
        ax.plot(result["grids"], curve, marker="o",
                label=f"eps = {result['dyn_eps'] + off:.4g}")
    ax.set_xlabel("grid points per dim N")
    ax.set_ylabel(r"small-ball probability $B_\phi$")
    ax.legend(fontsize=7)
    fig.tight_layout()
    p = os.path.join(out_dir, "smb_vs_N.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    paths.append(p)

    fig, ax = plt.subplots(figsize=(5, 3.4))
    for prob, curve in result["eps_curves"].items():
        ax.plot(result["grids"], curve, marker="o", label=f"p = {prob}")
    ax.set_xlabel("grid points per dim N")
    ax.set_ylabel(r"$\epsilon(N)$ deviation quantile")
    ax.legend(fontsize=7)
    fig.tight_layout()
    p = os.path.join(out_dir, "eps_vs_N.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    paths.append(p)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-param", default="params_pendulum1D_samples")
    ap.add_argument("--out", default="figures",
                    help="directory of the two figures (needs matplotlib)")
    ap.add_argument("--n-mc", type=int, default=200_000)
    ap.add_argument("--delta", type=float, default=0.001)
    ap.add_argument("--device", default=None,
                    help="cuda (default) | cpu | cuda:N")
    args = ap.parse_args(argv)

    from sampling_gpmpc_torch.config import load_problem
    dev = setup.resolve_device(args.device)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    params, spec, data = load_problem(
        os.path.join(here, "params", args.param + ".yaml"))
    t0 = time.perf_counter()
    res = run(params, spec, data, n_mc=args.n_mc, delta=args.delta,
              device=dev)
    wall = time.perf_counter() - t0
    cd = res["Cd"]
    print(f"RKHS ||mu||^2 = {cd['mean_norm']:.4f}  ||f||^2(dense) = "
          f"{cd['true_norm']:.4f}  beta = {res['beta']:.3f}")
    print(f"C_D = {cd['Cd']:.4f}  (fit {cd['fit_term']:.4f}, "
          f"|alpha|_1 w = {cd['alpha_l1']:.3f} * w_bound)")
    print(f"B_phi(eps={res['dyn_eps']:.4g}, N={res['grids'][-1]}) = "
          f"{res['p_ball']:.4f}")
    print(f"N({args.delta}) = {res['num_samples']:.1f} dynamics samples")
    print(f"{len(res['grids'])} grid sizes x {args.n_mc} draws in "
          f"{wall:.2f} s on {dev}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("no matplotlib: no figures")
        return res
    for p in plot(res, args.out):
        print(f"figure: {p}")
    return res


if __name__ == "__main__":
    main()
