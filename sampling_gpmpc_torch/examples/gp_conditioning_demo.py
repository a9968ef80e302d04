"""Iterative GP conditioning (E7), the port's counterpart of
``examples/gp_conditioning_demo.py``.

Reproduces the reference's conditioning demos (ref:
extra/plot_GP_conditioning.py, conditioning_gp.py, sample_gp.py): draw a
few GP function realizations of a 1-D problem at a handful of points,
then condition each realization on its own draws and re-sample it on a
grid: each realization passes through its conditioned points, the
mechanism behind sampling within SQP.  float64 on ``gp/exact.py``
(``factor_real``, ``condition_update``, ``predict_update``,
``posterior_sample``); the standard-normal draws are injectable.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.examples.gp_conditioning_demo \\
        [--device cpu] [--plot --out experiments/gp_conditioning_demo.png]

Prints how far each re-sampled realization lies from its conditioned
points; the figure is drawn with ``--plot`` only (matplotlib is imported
then).
"""

import argparse
import os

import numpy as np

LS, OS, NOISE = (0.6,), 1.0, (1e-6,)
JITTER, DRAW_JITTER = 1e-10, 1e-8
N_REALIZATIONS = 4
REAL_Z = np.linspace(-1.5, 1.5, 5)[:, None]
GRID = np.linspace(-2, 2, 120)[:, None]
COND_PTS = np.array([[-0.8], [0.2], [1.1]])


def truth(x):
    return np.sin(3 * x) * 0.8


def draws(generator, n: int = N_REALIZATIONS):
    """Standard-normal draws: (n, points) at the conditioning points and
    (n, grid) on the grid."""
    import torch
    f = lambda k: torch.randn((n, k), generator=generator,  # noqa: E731
                              dtype=torch.float64).numpy()
    return f(COND_PTS.shape[0]), f(GRID.shape[0])


def run(eps_points, eps_grid, device="cpu") -> dict:
    """The demo's two stages.

    Args:
        eps_points: (n, 3) draws at the conditioning points (stage 1);
        eps_grid: (n, 120) draws on the grid (stage 2).
    Returns:
        {"samples" (n, 3): each realization's draws at the points,
         "draws" (n, 120): its re-sampled function on the grid,
         "mean", "sd" (120,): the real-data posterior on the grid}.
    """
    import torch

    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.gp import exact
    dev = setup.resolve_device(device)
    t_ = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,  # noqa
                                   device=dev)
    ls, noise = t_(LS), t_(NOISE)
    Zr, grid, pts = t_(REAL_Z), t_(GRID), t_(COND_PTS)
    rf = exact.factor_real(Zr, t_(truth(REAL_Z)), ls, OS, noise, JITTER,
                           False)
    empty_Z = t_(np.full((1, 1), 1e5))
    empty_Y = t_(np.full((1, 1), np.nan))
    uf0 = exact.condition_update(rf, Zr, empty_Z, empty_Y, ls, OS, noise,
                                 JITTER, False)
    mean_p, cov_p = exact.predict_update(pts, Zr, empty_Z, rf, uf0, ls, OS,
                                         False)
    samples = [exact.posterior_sample(mean_p, cov_p, t_(e), JITTER)
               for e in eps_points]
    mg, cg = exact.predict_update(grid, Zr, empty_Z, rf, uf0, ls, OS, False)
    out = []
    for s, e in zip(samples, eps_grid):
        # condition this realization on its own draws and draw the whole
        # function: it passes through its points
        ufi = exact.condition_update(rf, Zr, pts, s[:, None], ls, OS, noise,
                                     JITTER, False)
        mgi, cgi = exact.predict_update(grid, Zr, pts, rf, ufi, ls, OS,
                                        False)
        out.append(exact.posterior_sample(mgi, cgi, t_(e), DRAW_JITTER))
    host = lambda a: a.cpu().numpy()  # noqa: E731
    return {"samples": host(torch.stack(samples)),
            "draws": host(torch.stack(out)), "mean": host(mg),
            "sd": np.sqrt(np.clip(np.diag(host(cg)), 0, None))}


def pinning_error(res: dict) -> float:
    """Largest distance of a re-sampled realization from its conditioned
    draws, read off the grid by linear interpolation."""
    err = 0.0
    for s, d in zip(res["samples"], res["draws"]):
        at = np.interp(COND_PTS[:, 0], GRID[:, 0], d)
        err = max(err, float(np.max(np.abs(at - s))))
    return err


def plot(res: dict, path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
    colors = plt.cm.viridis(np.linspace(0.1, 0.85, len(res["samples"])))
    for stage, ax in enumerate(axes):
        ax.fill_between(GRID[:, 0], res["mean"] - 2 * res["sd"],
                        res["mean"] + 2 * res["sd"], alpha=0.15,
                        color="gray")
        ax.plot(GRID[:, 0], truth(GRID)[:, 0], "k--", alpha=0.5,
                label="truth")
        ax.plot(REAL_Z[:, 0], truth(REAL_Z)[:, 0], "ko", ms=5, label="data")
        for i, c in enumerate(colors):
            if stage == 1:
                ax.plot(GRID[:, 0], res["draws"][i], color=c, lw=1.2)
            ax.plot(COND_PTS[:, 0], res["samples"][i], "x", color=c, ms=9,
                    mew=2)
    axes[0].set_title("function-value samples at the SQP points")
    axes[1].set_title("realizations re-sampled after self-conditioning")
    axes[0].legend(loc="lower left", fontsize=8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=200, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="iterative GP conditioning")
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--out",
                        default="experiments/gp_conditioning_demo.png")
    args = parser.parse_args(argv)
    import torch
    res = run(*draws(torch.Generator().manual_seed(args.seed)), args.device)
    print(f"{len(res['samples'])} realizations: re-sampled functions within "
          f"{pinning_error(res):.2e} of their conditioned draws")
    if args.plot:
        plot(res, args.out)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
