"""Reachable-set coverage metrics (E9), the port's entry point.

Counterpart of ``benchmarking/reachable_set_coverage.py`` (ref:
extra/reachable_set_coverage.py): how well the sampled prediction covers
the true reachable set, per prediction stage:

* hull-volume ratio  vol(hull(predicted samples)) / vol(hull(MC truth)),
  the reference's ``hull_vol_opt_true_ratio`` (ref:
  extra/reachable_set_coverage.py:76-88); >= 1 means the prediction is at
  least as wide as the truth in volume;
* point-coverage fraction: the share of Monte-Carlo truth states inside
  the predicted hull (a shifted hull can have ratio 1 and coverage 0).

Inputs: a closed-loop or plan ``data.pkl`` (``sampling_gpmpc_torch.main``)
and the Monte-Carlo pickles of ``sampling_gpmpc_torch.
simulate_true_reachable_set`` or ``simulate_forward_sampling``.  numpy and
scipy only; the config comes from the port's ``config.load_problem``.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.reachable_set_coverage \\
        -param params_pendulum1D_samples --data experiments/.../data.pkl \\
        --mc-dir experiments/reachability/params_pendulum1D_samples_mc \\
        [--plot]

Writes ``coverage.json`` (the per-stage table), and ``coverage.png`` with
``--plot`` (matplotlib is imported only then), into ``--out`` or the MC
directory, and prints the summary row (min/mean over stages).
"""

import argparse
import glob
import json
import os
import pickle

import numpy as np


def hull_volume(pts: np.ndarray) -> float:
    """Convex-hull volume of (N, d) points; 0.0 when degenerate."""
    from scipy.spatial import ConvexHull, QhullError
    try:
        return float(ConvexHull(pts).volume)
    except (QhullError, ValueError):
        return 0.0


def _interval_coverage(pred_pts: np.ndarray, true_pts: np.ndarray) -> float:
    """Axis-aligned fallback: truth fraction inside pred's bounding box."""
    lo, hi = pred_pts.min(0), pred_pts.max(0)
    pad = 1e-9 * np.maximum(1.0, np.abs(hi - lo))
    inside = np.all((true_pts >= lo - pad) & (true_pts <= hi + pad), axis=1)
    return float(inside.mean())


def coverage_fraction(pred_pts: np.ndarray, true_pts: np.ndarray) -> float:
    """Fraction of ``true_pts`` inside the convex hull of ``pred_pts``.

    Degenerate prediction clouds (early stages are often collinear: theta+
    = theta + omega*dt is deterministic given the shared start) fall back
    to bounding-interval containment instead of scoring an
    unrepresentative 0.
    """
    from scipy.spatial import Delaunay, QhullError
    try:
        tri = Delaunay(pred_pts)
    except (QhullError, ValueError):
        return _interval_coverage(pred_pts, true_pts)
    return float(np.mean(tri.find_simplex(true_pts) >= 0))


def coverage_table(pred_stages: np.ndarray, true_stages: np.ndarray,
                   dims=(0, 1)) -> list:
    """Per-stage metrics.

    Args:
        pred_stages: (T+1, n_pred, nx) predicted sample states per stage.
        true_stages: (T+1, n_true, nx) MC-truth states per stage.
    Returns:
        list of {stage, vol_ratio, coverage} dicts (stage 0, the shared
        pinned start, is skipped like the reference's range(1, H)); a
        degenerate truth hull gives vol_ratio None.
    """
    d = list(dims)
    rows = []
    T = min(pred_stages.shape[0], true_stages.shape[0])
    for k in range(1, T):
        p = pred_stages[k][:, d]
        t = true_stages[k][:, d]
        vt = hull_volume(t)
        rows.append({
            "stage": k,
            "vol_ratio": hull_volume(p) / vt if vt > 0 else None,
            "coverage": coverage_fraction(p, t),
        })
    return rows


def load_mc_stages(mc_dir: str, max_files: int = None) -> np.ndarray:
    """Stack MC pickles into (T+1, N_total, nx) per-stage points."""
    files = sorted(glob.glob(os.path.join(mc_dir, "X_traj_list_*.pkl"))) + \
        sorted(glob.glob(os.path.join(mc_dir, "data_X_traj_*.pkl")))
    if not files:
        raise FileNotFoundError(f"no MC pickles under {mc_dir}")
    blocks = []
    for fn in files[:max_files]:
        with open(fn, "rb") as f:
            d = pickle.load(f)
        X = d["X_traj"] if isinstance(d, dict) else np.asarray(d)
        if X.ndim == 3:                      # (T+1, ns, nx) single repeat
            X = X[None]
        blocks.append(X)                     # (reps, T+1, ns, nx)
    X = np.concatenate(blocks, axis=0)
    reps, T1, ns, nx = X.shape
    return np.transpose(X, (1, 0, 2, 3)).reshape(T1, reps * ns, nx)


def summary(rows: list) -> str:
    """The printed summary row: min/mean coverage and volume ratio."""
    cov = np.asarray([r["coverage"] for r in rows])
    ratio = np.asarray([r["vol_ratio"] for r in rows
                        if r["vol_ratio"] is not None])
    vol = (f"vol ratio min={ratio.min():.3f} mean={ratio.mean():.3f}"
           if ratio.size else "vol ratio undefined")
    return (f"stages 1..{len(rows)}: coverage min={cov.min():.3f} "
            f"mean={cov.mean():.3f}; {vol} "
            f"({len(rows) - len(ratio)} degenerate stages skipped)")


def plot(rows: list, path: str) -> None:
    """Coverage and volume ratio per stage (matplotlib, imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax1 = plt.subplots(figsize=(7, 3.2))
    stages = [r["stage"] for r in rows]
    ax1.plot(stages, [r["coverage"] for r in rows], color="tab:blue",
             label="coverage")
    ax1.set_ylabel("truth coverage")
    ax1.set_xlabel("stage")
    ax1.set_ylim(0, 1.05)
    ax2 = ax1.twinx()
    rs = [(r["stage"], min(r["vol_ratio"], 5.0)) for r in rows
          if r["vol_ratio"] is not None]
    ax2.plot([s for s, _ in rs], [v for _, v in rs], color="tab:orange",
             label="vol ratio")
    ax2.set_ylabel("hull volume ratio")
    fig.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="reachable-set coverage")
    parser.add_argument("-param", default="params_pendulum1D_samples")
    parser.add_argument("--data", required=True,
                        help="data.pkl with the predicted plan")
    parser.add_argument("--mc-dir", required=True)
    parser.add_argument("--step", type=int, default=0,
                        help="which MPC step's plan to score")
    parser.add_argument("--dims", type=int, nargs=2, default=(0, 1))
    parser.add_argument("--out", default=None)
    parser.add_argument("--plot", action="store_true",
                        help="also draw coverage.png (needs matplotlib)")
    args = parser.parse_args(argv)

    from sampling_gpmpc_torch.config import load_problem
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, spec, _ = load_problem(
        os.path.join(here, "params", args.param + ".yaml"))

    with open(args.data, "rb") as f:
        rec = pickle.load(f)
    Xp = np.asarray(rec["state_traj"][args.step])          # (H+1, ns*nx)
    pred = Xp.reshape(Xp.shape[0], -1, spec.nx)            # (H+1, ns, nx)
    true = load_mc_stages(args.mc_dir)

    rows = coverage_table(pred, true, dims=tuple(args.dims))
    print(summary(rows))
    out_dir = args.out or args.mc_dir
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "coverage.json"), "w") as f:
        json.dump(rows, f, indent=1)
    written = "coverage.json"
    if args.plot:
        plot(rows, os.path.join(out_dir, "coverage.png"))
        written += ", coverage.png"
    print(f"wrote {out_dir}/{written}")


if __name__ == "__main__":
    main()
