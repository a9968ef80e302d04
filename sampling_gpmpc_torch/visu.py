"""Visualization: trajectory plots, reachable-set ellipses, videos.

Counterpart of the reference Visualizer's plotting surface
(ref: src/visu.py:15-530): receding-horizon sample fans, reachable-set
ellipse overlays computed from (P, tilde_eps), per-sample spread boxes,
environment drawing (obstacle ellipses, car box), and frame-by-frame video
writing from a recorded data.pkl artifact.

numpy, matplotlib and PIL only (no torch): the solve path never imports
this module, so the port runs where matplotlib is absent; it is imported
only where rendering is asked for (``DEMPC(debug_sqp_dir=..., live=...)``,
``main --debug-sqp/--live``, ``visu_main``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import Ellipse  # noqa: E402


def _sample_states(X_flat: np.ndarray, nx: int) -> np.ndarray:
    """(H+1, ns*nx) reference layout -> (H+1, ns, nx)."""
    H1 = X_flat.shape[0]
    return X_flat.reshape(H1, -1, nx)


def plot_receding_traj(ax, X_flat, nx: int, dims=(0, 1), color="steelblue",
                       alpha=0.25):
    """Fan of per-sample planned trajectories (ref: src/visu.py:319-378)."""
    X = _sample_states(np.asarray(X_flat), nx)
    for i in range(X.shape[1]):
        ax.plot(X[:, i, dims[0]], X[:, i, dims[1]], color=color, alpha=alpha,
                linewidth=0.8)
    ax.plot(X[:, 0, dims[0]], X[:, 0, dims[1]], color="navy", linewidth=1.2)


def plot_reachable_ellipses(ax, X_flat, nx: int, P: np.ndarray,
                            tilde_eps: np.ndarray, dims=(0, 1),
                            color="tomato"):
    """Per-stage reachability ellipses {x : (x-c)'P(x-c) <= eps^2} around the
    first sample's plan (ref: src/visu.py:390-421)."""
    X = _sample_states(np.asarray(X_flat), nx)
    P2 = np.asarray(P)[np.ix_(dims, dims)]
    evals, evecs = np.linalg.eigh(np.linalg.inv(P2))
    angle = np.degrees(np.arctan2(evecs[1, 0], evecs[0, 0]))
    for k in range(X.shape[0]):
        eps = float(np.asarray(tilde_eps)[k][-1]) if k < len(tilde_eps) else 0
        if eps <= 0:
            continue
        width, height = 2 * eps * np.sqrt(evals)
        ax.add_patch(Ellipse(
            (X[k, 0, dims[0]], X[k, 0, dims[1]]), width, height, angle=angle,
            fill=False, edgecolor=color, linewidth=0.7, alpha=0.8))


def plot_sample_boxes(ax, X_flat, nx: int, dims=(0, 1), color="seagreen"):
    """Axis-aligned per-stage spread boxes over samples
    (ref: src/visu.py:423-441)."""
    X = _sample_states(np.asarray(X_flat), nx)
    lo = X.min(axis=1)
    hi = X.max(axis=1)
    for k in range(X.shape[0]):
        ax.add_patch(plt.Rectangle(
            (lo[k, dims[0]], lo[k, dims[1]]),
            hi[k, dims[0]] - lo[k, dims[0]], hi[k, dims[1]] - lo[k, dims[1]],
            fill=False, edgecolor=color, linewidth=0.6, alpha=0.7))


def draw_environment(ax, params: dict):
    """Obstacle ellipses + bounds (ref: src/visu.py:259-317)."""
    env = params.get("env", {})
    for name, e in (env.get("ellipses", {}) or {}).items():
        x0, y0, a, b, f = e
        ax.add_patch(Ellipse((x0, y0), 2 * np.sqrt(a * f), 2 * np.sqrt(b * f),
                             facecolor="lightgray", edgecolor="dimgray"))
    opt = params.get("optimizer", {})
    if "x_min" in opt:
        ax.axhline(opt["x_min"][1], color="k", linewidth=0.5, alpha=0.4)
        ax.axhline(opt["x_max"][1], color="k", linewidth=0.5, alpha=0.4)


def draw_car(ax, state, length=2.8, width=1.4, color="crimson"):
    """Oriented car rectangle at (x, y, phi) (ref: src/visu.py:259-290)."""
    x, y, phi = state[0], state[1], state[2]
    corners = np.array([[-length / 2, -width / 2], [length / 2, -width / 2],
                        [length / 2, width / 2], [-length / 2, width / 2]])
    R = np.array([[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]])
    pts = corners @ R.T + np.array([x, y])
    ax.add_patch(plt.Polygon(pts, closed=True, facecolor=color, alpha=0.8))


def plot_koller_overlay(ax, koller: dict, dims=(0, 1), h_explode: int = 14):
    """Robust-tube (Koller) comparison overlay: red outer ellipses, the
    tube-center path, and the true rollout (ref: visu_main.py:145-151;
    the mean path is clipped at the reference's H_explode=14 because the
    Koller recursion blows up beyond it).  Axis limits are frozen to the
    underlying trajectory plot first: the exploded late-stage ellipses
    would otherwise autoscale the view to ~1e90."""
    ax.relim()
    xlim, ylim = ax.get_xlim(), ax.get_ylim()
    for j, poly in enumerate(koller.get("ellipses", [])):
        p = np.asarray(poly)
        ax.plot(p[0], p[1], color="tab:red", alpha=0.7, lw=0.8,
                label="robust tube (Koller)" if j == 0 else None)
    centers = koller.get("centers")
    if centers is not None and len(centers):
        c = np.asarray(centers)[:h_explode].reshape(len(centers[:h_explode]),
                                                    -1)
        ax.plot(c[:, dims[0]], c[:, dims[1]], color="tab:blue", lw=1)
    true = koller.get("true")
    if true is not None and len(true):
        t = np.asarray(true).reshape(len(true), -1)
        ax.plot(t[:, dims[0]], t[:, dims[1]], ls="--", color="black", lw=0.8)
    ax.set_xlim(xlim)
    ax.set_ylim(ylim)


def render_run(data: dict, params: dict, out_dir: str,
               tilde_eps=None, P=None, video: bool = False,
               fname: str = "trajectory.png", koller: dict = None):
    """Render a recorded run: closed-loop path + per-step plan fans.

    Args:
        data: dict loaded from data.pkl (Recorder.load).
        video: additionally write video_gp.mp4 frame-by-frame when an
            FFMpeg writer is available (ref: visu_main.py:116-212).
        koller: optional robust-tube overlay dict with keys
            ellipses/centers/true (from robust_tube_baseline.py).
    """
    os.makedirs(out_dir, exist_ok=True)
    nx = params["agent"]["dim"]["nx"]
    dyn = params["env"]["dynamics"]
    dims = (0, 1)

    fig, ax = plt.subplots(figsize=(10, 5) if "bicycle" in dyn else (6, 6))
    draw_environment(ax, params)
    for X_flat in data["state_traj"]:
        plot_receding_traj(ax, X_flat, nx, dims)
        if tilde_eps is not None and P is not None:
            plot_reachable_ellipses(ax, X_flat, nx, P, tilde_eps, dims)
    if koller is not None:
        plot_koller_overlay(ax, koller, dims)
    phys = np.stack([np.asarray(p).reshape(-1, nx)[0]
                     for p in data["physical_state_traj"]])
    ax.plot(phys[:, dims[0]], phys[:, dims[1]], "k.-", linewidth=1.5,
            label="closed loop")
    ax.set_xlabel(f"x[{dims[0]}]")
    ax.set_ylabel(f"x[{dims[1]}]")
    ax.legend()
    path = os.path.join(out_dir, fname)
    fig.savefig(path, dpi=200, bbox_inches="tight")
    plt.close(fig)

    if video:
        _render_video(data, params, out_dir, nx, dims, tilde_eps, P)
    return path


def plot_sqp_iterate(out_path, X, U, dg=None, mean=None, std=None,
                     x_bounds=None):
    """Per-SQP-iterate debug figure (ref: src/solver.py:194-352): the
    per-sample trajectory fan, GP samples vs posterior mean bands along the
    trajectory, and the input staircase.

    Args:
        X: (H+1, ns, nx); U: (H, nu).
        dg: optional (ns, g_ny, H, Ty) sampled GP rows (value column used).
        mean/std: optional (ns, g_ny, H) posterior value mean/stddev.
    """
    X = np.asarray(X)
    U = np.asarray(U)
    fig, ax = plt.subplots(1, 3, figsize=(13, 4))
    s_frac = np.linspace(0, 1, X.shape[0] - 1)
    for s in range(X.shape[1]):
        ax[1].plot(X[:, s, 0], X[:, s, 1], "-d", ms=2, alpha=0.6)
        if mean is not None:
            h = ax[0].plot(s_frac, np.asarray(mean)[s, 0], alpha=0.8)
            if std is not None:
                ax[0].fill_between(
                    s_frac,
                    np.asarray(mean)[s, 0] - 2 * np.asarray(std)[s, 0],
                    np.asarray(mean)[s, 0] + 2 * np.asarray(std)[s, 0],
                    alpha=0.15, color=h[0].get_color())
        if dg is not None:
            ax[0].plot(s_frac, np.asarray(dg)[s, 0, :, 0], "x", ms=4)
    if x_bounds is not None:
        for b in np.asarray(x_bounds).reshape(-1):
            ax[1].axhline(b, color="k", linewidth=0.5, alpha=0.3)
    ax[0].set_title("GP samples along iterate")
    ax[1].set_title("trajectory fan")
    ax[2].stairs(U[:, 0], np.arange(U.shape[0] + 1))
    ax[2].set_title("input")
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def render_frames_video(frame_paths, out_path, fps: int = 2):
    """Assemble saved debug frames (PNGs) into an animated GIF — the
    per-SQP-iterate video of the reference's in-solve debug plots
    (ref: src/solver.py:194-352 rendered per iteration)."""
    from PIL import Image
    if not frame_paths:
        return None
    imgs = [Image.open(p).convert("RGB") for p in frame_paths]
    w = max(im.width for im in imgs)
    h = max(im.height for im in imgs)
    canv = []
    for im in imgs:
        bg = Image.new("RGB", (w, h), "white")
        bg.paste(im, ((w - im.width) // 2, (h - im.height) // 2))
        canv.append(bg)
    canv[0].save(out_path, save_all=True, append_images=canv[1:],
                 duration=int(1000 / fps), loop=0)
    return out_path


def _render_video(data, params, out_dir, nx, dims, tilde_eps, P):
    import matplotlib.animation as manimation
    try:
        writer = manimation.FFMpegWriter(fps=5)
        out = os.path.join(out_dir, "video_gp.mp4")
    except Exception:
        writer = None
    if writer is None or not manimation.FFMpegWriter.isAvailable():
        # no ffmpeg in the image: fall back to an animated GIF
        writer = manimation.PillowWriter(fps=5)
        out = os.path.join(out_dir, "video_gp.gif")
    fig, ax = plt.subplots()
    with writer.saving(fig, out, dpi=150):
        for X_flat in data["state_traj"]:
            ax.clear()
            draw_environment(ax, params)
            plot_receding_traj(ax, X_flat, nx, dims)
            if tilde_eps is not None and P is not None:
                plot_reachable_ellipses(ax, X_flat, nx, P, tilde_eps, dims)
            if "bicycle" in params["env"]["dynamics"]:
                draw_car(ax, np.asarray(X_flat)[0, :nx])
            writer.grab_frame()
    plt.close(fig)
    return out


class LiveRenderer:
    """In-loop frame grabbing while the closed loop RUNS.

    The reference opens its video writer before the MPC loop and grabs a
    frame per iteration from inside it (ref: src/visu.py:36-54 opens
    writer_gp and hands it to the loop; src/DEMPC.py:60-66 plots + grabs
    each receding-horizon solution as it is produced).  This is the same
    contract: construct before the loop, call :meth:`grab` once per MPC
    step with the fresh plan, :meth:`close` after the loop to finalize the
    file.  Frames accumulate the closed-loop path so far on top of the
    current plan fan.
    """

    def __init__(self, params: dict, out_dir: str, fps: int = 5,
                 tilde_eps=None, P=None, fname: str = "video_live"):
        import matplotlib.animation as manimation
        os.makedirs(out_dir, exist_ok=True)
        self.params = params
        self.nx = params["agent"]["dim"]["nx"]
        self.dims = (0, 1)
        self.tilde_eps, self.P = tilde_eps, P
        if manimation.FFMpegWriter.isAvailable():
            self.writer = manimation.FFMpegWriter(fps=fps)
            self.path = os.path.join(out_dir, fname + ".mp4")
        else:
            self.writer = manimation.PillowWriter(fps=fps)
            self.path = os.path.join(out_dir, fname + ".gif")
        self.fig, self.ax = plt.subplots(
            figsize=(10, 5) if "bicycle" in params["env"]["dynamics"]
            else (6, 6))
        self.writer.setup(self.fig, self.path, dpi=110)
        self._phys = []
        self.frames = 0

    def grab(self, x_curr, X_plan):
        """Render one frame: plan fan + closed-loop path so far.

        Args:
            x_curr: (nx,) measured state at this MPC step.
            X_plan: (H+1, ns, nx) or (H+1, ns*nx) plan just solved.
        """
        self._phys.append(np.asarray(x_curr).reshape(-1)[:self.nx])
        ax = self.ax
        ax.clear()
        draw_environment(ax, self.params)
        X_flat = np.asarray(X_plan).reshape(np.shape(X_plan)[0], -1)
        plot_receding_traj(ax, X_flat, self.nx, self.dims)
        if self.tilde_eps is not None and self.P is not None:
            plot_reachable_ellipses(ax, X_flat, self.nx, self.P,
                                    self.tilde_eps, self.dims)
        if "bicycle" in self.params["env"]["dynamics"]:
            draw_car(ax, self._phys[-1])
        p = np.stack(self._phys)
        ax.plot(p[:, self.dims[0]], p[:, self.dims[1]], "k.-",
                linewidth=1.5, label="closed loop")
        ax.set_xlabel(f"x[{self.dims[0]}]")
        ax.set_ylabel(f"x[{self.dims[1]}]")
        self.writer.grab_frame()
        self.frames += 1

    def close(self):
        if self.fig is not None:
            self.writer.finish()
            plt.close(self.fig)
            self.fig = None
        return self.path
