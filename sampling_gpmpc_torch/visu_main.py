"""Replay CLI: render a recorded data.pkl into figures and a video.

Counterpart of the reference visu_main.py: loads the artifact of a run of
``sampling_gpmpc_torch.main`` (or of the JAX package's ``main.py``: the
keys are the same), recomputes the velocity-dependent tightenings for the
residual car, renders the trajectory figure and, with ``--video``, a
frame-by-frame video.  Host-only (numpy, matplotlib); it runs no solve.

Usage:
    python -m sampling_gpmpc_torch.visu_main -param params_pendulum1D_samples \
        -env 0 -i 42 [--video] [--plot-koller]
"""

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-param", default="params_pendulum1D_samples")
    parser.add_argument("-env", type=int, default=0)
    parser.add_argument("-i", type=int, default=42)
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--plot-koller", action="store_true",
                        help="overlay the robust-tube baseline's ellipses "
                             "from koller_*.pkl in the run directory "
                             "(ref: visu_main.py:79-85)")
    args = parser.parse_args(argv)

    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.recorder import Recorder
    from sampling_gpmpc_torch.tightening import reachable_set_ball
    from sampling_gpmpc_torch.visu import render_run

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, spec, data = load_problem(
        os.path.join(here, "params", args.param + ".yaml"))
    run_dir = os.path.join(
        here, "experiments", params["experiment"]["folder"],
        f"env_{args.env}", args.param, str(args.i))
    artifact = os.path.join(run_dir, "data.pkl")
    if not os.path.exists(artifact):
        raise SystemExit(f"no artifact at {artifact}: run "
                         f"sampling_gpmpc_torch.main with the same "
                         f"-param/-env/-i first")
    rec = Recorder.load(artifact)

    tilde_eps, P = None, None
    if spec.use_tightening and data.P_term is not None:
        P = data.P_term
        if spec.env_name == "bicycle_Bdx":
            # recompute with the realized velocity profile
            # (ref: visu_main.py:71-75)
            X0 = np.asarray(rec["state_traj"][0]).reshape(spec.H + 1, -1,
                                                          spec.nx)
            tilde_eps, _ = reachable_set_ball(params, X0[:, 0, 3])
        else:
            tilde_eps = data.tilde_eps

    koller = None
    if args.plot_koller:
        kp = os.path.join(run_dir, "koller_ellipse_data.pkl")
        if not os.path.exists(kp):
            raise SystemExit(f"no {kp}: write the robust-tube baseline's "
                             f"ellipses for the same -param/-env/-i first")
        with open(kp, "rb") as f:
            koller = {"ellipses": pickle.load(f)}
        for key, name in (("centers", "koller_ellipse_center_data.pkl"),
                          ("true", "koller_true_data.pkl")):
            fp = os.path.join(run_dir, name)
            if os.path.exists(fp):
                with open(fp, "rb") as f:
                    koller[key] = pickle.load(f)

    path = render_run(rec, params, run_dir, tilde_eps=tilde_eps, P=P,
                      video=args.video, koller=koller)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
