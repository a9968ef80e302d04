"""Experiment driver CLI of the port.

Usage:
    python -m sampling_gpmpc_torch.main -param params_pendulum1D_samples -i 42
    python -m sampling_gpmpc_torch.main -param params_pendulum1D_samples \
        --device cpu --dtype float64 [--debug-sqp] [--live]

Loads the reference-format YAML config, builds the environment and GP
state, runs the closed-loop MPC on the chosen device (CUDA by default) and
writes a data.pkl-compatible artifact under
experiments/<folder>/env_<env>/<param>/<i>/.
"""

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="sampling GP-MPC (PyTorch)")
    parser.add_argument("-param", default="params_pendulum1D_samples")
    parser.add_argument("-env", type=int, default=0)
    parser.add_argument("-i", type=int, default=42)
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    parser.add_argument("--dtype", default=None,
                        help="float32|float64 (default: float32 on CUDA, "
                             "float64 on the CPU, or env SGPMPC_DTYPE)")
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("--debug-sqp", action="store_true",
                        help="record every SQP iterate: per-iterate debug "
                             "frames + video_sqp.gif in the artifact dir "
                             "(ref: src/solver.py:194-352)")
    parser.add_argument("--live", action="store_true",
                        help="grab a video frame per MPC step WHILE the "
                             "loop runs (ref: src/DEMPC.py:60-66 in-loop "
                             "plotting) -> video_live.{mp4,gif}")
    args = parser.parse_args(argv)

    import torch

    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import DEMPC
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.recorder import Recorder

    device = setup.resolve_device(args.device)
    dtype = getattr(torch, args.dtype) if args.dtype else None
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = os.path.join(here, "params", args.param + ".yaml")
    if not os.path.exists(cfg):
        avail = sorted(f[:-5] for f in os.listdir(os.path.join(here, "params"))
                       if f.endswith(".yaml"))
        raise SystemExit(f"unknown config '{args.param}'; available: "
                         + ", ".join(avail))
    params, spec, data = load_problem(cfg)
    params["env"]["i"] = args.i
    params["env"]["name"] = args.env
    save_path = os.path.join(
        here, "experiments", params["experiment"]["folder"],
        f"env_{args.env}", args.param, str(args.i))
    os.makedirs(save_path, exist_ok=True)

    env = make_env(spec, params)
    rec = Recorder(params, save_path)
    if spec.use_tightening:
        rec.tilde_eps_list = data.tilde_eps
        rec.ci_list = data.ci
    live = None
    if args.live:
        from sampling_gpmpc_torch import visu
        live = visu.LiveRenderer(
            params, save_path,
            tilde_eps=data.tilde_eps if spec.use_tightening else None,
            P=data.P_term if spec.use_tightening else None)
    mpc = DEMPC(params, spec, data, env, device=device, dtype=dtype,
                recorder=rec, verbose=not args.quiet,
                debug_sqp_dir=save_path if args.debug_sqp else None,
                live=live)
    out = mpc.run()
    if live is not None:
        print(f"live video: {live.close()} ({live.frames} frames)")
    artifact = rec.save_data()
    if args.debug_sqp and mpc.sqp_records:
        from sampling_gpmpc_torch import visu
        vid = visu.render_frames_video(
            [r["frame"] for r in mpc.sqp_records],
            os.path.join(save_path, "video_sqp.gif"))
        print(f"sqp debug video: {vid} ({len(mpc.sqp_records)} iterates)")
    times = out["solver_time"]
    steady = times[1:] if len(times) > 1 else times
    print(f"saved {artifact}")
    print(f"solver time mean={np.mean(steady):.4f}s "
          f"std={np.std(steady):.4f}s (first {times[0]:.2f}s) "
          f"on {device} {mpc.dtype}")
    print(f"final state: {out['final_state']}")


if __name__ == "__main__":
    main()
