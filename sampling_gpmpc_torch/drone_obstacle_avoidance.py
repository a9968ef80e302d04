"""Drone obstacle avoidance with the approximate sampling MPC (the port).

Counterpart of the JAX package's examples/drone_obstacle_avoidance.py (ref:
extra/approx_sampling_mpc/demo_obstacle_avoidance.py): the drone tracks a
heart-shaped reference path through circular obstacles using the BLR
nominal model with sampled-trajectory constraint tightenings, or plans
optimistically (``--optimistic``).  Runs on CUDA in float32 unless
``--device cpu`` (float64 there; ``SGPMPC_DTYPE`` overrides both).

Usage:
    python -m sampling_gpmpc_torch.drone_obstacle_avoidance [-i 1]
        [--iters 100] [--optimistic] [--active-learning FREQ]
        [--device cpu]

Writes experiments/drone/env_0/<param>/<i>/data_obstacles.pkl with the
JAX example's keys (physical_state_traj, state_traj, solver_time,
tightenings, final_state, status) and trajectory.png.
"""

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-param", default="params_drone_obstacles_approx")
    parser.add_argument("-i", type=int, default=1)
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--active-learning", type=int, default=None,
                        metavar="FREQ", help="observe the true transition "
                        "every FREQ steps (common.active_learning)")
    parser.add_argument("--optimistic", action="store_true",
                        help="plan with the eta-augmented exploration OCP "
                        "(agent.run.optimistic)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    args = parser.parse_args(argv)

    import yaml

    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.approx.solver import ApproxMPC

    device, dtype = setup.resolve(args.device)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "params", args.param + ".yaml")) as fh:
        params = yaml.safe_load(fh)
    if args.active_learning is not None:
        params["common"]["active_learning"] = {
            "use": True, "frequency": int(args.active_learning)}
    if args.optimistic:
        params["agent"]["run"]["optimistic"] = True
        params["agent"]["run"]["pessimistic"] = False

    print(f"start={params['env']['start'][:2]} "
          f"obstacles={len(params['env']['obstacles'])}")
    mpc = ApproxMPC(params, device, dtype)
    out = mpc.run(num_iters=args.iters)

    times = out["solver_time"]
    steady = times[1:] if len(times) > 1 else times
    print(f"status={out['status']} solve time mean={np.mean(steady):.4f}s "
          f"std={np.std(steady):.4f}s (first {times[0]:.2f}s) on {device} "
          f"{dtype}")

    out_dir = os.path.join(here, "experiments", "drone", "env_0",
                           args.param, str(args.i))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "data_obstacles.pkl"), "wb") as f:
        pickle.dump(out, f)

    try:
        import matplotlib
    except ImportError:
        print(f"saved {out_dir} (no matplotlib: no trajectory.png)")
        return out
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ph = np.stack(out["physical_state_traj"])
    fig, ax = plt.subplots(figsize=(7, 7))
    path = mpc.model.path_generator(0, 200)
    ax.plot(path[:, 0], path[:, 1], "g--", alpha=0.5, label="reference")
    ax.plot(ph[:, 0], ph[:, 1], "b.-", label="closed loop")
    for (cx, cy, r) in mpc.model.obstacles():
        ax.add_patch(plt.Circle((cx, cy), r, color="gray", alpha=0.6))
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(os.path.join(out_dir, "trajectory.png"), dpi=200)
    plt.close(fig)
    print(f"saved {out_dir}")
    return out


if __name__ == "__main__":
    main()
