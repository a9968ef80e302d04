"""Forward-sampling reachability at scale (the port's entry point).

Counterpart of ``benchmarking/simulate_forward_sampling.py``: ns GP dynamics
realizations (``num_dyn_samples`` of the config, 4000 for
``params_car_residual_fs``) propagated under one input trajectory, each
step conditioning every realization on its own sampled value
(``reachability.forward_sample_rollout``).  One process sweeps
``--repeats`` seed blocks; each writes
``experiments/reachability/<param>/data_X_traj_<i>_<r>.pkl`` and prints its
sampled steps per second.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.simulate_forward_sampling \
        -param params_car_residual_fs -i 0 --repeats 4 [--data data.pkl]
    python -m sampling_gpmpc_torch.simulate_forward_sampling --device cpu \
        --steps 5   # float64 on the CPU

CUDA float32 by default (``--device cpu`` runs float64; ``SGPMPC_DTYPE``
overrides either).
"""

import argparse
import os
import pickle
import time

import numpy as np


def replay_inputs(rec: dict, T: int) -> np.ndarray:
    """The input trajectory of a closed-loop artifact: a single solve
    replays its whole plan (ref: simulate_forward_sampling_car.py:91-98);
    a closed loop replays its applied first inputs."""
    if len(rec["input_traj"]) == 1:
        return np.asarray(rec["input_traj"][0])[:T]
    return np.concatenate([np.asarray(u)[:1]
                           for u in rec["input_traj"]])[:T]


def main(argv=None):
    parser = argparse.ArgumentParser(description="forward sampling (PyTorch)")
    parser.add_argument("-param", default="params_car_residual_fs")
    parser.add_argument("-i", type=int, default=0, help="seed block index")
    parser.add_argument("--repeats", type=int, default=1)
    parser.add_argument("--steps", type=int, default=None,
                        help="number of propagation steps (default "
                             "num_MPC_itrs)")
    parser.add_argument("--data", default=None,
                        help="data.pkl with the input trajectory to replay; "
                             "default: zero inputs")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    args = parser.parse_args(argv)

    import torch

    from sampling_gpmpc_torch import agent as agent_mod
    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.reachability import forward_sample_rollout

    device, dtype = setup.resolve(args.device)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, spec, data = load_problem(
        os.path.join(here, "params", args.param + ".yaml"))
    env = make_env(spec, params)
    hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)

    T = args.steps or spec.num_mpc_iter
    if args.data:
        with open(args.data, "rb") as f:
            U = replay_inputs(pickle.load(f), T)
        T = U.shape[0]
    else:
        U = np.zeros((T, spec.nu))
    fb = None
    if spec.use_feedback and data.K_fb is not None:
        fb = {"K": data.K_fb, "x_eq": data.goal}

    gp0 = agent_mod.init_gp_state(spec, env, device, dtype, capacity=T,
                                  hyp=hyp)
    out_dir = args.out or os.path.join(here, "experiments", "reachability",
                                       args.param)
    os.makedirs(out_dir, exist_ok=True)
    for r in range(args.repeats):
        gen = torch.Generator().manual_seed(
            spec.seed + args.i * 100003 + r)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        X, _ = forward_sample_rollout(spec, env, hyp, gp0, data.start, U,
                                      gen, use_feedback=fb)
        X = X.cpu().numpy()                   # waits for the device
        dt = time.perf_counter() - t0
        fn = os.path.join(out_dir, f"data_X_traj_{args.i}_{r}.pkl")
        with open(fn, "wb") as f:
            pickle.dump({"X_traj": X, "seed_block": args.i, "repeat": r,
                         "wall_s": dt}, f)
        print(f"repeat {r}: {spec.ns} realizations x {T} steps in {dt:.3f}s "
              f"({spec.ns * T / dt:.0f} sampled steps/s, non-finite "
              f"realizations {int((~np.isfinite(X).all(axis=(0, 2))).sum())}"
              f") on {device} {dtype} -> {fn}", flush=True)


if __name__ == "__main__":
    main()
