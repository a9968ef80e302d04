"""Golden closed-loop trajectories of the port: generation + comparison.

The port's float64 closed loops are pinned to the JAX package's committed
goldens (``tests/goldens/<config>.npz``, written by the JAX package's
``tools/goldens.py``; ``tests/test_torch_goldens.py`` holds them at 1e-7
on the JAX package's draws).  This module runs a flagship config full
length through the port (on the card in float32 unless the caller asks
for the CPU, where it runs in float64) and returns the same arrays;
``load_golden`` reads the committed golden, ``save_golden`` writes the
port's own run under ``experiments/torch_goldens/`` (never into
``tests/goldens/``).

Regenerate the port's own goldens (its own draws) with:
    python -m sampling_gpmpc_torch.tools.goldens [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from sampling_gpmpc_torch import setup

GOLDEN_CONFIGS = (
    "params_pendulum1D_samples",
    "params_pendulum",
    "params_car",
    "params_car_residual",
    "params_pendulum_samples",
    "params_car_samples",
)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def golden_path(config: str) -> str:
    """The committed golden of ``config`` (written by the JAX package)."""
    return os.path.join(repo_root(), "tests", "goldens", config + ".npz")


def torch_golden_path(config: str) -> str:
    """Where :func:`save_golden` writes (an ignored directory)."""
    return os.path.join(repo_root(), "experiments", "torch_goldens",
                        config + ".npz")


def run_closed_loop(config: str, device=None, dtype=None,
                    epistemic=None) -> dict:
    """Run one flagship config full length; return the pinnable arrays.

    Args:
        device, dtype: as ``setup.resolve`` reads them: CUDA unless the
            caller asks for another device (raising where CUDA is absent),
            float32 there and float64 on the CPU.
        epistemic: optional injected draws (the JAX package's, to be held
            to its goldens); the port's own seeded draws when absent.
    """
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import DEMPC
    from sampling_gpmpc_torch.envs import make_env

    device, dtype = setup.resolve(device, dtype)
    params, spec, data = load_problem(
        os.path.join(repo_root(), "params", config + ".yaml"))
    env = make_env(spec, params)
    out = DEMPC(params, spec, data, env, device=device, dtype=dtype,
                epistemic=epistemic).run()
    return {
        "physical_state_traj": np.stack(out["physical_state_traj"]),
        "final_state": np.asarray(out["final_state"]),
        # applied input of every step (what the plant saw, before feedback)
        "u0_traj": np.stack([u[0] for u in out["input_traj"]]),
        # last step's full plan: pins the SQP fixed point itself
        "last_plan_X": np.asarray(out["state_traj"][-1]),
        "last_plan_U": np.asarray(out["input_traj"][-1]),
    }


def save_golden(config: str, arrays: dict) -> str:
    path = torch_golden_path(config)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load_golden(config: str) -> dict:
    with np.load(golden_path(config)) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (default) | cpu | cuda:N")
    args = ap.parse_args(argv)
    device = setup.resolve_device(args.device)
    for config in GOLDEN_CONFIGS:
        t0 = time.perf_counter()
        arrays = run_closed_loop(config, device=device)
        path = save_golden(config, arrays)
        print(f"{config}: {arrays['physical_state_traj'].shape[0]} steps, "
              f"final {np.round(arrays['final_state'], 6)} "
              f"({time.perf_counter() - t0:.1f}s) -> {path}")


if __name__ == "__main__":
    main()
