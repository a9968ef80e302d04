"""LQR closed-loop sanity check (E10), the port's counterpart of
``examples/lqr_sanity.py`` (ref: extra/LQR_pendulum.py).

Stabilizes the 1-D pendulum about the upright equilibrium with the
Riccati-synthesized ancillary gain (``tools.terminal_set.synthesize``)
and checks, under the true nonlinear dynamics, that the P-weighted
Lyapunov function decays to 1e-2 of its start and decreases at every
step.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.examples.lqr_sanity [--device cpu]
"""

import argparse
import os

import numpy as np

STEPS = 400
OFFSET = (0.15, -0.2)


def run(device=None, steps: int = STEPS):
    """The terminal ingredients and the Lyapunov values V_k (float64)."""
    import torch

    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.tools.terminal_set import synthesize

    dev = setup.resolve_device(device)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    params, spec, data = load_problem(
        os.path.join(here, "params", "params_pendulum1D_samples.yaml"))
    env = make_env(spec, params)
    ts = synthesize(env, data.goal, np.zeros(spec.nu), np.asarray(data.Qx),
                    np.asarray(data.Qu), data.x_min, data.x_max, data.u_min,
                    data.u_max, device=dev)
    t_ = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                   device=dev)
    goal, K = t_(data.goal), t_(ts.K)
    x = goal + t_(OFFSET)
    V = []
    for _ in range(steps):
        err = (x - goal).cpu().numpy()
        V.append(float(err @ ts.P @ err))
        u = -K @ (goal - x)                 # config: u = -K(x_eq - x)
        x = env.discrete_dyn(x, u)
    return ts, np.asarray(V)


def check(V: np.ndarray) -> None:
    """The reference's two assertions, as errors that survive -O."""
    if not V[-1] < 1e-2 * V[0]:
        raise AssertionError("no Lyapunov decay - check the gain")
    if not np.all(np.diff(V) < 1e-9):
        raise AssertionError("V must decrease monotonically")


def main(argv=None):
    parser = argparse.ArgumentParser(description="LQR sanity check")
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    args = parser.parse_args(argv)
    ts, V = run(args.device)
    print(f"P =\n{ts.P}\nK = {ts.K}\nrho = {ts.rho:.4f} "
          f"delta = {ts.delta:.3f}")
    print("V(0) =", V[0], " V(end) =", V[-1])
    check(V)
    print("Lyapunov decay OK (closed loop stabilizes the upright state)")


if __name__ == "__main__":
    main()
