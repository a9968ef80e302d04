"""Linearization-based (Cautious-MPC style) uncertainty propagation (B5).

Counterpart of ``benchmarking/linearization_baseline.py``: mean and
covariance ellipses of the GP dynamics along an input trajectory,

    mu+ = f(mu, u) + B_d g_mean(mu, u),    P+ = A P A' + B_d Sigma B_d',

with A the posterior-mean Jacobian, read directly from the derivative
GP's mean tasks (ref: benchmarking/linearization_based_predictions.py:
136-179).  Plain torch on the card, as the JAX package leaves it to XLA;
the scan is a loop over the steps.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.linearization_baseline \\
        -param params_car_residual [--data data.pkl] [--steps 30]
    python -m sampling_gpmpc_torch.linearization_baseline --device cpu

Writes ``{"means": (T+1, nx), "covs": (T+1, nx, nx)}`` to
``experiments/reachability/<param>_linearization.pkl`` (or ``--out``),
which ``benchmarking/compare_methods.py`` reads.
"""

import argparse
import os
import pickle

import numpy as np


def posterior_rows(spec, hyp, Z, Y, xu):
    """Posterior mean rows and task variances at the points ``xu``.

    Args:
        Z, Y: (1, g_ny, M, ...) one sample's training set.
        xu: (..., nx+nu) points, each predicted alone.
    Returns:
        mean rows (..., g_ny, Ty) and variances (..., g_ny, Ty).
    """
    import torch

    from sampling_gpmpc_torch import agent as agent_mod
    Xt = xu[..., list(spec.g_idx_inputs)][None, ..., None, :]
    _, mean, cov = agent_mod._batched_posterior(spec, hyp, Z, Y, Xt)
    var = torch.diagonal(cov[0], dim1=-2, dim2=-1)           # (g_ny, ..., Ty)
    return mean[0].movedim(0, -2), var.movedim(0, -2)


def propagate(spec, env, hyp, gp, x0, U):
    """Returns means (T+1, nx) and covariances (T+1, nx, nx).

    Args:
        gp: GP state of a one-sample spec (``ns = 1``).
        x0: (nx,) start; U: (T, nu) inputs, tensors of the state's dtype.
    """
    import torch

    from sampling_gpmpc_torch import agent as agent_mod
    nx = spec.nx
    Z, Y = agent_mod.full_train_set(spec, gp)
    mu = x0
    P = torch.zeros((nx, nx), dtype=x0.dtype, device=x0.device)
    mus, Ps = [mu], [P]
    for u in U:
        xu = torch.cat([mu, u])
        rows, var = posterior_rows(spec, hyp, Z[:1], Y[:1], xu)
        comb = env.assemble_val_jac(xu, rows)                 # (nx, 1+nx+nu)
        A = comb[:, 1:1 + nx]
        Bd = env.B_d_dyn(xu)
        mu = comb[:, 0]
        P = A @ P @ A.T + Bd @ torch.diag(var[:, 0]) @ Bd.T
        mus.append(mu)
        Ps.append(P)
    return torch.stack(mus), torch.stack(Ps)


def one_sample_problem(param: str, device, dtype):
    """(params, spec, data, env, hyp, gp) of a config at ns = 1, its
    hallucination buffer of capacity 1, as both GP baselines run it."""
    import dataclasses

    from sampling_gpmpc_torch import agent as agent_mod
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, spec, data = load_problem(
        os.path.join(here, "params", param + ".yaml"))
    spec = dataclasses.replace(spec, ns=1)
    params["agent"]["num_dyn_samples"] = 1
    env = make_env(spec, params)
    hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)
    gp = agent_mod.init_gp_state(spec, env, device, dtype, capacity=1,
                                 hyp=hyp)
    return params, spec, data, env, hyp, gp


def first_inputs(rec: dict, steps: int) -> np.ndarray:
    """The applied inputs of a closed-loop artifact: each step's first."""
    return np.concatenate([np.asarray(u)[:1]
                           for u in rec["input_traj"]])[:steps]


def main(argv=None):
    parser = argparse.ArgumentParser(description="linearization baseline")
    parser.add_argument("-param", default="params_car_residual")
    parser.add_argument("--data", default=None)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) | cpu | cuda:N")
    args = parser.parse_args(argv)

    import torch

    from sampling_gpmpc_torch import setup
    device, dtype = setup.resolve(args.device)
    _, spec, data, env, hyp, gp = one_sample_problem(args.param, device,
                                                     dtype)
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    if args.data:
        with open(args.data, "rb") as f:
            U = first_inputs(pickle.load(f), args.steps)
    else:
        U = np.zeros((args.steps, spec.nu))
    mus, Ps = propagate(spec, env, hyp, gp, t_(data.start), t_(U))
    mus, Ps = mus.cpu().numpy(), Ps.cpu().numpy()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = args.out or os.path.join(here, "experiments", "reachability",
                                   f"{args.param}_linearization.pkl")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump({"means": mus, "covs": Ps}, f)
    print(f"propagated {len(U)} stages on {device} {dtype} -> {out}")
    print("final mean:", mus[-1])
    print("final cov diag:", np.diagonal(Ps[-1]))


if __name__ == "__main__":
    main()
