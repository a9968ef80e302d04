"""Write tests/goldens/torch_oracle_drone.npz: the approximate sampling MPC
of params_drone_obstacles_approx (examples/drone_obstacle_avoidance.py) in
the JAX package on the CPU, the reference of the port's drone tests and of
chip_smoke.py's drone phase.

Two closed loops of ``ApproxMPC.run``'s steps, in float64: N_PESS steps of
the pessimistic planner (the tightened nominal OCP, nU = 60, soft obstacle
rows) and N_OPT steps of the optimistic one (the eta-augmented OCP, nU =
240, no soft rows).  The pessimistic tightening's weight draws come from
``jax.random`` as ``run`` makes them (the config's seed, one split a step),
rounded to float32 and fed back as float64, so that a float32 and a
float64 consumer see identical draws; the tightening is ``_tightening``
with those draws in place of its own.  Stored per step: the draws ``z``,
the measured state, the SQP start (the shifted previous plan), the
tightening ``delta`` and the plan (X, U); and the JAX float32 path's plan
(``f32_*``) from the same inputs, teacher-forced, whose distance from the
float64 plan is the envelope chip_smoke.py's float32 bars are set from.

Run from the repository root (about a minute):

    python tests/make_torch_drone_golden.py
"""
import copy
import os
import sys
import time

import numpy as np
import yaml

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from sampling_gpmpc_tpu.setup import enable_x64, force_cpu_mesh  # noqa: E402

force_cpu_mesh(1)
enable_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sampling_gpmpc_tpu.approx import blr  # noqa: E402
from sampling_gpmpc_tpu.approx.solver import ApproxMPC  # noqa: E402

OUT = os.path.join(HERE, "tests", "goldens", "torch_oracle_drone.npz")
CONFIG = os.path.join(HERE, "params", "params_drone_obstacles_approx.yaml")
N_PESS = 10
N_OPT = 10


def optimistic_params(params):
    p = copy.deepcopy(params)
    p["agent"]["run"]["optimistic"] = True
    p["agent"]["run"]["pessimistic"] = False
    return p


def tightening(mpc):
    """ApproxMPC._tightening with the standard-normal draws z given."""
    @jax.jit
    def f(x0, U, z, post, W_nom):
        Ws = post.mu[None] + jnp.einsum("jab,njb->nja", post.chol, z)
        X_mu = blr.rollout(mpc.step_fn, x0, U, W_nom)
        X_s = jax.vmap(lambda W: blr.rollout(mpc.step_fn, x0, U, W))(Ws)
        return jnp.max(jnp.abs(X_s - X_mu[None]), axis=0)
    return f


def pessimistic(params):
    f64, f32 = jnp.float64, jnp.float32
    mpc, mpc32 = ApproxMPC(params, f64), ApproxMPC(params, f32)
    tight, tight32 = tightening(mpc), tightening(mpc32)
    key = jax.random.PRNGKey(params["experiment"]["rnd_seed"]["value"])
    F = mpc.post.mu.shape[1]
    x = jnp.asarray(params["env"]["start"], f64)
    X = jnp.broadcast_to(x[None], (mpc.H + 1, mpc.nx))
    U = jnp.zeros((mpc.H, mpc.nu), f64)
    rec = {k: [] for k in ("z", "x", "X0", "U0", "delta", "X", "U",
                           "status", "f32_X", "f32_U", "f32_delta",
                           "f32_status")}
    for m in range(N_PESS):
        wpath = jnp.asarray(mpc.model.path_generator(m), f64)
        key, sub = jax.random.split(key)
        z32 = np.asarray(jax.random.normal(sub, (mpc.n_tight, mpc.nx, F),
                                           f64), np.float32)
        delta = tight(x, U, jnp.asarray(z32, f64), mpc.post, mpc.W_nominal)
        rec["z"].append(z32)
        rec["x"].append(np.asarray(x))
        rec["X0"].append(np.asarray(X))
        rec["U0"].append(np.asarray(U))
        d32 = tight32(*(jnp.asarray(a, f32) for a in (x, U, z32)),
                      mpc32.post, mpc32.W_nominal)
        X32, U32, s32 = mpc32._solve(
            *(jnp.asarray(a, f32) for a in (x, X, U, wpath)), d32,
            mpc32.W_nominal)
        X, U, status = mpc._solve(x, X, U, wpath, delta, mpc.W_nominal)
        for k, v in (("delta", delta), ("X", X), ("U", U), ("status", status),
                     ("f32_X", X32), ("f32_U", U32), ("f32_delta", d32),
                     ("f32_status", s32)):
            rec[k].append(np.asarray(v))
        print(f"pessimistic step {m}: x {np.round(rec['x'][-1], 4)} status "
              f"{int(status)}; float32 plan max|dX| "
              f"{np.abs(np.asarray(X32) - np.asarray(X)).max():.3e} |dU| "
              f"{np.abs(np.asarray(U32) - np.asarray(U)).max():.3e}",
              flush=True)
        x = mpc.model.discrete_dyn(X[0], U[0])
        X = jnp.concatenate([X[1:], X[-1:]])
        U = jnp.concatenate([U[1:], U[-1:]])
    return {f"pess_{k}": np.stack(v) for k, v in rec.items()}


def optimistic(params):
    f64, f32 = jnp.float64, jnp.float32
    p = optimistic_params(params)
    mpc, mpc32 = ApproxMPC(p, f64), ApproxMPC(p, f32)
    nu = mpc.nu
    x = jnp.asarray(p["env"]["start"], f64)
    X_aug = U_aug = None
    rec = {k: [] for k in ("x", "X", "U", "status", "f32_X", "f32_U",
                           "f32_status")}
    for m in range(N_OPT):
        wpath = jnp.asarray(mpc.model.path_generator(m), f64)
        rec["x"].append(np.asarray(x))
        X32, U32, s32 = mpc32.solve_optimistic(
            jnp.asarray(x, f32), wpath=jnp.asarray(wpath, f32),
            X0=None if X_aug is None else jnp.asarray(X_aug, f32),
            U0=None if U_aug is None else jnp.asarray(U_aug, f32))
        X_a, U_a, status = mpc.solve_optimistic(x, wpath=wpath, X0=X_aug,
                                                U0=U_aug)
        for k, v in (("X", X_a), ("U", U_a), ("status", status),
                     ("f32_X", X32), ("f32_U", U32), ("f32_status", s32)):
            rec[k].append(np.asarray(v))
        print(f"optimistic step {m}: x {np.round(rec['x'][-1], 4)} status "
              f"{status}; float32 plan max|dX| "
              f"{np.abs(np.asarray(X32) - np.asarray(X_a)).max():.3e} |dU| "
              f"{np.abs(np.asarray(U32) - np.asarray(U_a)).max():.3e}",
              flush=True)
        X_aug = jnp.concatenate([X_a[1:], X_a[-1:]])
        U_aug = jnp.concatenate([U_a[1:], U_a[-1:]])
        x = mpc.model.discrete_dyn(X_a[0], U_a[0, :nu])
    # each step's SQP start is the previous plan shifted (zeros at step 0)
    return {f"opt_{k}": np.stack(v) for k, v in rec.items()}


def main():
    params = yaml.safe_load(open(CONFIG))
    t0 = time.time()
    out = {**pessimistic(params), **optimistic(params)}
    for tag in ("pess", "opt"):
        ex = np.abs(out[f"{tag}_f32_X"] - out[f"{tag}_X"]).max()
        eu = np.abs(out[f"{tag}_f32_U"] - out[f"{tag}_U"]).max()
        print(f"{tag}: the JAX float32 path's teacher-forced envelope "
              f"max|dX| {ex:.4e} max|dU| {eu:.4e}")
    print(f"{N_PESS} + {N_OPT} steps in {time.time() - t0:.1f} s")
    np.savez_compressed(OUT, n_pess=N_PESS, n_opt=N_OPT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
