"""Write tests/goldens/torch_oracle_car.npz: 12 params_car MPC steps of the
JAX package in float64 on the CPU, the reference that the PyTorch port's
teacher-forced car tests and chip_smoke.py hold each step against.

The epistemic draws come from ``jax.random`` (the config's seed), are
rounded to float32 and fed back as float64, so that a float32 and a
float64 consumer see identical draws.  The QP exit is pinned at 1e-12
(as tests/test_oracle_parity.py does).  Stored per step: the draws, the
measured state, the plan (X, U) of the free-running loop, the SQP
iterations and the QP status; and the teacher-forced solve (``tf_*``: the same state, previous plan and draws
from a cold QP start, as the tests and chip_smoke.py solve each step).
The QP's stall exit stops the cold and the warm start at slightly
different points, and four SQP iterations amplify that (up to 4e-2 in X
at step 4 in float64), so a teacher-forced step is held against ``tf_*``.

Run from the repository root (about a minute):

    python benchmarking/make_torch_car_golden.py
"""
import dataclasses
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from sampling_gpmpc_tpu.setup import enable_x64, force_cpu_mesh  # noqa: E402

force_cpu_mesh(1)
enable_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sampling_gpmpc_tpu import agent as agent_mod  # noqa: E402
from sampling_gpmpc_tpu.config import load_problem  # noqa: E402
from sampling_gpmpc_tpu.envs import make_env  # noqa: E402
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays  # noqa: E402
from sampling_gpmpc_tpu.ocp import sqp  # noqa: E402
from sampling_gpmpc_tpu.ocp.spec import make_ocp_data  # noqa: E402

OUT = os.path.join(HERE, "tests", "goldens", "torch_oracle_car.npz")
N_STEPS = 12


def main():
    params, spec, data = load_problem(
        os.path.join(HERE, "params", "params_car.yaml"))
    spec = dataclasses.replace(spec, num_mpc_iter=N_STEPS, qp_tol=1e-12)
    env = make_env(spec, params)
    f64 = jnp.float64
    ocp, hyp = make_ocp_data(spec, data, f64), GPHyperArrays.from_spec(
        spec.gp, f64)
    gp = agent_mod.init_gp_state(spec, env, f64)
    eps32 = np.asarray(agent_mod.make_epistemic(
        jax.random.PRNGKey(spec.seed), spec, f64), np.float32)
    eps = jnp.asarray(eps32, f64)
    solve = jax.jit(lambda st, X, U, gp, e, ws, wv: sqp.solve(
        spec, env, hyp, ocp, st, X, U, gp, e, qp_ws=ws, qp_valid=wv))
    plant = jax.jit(env.discrete_dyn)

    x = jnp.asarray(data.start, f64)
    X, U = sqp.init_iterate(spec, f64, data.start)
    ws, wv = sqp.init_qp_ws(spec, f64), jnp.asarray(False)
    phys, plans_X, plans_U, its, status = [], [], [], [], []
    t0 = time.time()
    for m in range(N_STEPS):
        st = solve(x, X, U, gp, eps[m], ws, wv)
        X, U, gp, ws, wv = st.X, st.U, st.gp, st.qp_ws, st.qp_valid
        phys.append(np.asarray(x))
        plans_X.append(np.asarray(X))
        plans_U.append(np.asarray(U))
        its.append(int(st.it))
        status.append(int(st.status))
        x = plant(X[0, 0], U[0]).reshape(-1)        # shift_soln: False
        print(f"step {m}: x {np.round(phys[-1], 4)} sqp iterations {its[-1]}"
              f" status {status[-1]}", flush=True)
    tf_X, tf_U, tf_its = [], [], []
    cold_ws, cold_wv = sqp.init_qp_ws(spec, f64), jnp.asarray(False)
    for m in range(N_STEPS):
        if m == 0:
            X0, U0 = sqp.init_iterate(spec, f64, data.start)
        else:
            X0, U0 = jnp.asarray(plans_X[m - 1]), jnp.asarray(plans_U[m - 1])
        st = solve(jnp.asarray(phys[m]), X0, U0, gp, eps[m], cold_ws,
                   cold_wv)
        tf_X.append(np.asarray(st.X))
        tf_U.append(np.asarray(st.U))
        tf_its.append(int(st.it))
        print(f"teacher-forced step {m}: max|X - plan| "
              f"{np.abs(tf_X[-1] - plans_X[m]).max():.3e}", flush=True)
    print(f"{N_STEPS} steps in {time.time() - t0:.1f} s")
    np.savez_compressed(
        OUT, eps=eps32, physical_state_traj=np.stack(phys),
        plan_X_traj=np.stack(plans_X), plan_U_traj=np.stack(plans_U),
        sqp_iters=np.asarray(its), status=np.asarray(status),
        tf_X_traj=np.stack(tf_X), tf_U_traj=np.stack(tf_U),
        tf_sqp_iters=np.asarray(tf_its),
        final_state=np.asarray(x), ns=spec.ns, H=spec.H, n_steps=N_STEPS,
        max_sqp_iter=spec.max_sqp_iter)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
