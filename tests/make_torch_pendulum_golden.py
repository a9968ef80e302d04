"""Write tests/goldens/torch_oracle_pendulum.npz: 10 params_pendulum MPC
steps of the JAX package in float64 on the CPU, the reference that
chip_smoke.py's teacher-forced 2D pendulum steps are held against.

The epistemic draws come from ``jax.random`` (the config's seed), are
rounded to float32 and fed back as float64, so that a float32 and a
float64 consumer see identical draws.  The QP exit is pinned at 1e-12 (as
tests/test_oracle_parity.py does).  Stored per step: the draws, the
measured state ``x0``, the SQP start (the shifted previous plan), the plan
(X, U) of the free-running loop, its SQP iterations and status; and the
teacher-forced solve (``tf_*``: the same state, start and draws from a cold
QP start, as chip_smoke.py solves each step).

Run from the repository root (about a minute):

    python tests/make_torch_pendulum_golden.py
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
from sampling_gpmpc_tpu.dempc import shift_solution  # noqa: E402
from sampling_gpmpc_tpu.envs import make_env  # noqa: E402
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays  # noqa: E402
from sampling_gpmpc_tpu.ocp import sqp  # noqa: E402
from sampling_gpmpc_tpu.ocp.spec import make_ocp_data  # noqa: E402

OUT = os.path.join(HERE, "tests", "goldens", "torch_oracle_pendulum.npz")
N_STEPS = 10


def main():
    params, spec, data = load_problem(
        os.path.join(HERE, "params", "params_pendulum.yaml"))
    spec = dataclasses.replace(spec, num_mpc_iter=N_STEPS, qp_tol=1e-12)
    assert spec.shift_soln and not spec.use_feedback
    assert not spec.dynamics_rejection
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
    phys, starts_X, starts_U, plans_X, plans_U = [], [], [], [], []
    its, status = [], []
    t0 = time.time()
    for m in range(N_STEPS):
        starts_X.append(np.asarray(X))
        starts_U.append(np.asarray(U))
        st = solve(x, X, U, gp, eps[m], ws, wv)
        X, U, gp, ws, wv = st.X, st.U, st.gp, st.qp_ws, st.qp_valid
        phys.append(np.asarray(x))
        plans_X.append(np.asarray(X))
        plans_U.append(np.asarray(U))
        its.append(int(st.it))
        status.append(int(st.status))
        x = plant(X[0, 0], U[0]).reshape(-1)
        X, U = shift_solution(spec, X, U)
        print(f"step {m}: x {np.round(phys[-1], 4)} sqp iterations {its[-1]}"
              f" status {status[-1]}", flush=True)
    tf_X, tf_U, tf_its, tf_status = [], [], [], []
    cold_ws, cold_wv = sqp.init_qp_ws(spec, f64), jnp.asarray(False)
    for m in range(N_STEPS):
        st = solve(jnp.asarray(phys[m]), jnp.asarray(starts_X[m]),
                   jnp.asarray(starts_U[m]), gp, eps[m], cold_ws, cold_wv)
        tf_X.append(np.asarray(st.X))
        tf_U.append(np.asarray(st.U))
        tf_its.append(int(st.it))
        tf_status.append(int(st.status))
        print(f"teacher-forced step {m}: status {tf_status[-1]}, max|X - "
              f"plan| {np.abs(tf_X[-1] - plans_X[m]).max():.3e}", flush=True)
    print(f"{N_STEPS} steps in {time.time() - t0:.1f} s")
    np.savez_compressed(
        OUT, eps=eps32, physical_state_traj=np.stack(phys),
        start_X_traj=np.stack(starts_X), start_U_traj=np.stack(starts_U),
        plan_X_traj=np.stack(plans_X), plan_U_traj=np.stack(plans_U),
        sqp_iters=np.asarray(its), status=np.asarray(status),
        tf_X_traj=np.stack(tf_X), tf_U_traj=np.stack(tf_U),
        tf_sqp_iters=np.asarray(tf_its), tf_status=np.asarray(tf_status),
        final_state=np.asarray(x), ns=spec.ns, H=spec.H, n_steps=N_STEPS,
        max_sqp_iter=spec.max_sqp_iter)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
