"""Write tests/goldens/torch_oracle_bench_ns512.npz: the bench's closed-loop
chain at its large-ns row (params_pendulum1D_samples at ns = 512, H = 20,
one RTI iteration a step; its QP has nU = 20, m_h = 61,480, m_s = 512) in
the JAX package on the CPU, the reference that chip_smoke.py's bench phase
holds the port's float32 kernel route on the H100 against.

The chain is the JAX bench's ``_mpc_step`` (bench.py): ``sqp.solve`` with
the QP warm start carried, the ancillary feedback on the plan's first
input, the plant step ``env.discrete_dyn``, the solution shift.  It starts
where the bench starts: the config's start state, ``init_iterate`` and a
cold QP.  The epistemic draws come from ``jax.random`` (``make_epistemic``
on the config's seed), rounded to float32 and fed back as float64, so that
a float32 and a float64 consumer see identical draws.

Stored, for STEPS steps of the float64 chain: the draws ``eps``, the
state entering each step ``x`` (STEPS + 1 states), the plan each solve
returns before the shift ``X`` and ``U``, each step's QP status and
Mehrotra iterations.  Then the JAX float32 path teacher-forced on that
chain: each step solved from the float64 chain's state and shifted plan,
with its own float32 QP warm start carried; its distance from the float64
plan per step (``f32_dX``, ``f32_dU``) is the envelope chip_smoke.py's bar
is set from.

Run from the repository root (about a minute on the CPU):

    python tests/make_torch_bench_golden.py
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
from sampling_gpmpc_tpu.config import load_problem, make_data  # noqa: E402
from sampling_gpmpc_tpu.dempc import shift_solution  # noqa: E402
from sampling_gpmpc_tpu.envs import make_env  # noqa: E402
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays  # noqa: E402
from sampling_gpmpc_tpu.ocp import sqp  # noqa: E402
from sampling_gpmpc_tpu.ocp.spec import make_ocp_data  # noqa: E402

OUT = os.path.join(HERE, "tests", "goldens", "torch_oracle_bench_ns512.npz")
NS, H, STEPS = 512, 20, 10


def chain_step(spec, env, dtype, data):
    """The JAX bench's ``_mpc_step`` as one compiled function of the carry
    (x, X, U, gp, qp_ws, qp_valid) and the step's draws; also returns the
    plan before the shift and the solve's status and QP iterations."""
    ocp = make_ocp_data(spec, data, dtype)
    hyp = GPHyperArrays.from_spec(spec.gp, dtype)
    K_fb = jnp.asarray(data.K_fb, dtype) if spec.use_feedback else None
    goal = jnp.asarray(data.goal, dtype)

    def step(x, X, U, gp, ws, wv, eps):
        st = sqp.solve(spec, env, hyp, ocp, x, X, U, gp, eps, qp_ws=ws,
                       qp_valid=wv)
        u0 = st.U[0]
        if K_fb is not None:
            u0 = u0 - (goal - st.X[0, 0]) @ K_fb.T
        x_next = env.discrete_dyn(st.X[0, 0], u0).reshape(-1)
        Xs, Us = shift_solution(spec, st.X, st.U) if spec.shift_soln else (
            st.X, st.U)
        return (x_next, Xs, Us, st.gp, st.qp_ws, st.qp_valid, st.X, st.U,
                st.status, st.qp_iters)

    return jax.jit(step)


def carry0(spec, env, dtype, data):
    X, U = sqp.init_iterate(spec, dtype, data.start)
    return (jnp.asarray(data.start, dtype), X, U,
            agent_mod.init_gp_state(spec, env, dtype),
            sqp.init_qp_ws(spec, dtype), jnp.asarray(False))


def main():
    params, spec, data = load_problem(
        os.path.join(HERE, "params", "params_pendulum1D_samples.yaml"))
    spec = dataclasses.replace(spec, ns=NS, H=H, max_sqp_iter=1,
                               num_mpc_iter=STEPS)
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    data = make_data(params, spec)
    env = make_env(spec, params)
    eps32 = np.asarray(agent_mod.make_epistemic(
        jax.random.PRNGKey(spec.seed), spec, jnp.float64), np.float32)
    t0 = time.time()

    f64 = jnp.float64
    step = chain_step(spec, env, f64, data)
    c = carry0(spec, env, f64, data)
    xs, Xs, Us, status, iters = [np.asarray(c[0])], [], [], [], []
    Xin, Uin = [np.asarray(c[1])], [np.asarray(c[2])]
    for m in range(STEPS):
        out = step(*c, jnp.asarray(eps32[m], f64))
        c = out[:6]
        xs.append(np.asarray(out[0]))
        Xin.append(np.asarray(out[1]))
        Uin.append(np.asarray(out[2]))
        Xs.append(np.asarray(out[6]))
        Us.append(np.asarray(out[7]))
        status.append(int(out[8]))
        iters.append(int(out[9]))
        print(f"float64 step {m}: status {status[-1]}, QP iterations "
              f"{iters[-1]}, x {xs[-1]} ({time.time() - t0:.1f} s)",
              flush=True)

    f32 = jnp.float32
    step32 = chain_step(spec, env, f32, data)
    c = carry0(spec, env, f32, data)
    dX, dU, status32 = [], [], []
    for m in range(STEPS):
        c = (jnp.asarray(xs[m], f32), jnp.asarray(Xin[m], f32),
             jnp.asarray(Uin[m], f32)) + tuple(c[3:6])
        out = step32(*c, jnp.asarray(eps32[m], f32))
        c = out[:6]
        dX.append(float(np.abs(np.asarray(out[6], np.float64) - Xs[m]).max()))
        dU.append(float(np.abs(np.asarray(out[7], np.float64) - Us[m]).max()))
        status32.append(int(out[8]))
    print(f"the JAX float32 path teacher-forced: statuses {status32}; "
          f"max|dX| {max(dX):.4e}, max|dU| {max(dU):.4e} from the float64 "
          f"chain; per step dX {[f'{v:.2e}' for v in dX]}, dU "
          f"{[f'{v:.2e}' for v in dU]}", flush=True)
    np.savez_compressed(
        OUT, eps=eps32, x=np.stack(xs), X=np.stack(Xs), U=np.stack(Us),
        status=np.asarray(status), qp_iters=np.asarray(iters),
        f32_dX=np.asarray(dX), f32_dU=np.asarray(dU),
        f32_status=np.asarray(status32), ns=NS, H=H, steps=STEPS)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B) in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
