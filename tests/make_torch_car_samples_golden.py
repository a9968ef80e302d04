"""Write tests/goldens/torch_oracle_car_samples.npz: the one MPC step of
params_car_samples (H = 100, ns = 10, four SQP iterations; its QP has nU =
200, m_h = 400, m_s = 5010) in the JAX package on the CPU, the reference
that chip_smoke.py's car_samples phase holds the port's float32 step on
the H100 against.

The epistemic draws come from ``jax.random`` (``make_epistemic`` on the
config's seed), are rounded to float32 and fed back as float64, so that a
float32 and a float64 consumer see identical draws.  Stored: the draws,
the measured state, the SQP start (``init_iterate``), and the plan (X, U)
after each SQP iteration k = 1..4 in float64 (``plan_X_k`` ...: the step
solved with max_sqp_iter = k, each from the same start), with each
solve's SQP iterations and status; and the JAX float32 path's plan after
each k (``f32_plan_*``), whose distance from the float64 plan is the
envelope chip_smoke.py's bar is set from.  The QP tolerance is the
config's, as in the JAX package's own run.

Run from the repository root (a few minutes: XLA compiles the H = 100
solve four times per dtype):

    python tests/make_torch_car_samples_golden.py
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

OUT = os.path.join(HERE, "tests", "goldens", "torch_oracle_car_samples.npz")


def main():
    params, spec, data = load_problem(
        os.path.join(HERE, "params", "params_car_samples.yaml"))
    assert spec.num_mpc_iter == 1 and spec.max_sqp_iter == 4
    env = make_env(spec, params)
    eps32 = np.asarray(agent_mod.make_epistemic(
        jax.random.PRNGKey(spec.seed), spec, jnp.float64), np.float32)
    out = dict(eps=eps32, x0=np.asarray(data.start), ns=spec.ns, H=spec.H,
               max_sqp_iter=spec.max_sqp_iter)
    t0 = time.time()
    for tag, dtype in (("", jnp.float64), ("f32_", jnp.float32)):
        ocp = make_ocp_data(spec, data, dtype)
        hyp = GPHyperArrays.from_spec(spec.gp, dtype)
        gp = agent_mod.init_gp_state(spec, env, dtype)
        x = jnp.asarray(data.start, dtype)
        X0, U0 = sqp.init_iterate(spec, dtype, data.start)
        if not tag:
            out.update(X0=np.asarray(X0), U0=np.asarray(U0))
        for k in range(1, spec.max_sqp_iter + 1):
            sk = dataclasses.replace(spec, max_sqp_iter=k)
            st = jax.jit(lambda x, X, U, gp, e: sqp.solve(
                sk, env, hyp, ocp, x, X, U, gp, e))(
                x, X0, U0, gp, jnp.asarray(eps32[0, :k], dtype))
            out[f"{tag}plan_X_{k}"] = np.asarray(st.X)
            out[f"{tag}plan_U_{k}"] = np.asarray(st.U)
            out[f"{tag}sqp_iters_{k}"] = int(st.it)
            out[f"{tag}status_{k}"] = int(st.status)
            print(f"{dtype.__name__} max_sqp_iter={k}: {int(st.it)} SQP "
                  f"iterations, status {int(st.status)}, QP iterations "
                  f"{int(st.qp_iters)} ({time.time() - t0:.1f} s)",
                  flush=True)
    k = spec.max_sqp_iter
    for j in range(1, k + 1):
        ex = np.abs(out[f"f32_plan_X_{j}"] - out[f"plan_X_{j}"]).max()
        eu = np.abs(out[f"f32_plan_U_{j}"] - out[f"plan_U_{j}"]).max()
        print(f"after SQP iteration {j}: the JAX float32 path's plan max|dX| "
              f"{ex:.4e} max|dU| {eu:.4e} from the float64 plan")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
