"""SQP solve and closed loop of the PyTorch port vs the JAX package and the
stored float64 oracle of the flagship config.

* one ``sqp.solve`` and a short DEMPC closed loop match JAX in float64 on
  the same epistemic draws (1e-8: same algorithm, same QP exit);
* teacher-forced per-step solves of params_pendulum1D_samples (ns=70,
  H=17) against tests/goldens/oracle_pendulum1d_flagship.npz with the QP
  exit tightened to 1e-12, under test_oracle_parity.py's bars (status 0,
  X <= 1e-3, U <= 1e-2): steps 0-2 here, all 20 under ``slow``;
* (slow) the float32 envelope of those 20 steps, for the JAX package and
  the port, which sets chip_smoke.py's teacher-forced float32 tolerance.
"""

import dataclasses
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.config import make_data as jmake_data
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_torch import agent as tagent
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.config import make_data as tmake_data
from sampling_gpmpc_torch.dempc import DEMPC, shift_solution
from sampling_gpmpc_torch.envs import make_env as tmake_env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.spec import make_ocp_data
from sampling_gpmpc_torch.recorder import Recorder

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(HERE, "params", "params_pendulum1D_samples.yaml")
GOLDEN = os.path.join(HERE, "tests", "goldens",
                      "oracle_pendulum1d_flagship.npz")
F32_TOL_X, F32_TOL_U = 0.5, 5.0     # chip_smoke.py TF_TOL_X / TF_TOL_U


def _problem(load, make_data, make_env, **over):
    params, spec, data = load(PARAMS)
    spec = dataclasses.replace(spec, **over)
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    data = make_data(params, spec)
    return params, spec, data, make_env(spec, params)


def test_closed_loop_matches_jax_f64(tmp_path):
    """Three MPC steps at ns=5, H=7: every SQP solve, the QP warm start
    carried across steps and the plant step, on JAX's own draws."""
    from sampling_gpmpc_tpu.dempc import DEMPC as JDEMPC
    over = dict(ns=5, H=7, num_mpc_iter=3, qp_tol=1e-12)
    jprob = _problem(jload, jmake_data, jmake_env, **over)
    tprob = _problem(tload, tmake_data, tmake_env, **over)
    jm = JDEMPC(*jprob, dtype=jnp.float64)
    out_j = jm.run()
    rec = Recorder(tprob[0], str(tmp_path))
    tm = DEMPC(*tprob, device="cpu", dtype=torch.float64,
               epistemic=np.asarray(jm.epistemic), recorder=rec)
    out_t = tm.run()
    for k in ("physical_state_traj", "state_traj", "input_traj"):
        np.testing.assert_allclose(np.stack(out_t[k]), np.stack(out_j[k]),
                                   atol=1e-8, err_msg=k)
    assert out_t["qp_iters"] == out_j["qp_iters"]
    assert out_t["sqp_status_traj"] == out_j["sqp_status_traj"] == [0] * 3
    # the artifact carries the keys visu.py and the replay tools read
    with open(rec.save_data(), "rb") as f:
        art = pickle.load(f)
    for k in ("state_traj", "input_traj", "physical_state_traj",
              "true_state_traj", "mean_state_traj", "solver_time",
              "gp_model_after_solve_train_X", "gp_model_after_solve_train_Y"):
        assert len(art[k]) == 3, k
    assert art["state_traj"][0].shape == (over["H"] + 1, over["ns"] * 2)
    assert np.all(np.isfinite(art["mean_state_traj"][0]))


def test_sqp_solve_matches_jax_f64():
    """One SQP-RTI solve on JAX's own GP state, OCP data and draws carried
    across with convert.py, then a second solve warm-started from the
    carried QP state."""
    import jax

    from sampling_gpmpc_tpu import agent as jagent
    from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
    from sampling_gpmpc_tpu.ocp import sqp as jsqp
    from sampling_gpmpc_tpu.ocp.spec import make_ocp_data as jmake_ocp
    from sampling_gpmpc_torch import convert

    over = dict(ns=6, H=9, num_mpc_iter=2, qp_tol=1e-12)
    params, jspec, jdata, jenv = _problem(jload, jmake_data, jmake_env, **over)
    _, tspec, _, tenv = _problem(tload, tmake_data, tmake_env, **over)
    f64 = jnp.float64
    jocp, jhyp = jmake_ocp(jspec, jdata, f64), JHyp.from_spec(jspec.gp, f64)
    jgp = jagent.init_gp_state(jspec, jenv, f64)
    eps = jagent.make_epistemic(jax.random.PRNGKey(3), jspec, f64)
    X0, U0 = jsqp.init_iterate(jspec, f64, jdata.start)
    st = jnp.asarray(jdata.start, f64)
    # one compiled solve for both calls (op-by-op dispatch compiles each op)
    jsolve = jax.jit(lambda s, X, U, e, ws, wv: jsqp.solve(
        jspec, jenv, jhyp, jocp, s, X, U, jgp, e, qp_ws=ws, qp_valid=wv))
    j1 = jsolve(st, X0, U0, eps[0], jsqp.init_qp_ws(jspec, f64),
                jnp.asarray(False))
    j2 = jsolve(st + 0.01, j1.X, j1.U, eps[1], j1.qp_ws, j1.qp_valid)

    to = dict(device="cpu", dtype=torch.float64)
    tocp = convert.ocp_data({k: np.asarray(v)
                             for k, v in jocp._asdict().items()}, **to)
    thyp = convert.hyper(jhyp.lengthscale, jhyp.outputscale,
                         jhyp.noise_diag, jhyp.jitter, jhyp.beta,
                         jhyp.variance_is_zero, jhyp.min_data_dist, **to)
    tgp = convert.gp_state(jgp.real_Z, jgp.real_Y,
                           {k: np.asarray(v) for k, v in jgp.real_fact.items()},
                           jgp.hall_Z, jgp.hall_Y, jgp.hall_n, **to)
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    t1 = sqp.solve(tspec, tenv, thyp, tocp, t(st), t(X0), t(U0), tgp,
                   t(eps[0]))
    t2 = sqp.solve(tspec, tenv, thyp, tocp, t(st + 0.01), t1.X, t1.U, tgp,
                   t(eps[1]), qp_ws=convert.qp_warm_start(
                       [np.asarray(a) for a in j1.qp_ws], **to),
                   qp_valid=torch.tensor(bool(j1.qp_valid)))
    for jj, tt in ((j1, t1), (j2, t2)):
        assert int(tt.status) == int(jj.status) == 0
        assert int(tt.qp_iters) == int(jj.qp_iters)
        np.testing.assert_allclose(tt.X.numpy(), np.asarray(jj.X), atol=1e-8)
        np.testing.assert_allclose(tt.U.numpy(), np.asarray(jj.U), atol=1e-8)
        np.testing.assert_allclose(tt.gp.hall_Y.numpy(),
                                   np.asarray(jj.gp.hall_Y), atol=1e-8)


def _teacher_forced(steps, dtype, qp_tol):
    """Per-step port solves from the golden's x0, shifted plan and draws.
    Returns per-step (status, max|dX|, max|dU|)."""
    g = np.load(GOLDEN)
    params, spec, data = tload(PARAMS)
    spec = dataclasses.replace(spec, num_mpc_iter=int(g["n_steps"]),
                               qp_tol=qp_tol)
    env = tmake_env(spec, params)
    ocp = make_ocp_data(spec, data, "cpu", dtype)
    hyp = GPHyperArrays.from_spec(spec.gp, "cpu", dtype)
    gp0 = tagent.init_gp_state(spec, env, "cpu", dtype, hyp=hyp)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    pX, pU, phys = g["plan_X_traj"], g["plan_U_traj"], g["physical_state_traj"]
    out = []
    for m in steps:
        if m == 0:
            X0, U0 = sqp.init_iterate(spec, "cpu", dtype, data.start)
        else:
            X0, U0 = shift_solution(t(pX[m - 1]), t(pU[m - 1]))
        st = sqp.solve(spec, env, hyp, ocp, t(phys[m]), X0, U0, gp0,
                       t(g["eps"][m]))
        out.append((int(st.status),
                    float(np.abs(st.X.numpy() - pX[m]).max()),
                    float(np.abs(st.U.numpy() - pU[m]).max())))
    return out


def _check_oracle_bars(res):
    for m, (status, dx, du) in enumerate(res):
        assert status == 0, m
        assert dx <= 1e-3 and du <= 1e-2, (m, dx, du)


def test_teacher_forced_first_steps_vs_oracle():
    _check_oracle_bars(_teacher_forced(range(3), torch.float64, 1e-12))


@pytest.mark.slow
def test_teacher_forced_all_steps_vs_oracle():
    _check_oracle_bars(_teacher_forced(range(20), torch.float64, 1e-12))


@pytest.mark.slow
def test_f32_teacher_forced_envelope():
    """float32 at the product QP exit (3e-5): the JAX package's own path
    and the port's plain path stay inside chip_smoke.py's teacher-forced
    tolerance and have the same envelope (measured: max|dX| 0.229 JAX,
    0.230 port; max|dU| 3.02 / 3.03, both at step 2)."""
    import jax

    from sampling_gpmpc_tpu import agent as jagent
    from sampling_gpmpc_tpu.dempc import shift_solution as jshift
    from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
    from sampling_gpmpc_tpu.ocp import sqp as jsqp
    from sampling_gpmpc_tpu.ocp.spec import make_ocp_data as jmake_ocp

    port = _teacher_forced(range(20), torch.float32, -1.0)
    g = np.load(GOLDEN)
    params, spec, data = jload(PARAMS)
    spec = dataclasses.replace(spec, num_mpc_iter=20)
    env = jmake_env(spec, params)
    f32 = jnp.float32
    ocp, hyp = jmake_ocp(spec, data, f32), JHyp.from_spec(spec.gp, f32)
    gp0 = jagent.init_gp_state(spec, env, f32)
    solve = jax.jit(lambda st, X, U, e: jsqp.solve(
        spec, env, hyp, ocp, st, X, U, gp0, e))
    ref = []
    for m in range(20):
        if m == 0:
            X0, U0 = jsqp.init_iterate(spec, f32, data.start)
        else:
            X0, U0 = jshift(spec, jnp.asarray(g["plan_X_traj"][m - 1], f32),
                            jnp.asarray(g["plan_U_traj"][m - 1], f32))
        st = solve(jnp.asarray(g["physical_state_traj"][m], f32), X0, U0,
                   jnp.asarray(g["eps"][m], f32))
        ref.append((int(st.status),
                    float(np.abs(np.asarray(st.X) - g["plan_X_traj"][m]).max()),
                    float(np.abs(np.asarray(st.U) - g["plan_U_traj"][m]).max())))
    for res in (port, ref):
        assert all(s == 0 for s, _, _ in res)
        assert max(dx for _, dx, _ in res) <= F32_TOL_X
        assert max(du for _, _, du in res) <= F32_TOL_U
    env_port = max(dx for _, dx, _ in port)
    env_jax = max(dx for _, dx, _ in ref)
    assert abs(env_port - env_jax) <= 0.2 * env_jax
