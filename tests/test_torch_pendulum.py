"""The hard-constraint QP family of the port (m_s = 0) vs the JAX package,
float64 on the CPU.

* the plain IPM (``ops/ipm.run_full`` on CPU tensors, the algorithm of the
  kernels' hard-only build) against the XLA body of JAX's
  ``solve_qp_soft`` on the same QPs: the step-0 QPs of params_pendulum
  (nU=30, m_h=2460) and params_car_residual (nU=100, m_h=800), cold and
  warm (their SQP iteration 1, warm-started from iteration 0), and seeded
  QPs at nU = 1 (the H = 1 configs' width): iteration counts equal, the
  scaled best iterate and its residual within 1e-11;
* params_pendulum at ns=5, H=7 against JAX ``DEMPC.run`` on JAX's draws,
  three steps (qp_iters equal, states within 1e-8);
* (slow) the float32 teacher-forced envelope of the JAX package and of the
  port's plain path on tests/goldens/torch_oracle_pendulum.npz and on
  params_car_residual's one step, which sets chip_smoke.py's bars.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu import agent as jagent
from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.config import make_data as jmake_data
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_tpu.ocp import qp as jqp
from sampling_gpmpc_torch import agent as tagent
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.config import make_data as tmake_data
from sampling_gpmpc_torch.dempc import DEMPC
from sampling_gpmpc_torch.envs import make_env as tmake_env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp import qp as tqp
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.spec import make_ocp_data
from sampling_gpmpc_torch.ops import ipm

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PDIR = os.path.join(HERE, "params")
GOLDEN = os.path.join(HERE, "tests", "goldens", "torch_oracle_pendulum.npz")
CAR_GOLDEN = os.path.join(HERE, "tests", "goldens", "params_car_residual.npz")
F64 = torch.float64
@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These loops are chains of small torch ops, which run several times
    slower when the suite's parallel workers oversubscribe the cores with
    torch's intra-op threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# the plain IPM and the XLA body run the same float64 operations in
# another order (torch's and XLA's reductions and Cholesky): same
# iteration count, iterates within 1e-11 of their scale (measured: 1.6e-13)
QP_TOL = 1e-11


def _port(config, dtype=F64):
    params, spec, data = tload(os.path.join(PDIR, config + ".yaml"))
    env = tmake_env(spec, params)
    ocp = make_ocp_data(spec, data, "cpu", dtype)
    hyp = GPHyperArrays.from_spec(spec.gp, "cpu", dtype)
    gp = tagent.init_gp_state(spec, env, "cpu", dtype, hyp=hyp)
    return params, spec, data, env, ocp, hyp, gp


def _jax_eps(config):
    """JAX DEMPC's own epistemic draws of a config (float64)."""
    _, js, _ = jload(os.path.join(PDIR, config + ".yaml"))
    return np.asarray(jagent.make_epistemic(jax.random.PRNGKey(js.seed), js,
                                            jnp.float64))


def _step0_qps(config):
    """The cold QP of SQP iteration 0 of MPC step 0 and the warm QP of
    iteration 1 with iteration 0's carried state, float64."""
    _, spec, data, env, ocp, hyp, gp = _port(config)
    eps = torch.as_tensor(_jax_eps(config)[0].copy())
    st = torch.as_tensor(data.start, dtype=F64)
    X, U = sqp.init_iterate(spec, "cpu", F64, data.start)
    gp = tagent.reset_hall(gp)
    qp0, _, _, _ = sqp.assemble_qp(spec, env, hyp, ocp, st, X, U, gp, eps[0],
                                   hall_empty=True)
    X1, U1, gp1, sol = sqp.sqp_iteration(spec, env, hyp, ocp, st, X, U, gp,
                                         eps[0], hall_empty=True)
    assert int(sol.status) == 0
    qp1, _, _, _ = sqp.assemble_qp(spec, env, hyp, ocp, st, X1, U1, gp1,
                                   eps[1])
    return [(qp0, None), (qp1, sol.state)]


def _both(qp_args, ws):
    """The port's plain solver and JAX's XLA body on the same QP."""
    got = tqp.solve_qp_soft(*qp_args, ws=ws,
                            ws_valid=None if ws is None else torch.tensor(True))
    j = lambda a: jnp.asarray(a.numpy())
    ref = jqp.solve_qp_soft(*map(j, qp_args),
                            ws=None if ws is None else tuple(map(j, ws)),
                            ws_valid=None if ws is None else jnp.asarray(True))
    return got, ref


def _check_qp(got, ref):
    assert int(got.status) == int(ref.status) == 0
    assert int(got.iters) == int(ref.iters)
    for a, b in zip(got.state, ref.state):
        b = np.asarray(b)
        scale = 1.0 + np.abs(b).max(initial=0.0)
        np.testing.assert_allclose(a.numpy(), b, atol=QP_TOL * scale, rtol=0)
    assert abs(float(got.gap) - float(ref.gap)) <= QP_TOL


@pytest.mark.parametrize("config,nU,m_h", [("params_pendulum", 30, 2460),
                                           ("params_car_residual", 100, 800)])
def test_plain_ipm_hard_only_matches_jax_xla(config, nU, m_h):
    """The configs' step-0 QPs, cold then warm: no soft rows, the same
    iterations and iterates as the XLA body of solve_qp_soft."""
    for k, (qp_args, ws) in enumerate(_step0_qps(config)):
        assert (qp_args[1].shape[0], qp_args[3].shape[0],
                qp_args[5].shape[0]) == (nU, m_h, 0)
        if ws is not None:
            assert all(ws[i].numel() == 0 for i in (1, 2, 5, 6, 7, 8, 9, 10))
        got, ref = _both(qp_args, ws)
        _check_qp(got, ref)


@pytest.mark.parametrize("m_h,seed", [(202, 0), (2002, 1), (2002, 2)])
def test_plain_ipm_hard_only_nu1_matches_jax_xla(m_h, seed):
    """Seeded QPs of the kernels' family at nU = 1 (the H = 1 configs),
    cold, then warm from the solution carried to g moved by 1e-3."""
    qp_args = ipm.seeded_qp(1, m_h, 0, seed, "cpu", F64)
    got, ref = _both(qp_args, None)
    _check_qp(got, ref)
    moved = list(qp_args)
    moved[1] = qp_args[1] + 1e-3
    got_w, ref_w = _both(moved, got.state)
    _check_qp(got_w, ref_w)


def _reduced(load, make_data, make_env, over):
    params, spec, data = load(os.path.join(PDIR, "params_pendulum.yaml"))
    spec = dataclasses.replace(spec, **over)
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    data = make_data(params, spec)
    return params, spec, data, make_env(spec, params)


def test_closed_loop_pendulum_matches_jax_f64():
    """params_pendulum at ns=5, H=7, three MPC steps of three SQP
    iterations (both GP stages, the hard-only QP warm-started across
    iterations and steps) on JAX's own draws."""
    from sampling_gpmpc_tpu.dempc import DEMPC as JDEMPC
    over = dict(ns=5, H=7, num_mpc_iter=3, qp_tol=1e-12)
    jm = JDEMPC(*_reduced(jload, jmake_data, jmake_env, over),
                dtype=jnp.float64)
    out_j = jm.run()
    tm = DEMPC(*_reduced(tload, tmake_data, tmake_env, over), device="cpu",
               dtype=F64, epistemic=np.asarray(jm.epistemic))
    out_t = tm.run()
    for k in ("physical_state_traj", "state_traj", "input_traj"):
        np.testing.assert_allclose(np.stack(out_t[k]), np.stack(out_j[k]),
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(out_t["final_state"], out_j["final_state"],
                               atol=1e-8)
    assert out_t["qp_iters"] == out_j["qp_iters"]
    assert out_t["sqp_status_traj"] == out_j["sqp_status_traj"] == [0] * 3


def _problem_j(path):
    params, spec, data = jload(path)
    return params, spec, data, jmake_env(spec, params)


def _teacher_forced_f32(g, steps):
    """Each golden step solved in float32 at the product QP exit from the
    golden's x0, SQP start and draws, by the port's plain path and by the
    JAX package's float32 path.  Returns per step (status port, status
    JAX, |dX| port, |dU| port, |dX| JAX, |dU| JAX) against ``tf_*``."""
    from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
    from sampling_gpmpc_tpu.ocp import sqp as jsqp
    from sampling_gpmpc_tpu.ocp.spec import make_ocp_data as jmake_ocp
    f32 = torch.float32
    _, spec, _, env, ocp, hyp, gp = _port("params_pendulum", f32)
    spec = dataclasses.replace(spec, num_mpc_iter=int(g["n_steps"]))
    jp, js, jd = jload(os.path.join(PDIR, "params_pendulum.yaml"))
    js = dataclasses.replace(js, num_mpc_iter=int(g["n_steps"]))
    jenv = jmake_env(js, jp)
    jf = jnp.float32
    jocp, jhyp = jmake_ocp(js, jd, jf), JHyp.from_spec(js.gp, jf)
    jgp = jagent.init_gp_state(js, jenv, jf)
    jsolve = jax.jit(lambda st, X, U, e: jsqp.solve(js, jenv, jhyp, jocp, st,
                                                    X, U, jgp, e))
    t = lambda a: torch.as_tensor(a, dtype=f32)
    out = []
    for m in steps:
        args = (g["physical_state_traj"][m], g["start_X_traj"][m],
                g["start_U_traj"][m], g["eps"][m])
        x0, X0, U0, eps = map(t, args)
        sp = sqp.solve(spec, env, hyp, ocp, x0, X0, U0, gp, eps)
        sj = jsolve(*(jnp.asarray(a, jf) for a in args))
        out.append((int(sp.status), int(sj.status),
                    float(np.abs(sp.X.numpy() - g["tf_X_traj"][m]).max()),
                    float(np.abs(sp.U.numpy() - g["tf_U_traj"][m]).max()),
                    float(np.abs(np.asarray(sj.X) - g["tf_X_traj"][m]).max()),
                    float(np.abs(np.asarray(sj.U) - g["tf_U_traj"][m]).max())))
    return out


def test_golden_pendulum_first_step_f64():
    """The golden's step 0 solved by the port in float64 at its QP exit
    (1e-12) reproduces the stored teacher-forced plan."""
    g = np.load(GOLDEN)
    _, spec, _, env, ocp, hyp, gp = _port("params_pendulum")
    spec = dataclasses.replace(spec, num_mpc_iter=int(g["n_steps"]),
                               qp_tol=1e-12)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    st = sqp.solve(spec, env, hyp, ocp, t(g["physical_state_traj"][0]),
                   t(g["start_X_traj"][0]), t(g["start_U_traj"][0]), gp,
                   t(g["eps"][0]))
    assert int(st.status) == int(g["tf_status"][0]) == 0
    assert int(st.it) == int(g["tf_sqp_iters"][0])
    np.testing.assert_allclose(st.X.numpy(), g["tf_X_traj"][0], atol=1e-8)
    np.testing.assert_allclose(st.U.numpy(), g["tf_U_traj"][0], atol=1e-8)


@pytest.mark.slow
def test_f32_teacher_forced_pendulum_envelope():
    """float32 at the product QP exit (3e-5): the JAX package's own path
    and the port's plain path on the golden's 10 steps, against its
    float64 teacher-forced plans; chip_smoke.py's TF_PEND_TOL_X/_U are
    about twice the JAX reading.  Prints both envelopes."""
    g = np.load(GOLDEN)
    res = _teacher_forced_f32(g, range(int(g["n_steps"])))
    env = {k: max(r[i] for r in res) for i, k in
           ((2, "port X"), (3, "port U"), (4, "JAX X"), (5, "JAX U"))}
    print(f"\nparams_pendulum float32 teacher-forced envelope: {env}; "
          f"statuses port {[r[0] for r in res]} JAX {[r[1] for r in res]}")
    import chip_smoke
    assert env["JAX X"] <= chip_smoke.TF_PEND_TOL_X / 2
    assert env["JAX U"] <= chip_smoke.TF_PEND_TOL_U / 2
    assert env["port X"] <= chip_smoke.TF_PEND_TOL_X
    assert env["port U"] <= chip_smoke.TF_PEND_TOL_U


@pytest.mark.slow
def test_f32_car_residual_plan_envelope():
    """params_car_residual's one MPC step in float32 (up to 150 SQP
    iterations of the hard-only QP), by the JAX package's float32 path
    and the port's plain path, against params_car_residual.npz's float64
    plan; chip_smoke.py's CAR_RES_TOL_X/_U are about twice the JAX
    reading.  Prints both errors."""
    from sampling_gpmpc_tpu.dempc import DEMPC as JDEMPC
    g = np.load(CAR_GOLDEN)
    path = os.path.join(PDIR, "params_car_residual.yaml")
    jm = JDEMPC(*_problem_j(path), dtype=jnp.float32)
    out_j = jm.run()
    params, spec, data = tload(path)
    tm = DEMPC(params, spec, data, tmake_env(spec, params), device="cpu",
               dtype=torch.float32, epistemic=np.asarray(jm.epistemic))
    out_t = tm.run()
    err = {}
    for name, out in (("JAX", out_j), ("port", out_t)):
        err[name + " X"] = float(np.abs(out["state_traj"][-1]
                                        - g["last_plan_X"]).max())
        err[name + " U"] = float(np.abs(out["input_traj"][-1]
                                        - g["last_plan_U"]).max())
        assert out["sqp_status_traj"] == [0]
    print(f"\nparams_car_residual float32 plan error: {err}")
    import chip_smoke
    assert err["JAX X"] <= chip_smoke.CAR_RES_TOL_X / 2
    assert err["JAX U"] <= chip_smoke.CAR_RES_TOL_U / 2
    assert err["port X"] <= chip_smoke.CAR_RES_TOL_X
    assert err["port U"] <= chip_smoke.CAR_RES_TOL_U
