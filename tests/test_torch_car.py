"""The params_car slice of the PyTorch port vs the JAX package.

* the bicycle car env against the JAX env in float64 (1e-12: the same
  closed forms) and its analytic Jacobians against torch.func autodiff;
* the block-update posterior (condition_update + predict_update) against
  the JAX versions in float64 on a filled hallucination buffer (1e-10: the
  same factorizations, only summation order differs);
* the hall-block GP stage of sample_dynamics (draw + append) against JAX
  in float64 (1e-8), with the overrides off and on;
* one reduced car ``sqp.solve`` (ns=4, H=6) in float64 against the JAX
  solve through every hall iteration (1e-8), and the SQP step
  consumption (failed-QP revert, stall-gated under-relaxation) against
  JAX's over a scripted run of iterations (1e-12);
* teacher-forced full-width car steps against
  tests/goldens/torch_oracle_car.npz (12 JAX float64 steps, written by
  benchmarking/make_torch_car_golden.py; each step's cold-start solve
  ``tf_*``): float64 at 1e-8 on two steps; (slow) the float32 envelope of
  all 12, which sets chip_smoke.py's teacher-forced car bars.
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
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
from sampling_gpmpc_tpu.ocp import sqp as jsqp
from sampling_gpmpc_tpu.ocp.spec import make_ocp_data as jmake_ocp
from sampling_gpmpc_torch import agent as tagent
from sampling_gpmpc_torch import convert
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.config import make_data as tmake_data
from sampling_gpmpc_torch.envs import make_env as tmake_env
from sampling_gpmpc_torch.gp import exact as texact
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.spec import make_ocp_data

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(HERE, "params", "params_car.yaml")
GOLDEN = os.path.join(HERE, "tests", "goldens", "torch_oracle_car.npz")
ENV_TOL = 1e-12
# chip_smoke.py TF_CAR_TOL_X / TF_CAR_TOL_U: float32 teacher-forced car
# steps against the float64 golden (see test_f32_teacher_forced_car_envelope)
F32_TOL_X, F32_TOL_U = 3.0, 2.0


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _problem(load, make_data, make_env, **over):
    params, spec, data = load(PARAMS)
    spec = dataclasses.replace(spec, **over)
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    data = make_data(params, spec)
    return params, spec, data, make_env(spec, params)


@pytest.fixture(scope="module")
def envs():
    jp, js, _ = jload(PARAMS)
    tp, ts, _ = tload(PARAMS)
    return jmake_env(js, jp), tmake_env(ts, tp)


def _points(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 70, n), rng.uniform(0, 6, n),
                     rng.uniform(-1.1, 1.1, n), rng.uniform(-1, 15, n),
                     rng.uniform(-0.6, 0.6, n), rng.uniform(-2, 2, n)],
                    axis=-1)                                # (n, nx+nu)


def test_car_dynamics_match_jax(envs):
    jenv, tenv = envs
    xu = _points()
    txu, jxu = torch.as_tensor(xu), jnp.asarray(xu)
    pairs = [
        (jax.vmap(jenv.f_val_jac)(jxu), tenv.f_val_jac(txu)),
        (jax.vmap(jenv.g_val)(jenv.g_inputs(jxu)),
         tenv.g_val(tenv.g_inputs(txu))),
        (jax.vmap(jenv.g_prior)(jenv.g_inputs(jxu)),
         tenv.g_prior(tenv.g_inputs(txu))),
        (jax.vmap(jenv.B_d)(jxu), tenv.B_d(txu)),
        (jax.vmap(jenv.discrete_dyn)(jxu[:, :4], jxu[:, 4:]),
         tenv.discrete_dyn(txu[:, :4], txu[:, 4:])),
    ]
    dg = np.random.default_rng(1).normal(size=(xu.shape[0], 3, 4))
    pairs.append((jax.vmap(jenv.assemble_val_jac)(jxu, jnp.asarray(dg)),
                  tenv.assemble_val_jac(txu, torch.as_tensor(dg))))
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ENV_TOL, rtol=ENV_TOL)


def test_car_training_grid_matches_jax(envs):
    jenv, tenv = envs
    (jX, jY), (tX, tY) = jenv.training_grid(), tenv.training_grid()
    assert tX.shape == (45, 3) and tY.shape == (3, 45, 4)   # Rr = 45 * 4
    np.testing.assert_allclose(tX, jX, atol=ENV_TOL)
    np.testing.assert_allclose(tY, jY, atol=ENV_TOL)


def test_car_analytic_jacobians_match_autodiff(envs):
    """f_val_jac's derivative columns and g_prior's gradient entries are
    the Jacobians of their value columns (torch.func.jacfwd)."""
    _, tenv = envs
    for xu in torch.as_tensor(_points(4, seed=2)):
        J = torch.func.jacfwd(lambda v: tenv.f_val_jac(v)[:, 0])(xu)
        np.testing.assert_allclose(tenv.f_val_jac(xu)[:, 1:].numpy(),
                                   J.numpy(), atol=ENV_TOL)
        z = tenv.g_inputs(xu)
        Jg = torch.func.jacfwd(tenv.g_val)(z)
        np.testing.assert_allclose(tenv.g_prior(z)[:, 1:].numpy(),
                                   Jg.numpy(), atol=ENV_TOL)


@pytest.fixture(scope="module")
def filled():
    """A reduced car (ns=4, H=6) on both sides: the JAX GP state after two
    appends (iteration 0 at one iterate, then a hall iteration at a
    perturbed one), so hall_n = 2H with some rows of realistic spread."""
    over = dict(ns=4, H=6, max_sqp_iter=4, num_mpc_iter=1)
    j = _problem(jload, jmake_data, jmake_env, **over)
    t = _problem(tload, tmake_data, tmake_env, **over)
    spec, env = j[1], j[3]
    f64 = jnp.float64
    hyp = JHyp.from_spec(spec.gp, f64)
    gp = jagent.init_gp_state(spec, env, f64)
    rng = np.random.default_rng(4)
    H = spec.H
    base = np.stack([np.linspace(-0.2, 0.3, H), np.linspace(1.0, 4.0, H),
                     np.linspace(-0.3, 0.4, H)], -1)
    Xts = [base[None] + 0.05 * rng.normal(size=(spec.ns, H, 3))
           for _ in range(3)]
    eps = [np.clip(rng.normal(size=(spec.ns, spec.g_ny, H, spec.Ty)),
                   -2.5, 2.5) for _ in range(3)]
    _, gp = jagent.sample_dynamics(spec, env, hyp, gp, jnp.asarray(Xts[0]),
                                   jnp.asarray(eps[0]), hall_empty=True)
    _, gp = jagent.sample_dynamics(spec, env, hyp, gp, jnp.asarray(Xts[1]),
                                   jnp.asarray(eps[1]))
    return dict(j=j, t=t, hyp=hyp, gp=gp, Xt=Xts[2], eps=eps[2])


def _carry(hyp, gp, device="cpu", dtype=torch.float64):
    to = dict(device=device, dtype=dtype)
    thyp = convert.hyper(hyp.lengthscale, hyp.outputscale, hyp.noise_diag,
                         hyp.jitter, hyp.beta, hyp.variance_is_zero,
                         hyp.min_data_dist, **to)
    tgp = convert.gp_state(gp.real_Z, gp.real_Y,
                           {k: np.asarray(v) for k, v in gp.real_fact.items()},
                           gp.hall_Z, gp.hall_Y, gp.hall_n, **to)
    return thyp, tgp


def test_condition_and_predict_update_match_jax(filled):
    """The update factor and the posterior through it, per (sample,
    output); the JAX factor is also carried across to predict_update
    alone, so each half is held in isolation."""
    jspec, tspec = filled["j"][1], filled["t"][1]
    hyp, gp, Xt = filled["hyp"], filled["gp"], filled["Xt"]
    thyp, tgp = _carry(hyp, gp)
    assert tgp.hall_n == 2 * jspec.H
    juf = jagent.batched_update_factor(jspec, hyp, gp)
    tuf = tagent.batched_update_factor(tspec, thyp, tgp)
    for k in ("C", "L_s", "alpha_r", "alpha_h", "w_h", "mask_h"):
        np.testing.assert_allclose(tuf[k].numpy(), np.asarray(juf[k]),
                                   atol=1e-10, rtol=1e-10, err_msg=k)
    jm, jc = jagent._batched_posterior_incremental(jspec, hyp, gp,
                                                   jnp.asarray(Xt))
    tm, tc = tagent._batched_posterior_incremental(tspec, thyp, tgp, _t(Xt))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-10)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-10)
    uf = convert.update_factor({k: np.asarray(v) for k, v in juf.items()},
                               "cpu", torch.float64)
    j = 1
    m, c = texact.predict_update(
        _t(Xt), tgp.real_Z, tgp.hall_Z[:, j],
        {k: v[j] for k, v in tgp.real_fact.items()},
        {k: v[:, j] for k, v in uf.items()}, thyp.lengthscale[j],
        thyp.outputscale[j], True)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, j], atol=1e-10)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc)[:, j], atol=1e-10)


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(min_data_dist=0.05, variance_is_zero=1.1e-6),
])
def test_sample_dynamics_hall_matches_jax(filled, overrides):
    """A hall iteration of the GP stage (posterior on the filled buffer,
    draw, overrides, append) in float64 on both sides."""
    jspec, tspec = filled["j"][1], filled["t"][1]
    jenv, tenv = filled["j"][3], filled["t"][3]
    hyp = dataclasses.replace(filled["hyp"], **overrides)
    gp, Xt, eps = filled["gp"], filled["Xt"], filled["eps"]
    thyp, tgp = _carry(hyp, gp)
    jdg, jgp1 = jagent.sample_dynamics(jspec, jenv, hyp, gp, jnp.asarray(Xt),
                                       jnp.asarray(eps))
    tdg, tgp1 = tagent.sample_dynamics(tspec, tenv, thyp, tgp, _t(Xt),
                                       _t(eps))
    np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), atol=1e-8)
    assert tgp1.hall_n == int(jgp1.hall_n) == 3 * jspec.H
    np.testing.assert_allclose(tgp1.hall_Z.numpy(), np.asarray(jgp1.hall_Z))
    np.testing.assert_allclose(tgp1.hall_Y.numpy(), np.asarray(jgp1.hall_Y),
                               atol=1e-8)


@pytest.mark.parametrize("max_sqp_iter", [3, 4])
def test_car_sqp_solve_matches_jax_f64(max_sqp_iter):
    """One reduced car solve (ns=4, H=6) on JAX's GP state, OCP data and
    draws, every SQP iteration run (tol_nlp=0): iteration 0 on the empty
    buffer, then max_sqp_iter-1 hall iterations, each QP warm-started from
    the last."""
    over = dict(ns=4, H=6, max_sqp_iter=max_sqp_iter, num_mpc_iter=1,
                qp_tol=1e-12, tol_nlp=0.0)
    _, jspec, jdata, jenv = _problem(jload, jmake_data, jmake_env, **over)
    _, tspec, _, tenv = _problem(tload, tmake_data, tmake_env, **over)
    f64 = jnp.float64
    jocp, jhyp = jmake_ocp(jspec, jdata, f64), JHyp.from_spec(jspec.gp, f64)
    jgp = jagent.init_gp_state(jspec, jenv, f64)
    eps = jagent.make_epistemic(jax.random.PRNGKey(3), jspec, f64)
    X0, U0 = jsqp.init_iterate(jspec, f64, jdata.start)
    st = jnp.asarray(jdata.start, f64)
    j1 = jax.jit(lambda s, X, U, e: jsqp.solve(
        jspec, jenv, jhyp, jocp, s, X, U, jgp, e))(st, X0, U0, eps[0])
    tocp = convert.ocp_data({k: np.asarray(v)
                             for k, v in jocp._asdict().items()},
                            "cpu", torch.float64)
    thyp, tgp = _carry(jhyp, jgp)
    t1 = sqp.solve(tspec, tenv, thyp, tocp, _t(st), _t(X0), _t(U0), tgp,
                   _t(eps[0]))
    assert t1.it == int(j1.it) == max_sqp_iter
    assert int(t1.status) == int(j1.status) == 0
    assert int(t1.qp_iters) == int(j1.qp_iters)
    np.testing.assert_allclose(t1.X.numpy(), np.asarray(j1.X), atol=1e-8)
    np.testing.assert_allclose(t1.U.numpy(), np.asarray(j1.U), atol=1e-8)
    assert t1.gp.hall_n == int(j1.gp.hall_n) == max_sqp_iter * jspec.H
    np.testing.assert_allclose(t1.gp.hall_Y.numpy(), np.asarray(j1.gp.hall_Y),
                               atol=1e-8)


def test_consume_step_matches_jax_over_iterations():
    """The step consumption that carries a solve from one SQP iteration to
    the next, on a scripted sequence of candidate steps: a failed QP (its
    step not consumed), a stall of STALL_WINDOW iterations that halves the
    step, and the convergence test, state carried across as sqp.solve
    carries it."""
    spec = dataclasses.replace(tload(PARAMS)[1], ns=2, H=3)
    rng = np.random.default_rng(6)
    X = rng.normal(size=(spec.H + 1, spec.ns, spec.nx))
    U = rng.normal(size=(spec.H, spec.nu))
    jstate = (jnp.asarray(np.inf), jnp.asarray(0, jnp.int32),
              jnp.asarray(0, jnp.int32), jnp.asarray(1.0))
    tstate = (_t(np.inf), torch.tensor(0), torch.tensor(0), _t(1.0))
    jX, jU, tX, tU = jnp.asarray(X), jnp.asarray(U), _t(X), _t(U)
    # step sizes: shrinking, a failed QP, then a plateau that stalls
    scales = [1e-1, 3e-2, 1e-2, 5e-2] + [2e-2] * 8 + [1e-5]
    for k, sc in enumerate(scales):
        ok = k != 3
        dX, dU = sc * rng.normal(size=X.shape), sc * rng.normal(size=U.shape)
        jout = jsqp.consume_step(spec, jX, jU, jX + dX, jU + dU,
                                 jnp.asarray(ok), *jstate)
        tout = sqp.consume_step(spec, tX, tU, tX + _t(dX), tU + _t(dU),
                                torch.tensor(ok), *tstate)
        for a, b in zip(jout, tout):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-12, atol=1e-12)
        jX, jU, jstate = jout[0], jout[1], jout[5:]
        tX, tU, tstate = tout[0], tout[1], tout[5:]
    assert float(tstate[3]) < 1.0          # the stall engaged
    assert bool(tout[4])                   # the last step converged


def _teacher_forced(steps, dtype, qp_tol):
    """Full-width car steps from the golden's state, previous plan (the
    config does not shift it) and draws, cold QP start, against the
    golden's cold-start solve of the same step.  Returns per-step
    (status, sqp iterations, max|dX|, max|dU|)."""
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
    tX, tU = g["tf_X_traj"], g["tf_U_traj"]
    out = []
    for m in steps:
        if m == 0:
            X0, U0 = sqp.init_iterate(spec, "cpu", dtype, data.start)
        else:
            X0, U0 = t(pX[m - 1]), t(pU[m - 1])
        st = sqp.solve(spec, env, hyp, ocp, t(phys[m]), X0, U0, gp0,
                       t(g["eps"][m]))
        out.append((int(st.status), st.it,
                    float(np.abs(st.X.numpy() - tX[m]).max()),
                    float(np.abs(st.U.numpy() - tU[m]).max())))
    return out


def test_teacher_forced_car_steps_f64():
    """Step 0 (cold iterate) and step 4, whose cold and warm QP starts
    differ most in the golden (4e-2 in X)."""
    g = np.load(GOLDEN)
    steps = (0, 4)
    for m, (status, it, dx, du) in zip(
            steps, _teacher_forced(steps, torch.float64, 1e-12)):
        assert status == 0 and it == int(g["tf_sqp_iters"][m]), m
        assert dx <= 1e-8 and du <= 1e-8, (m, dx, du)


@pytest.mark.slow
def test_f32_teacher_forced_car_envelope():
    """float32 at the product QP exit (relative KKT 3e-5): the JAX
    package's own path and the port's plain path, all 12 golden steps,
    inside chip_smoke.py's teacher-forced car bars and with the same
    envelope (measured: max|dX| 1.84 both, max|dU| 1.19 both, at steps 6
    and 2-3; the float32 QP exit leaves the plan's tail loose along flat
    cost directions, and four SQP iterations carry it on)."""
    port = _teacher_forced(range(12), torch.float32, -1.0)
    g = np.load(GOLDEN)
    params, spec, data = jload(PARAMS)
    spec = dataclasses.replace(spec, num_mpc_iter=12)
    env = jmake_env(spec, params)
    f32 = jnp.float32
    ocp, hyp = jmake_ocp(spec, data, f32), JHyp.from_spec(spec.gp, f32)
    gp0 = jagent.init_gp_state(spec, env, f32)
    solve = jax.jit(lambda st, X, U, e: jsqp.solve(
        spec, env, hyp, ocp, st, X, U, gp0, e))
    ref = []
    tX, tU = g["tf_X_traj"], g["tf_U_traj"]
    for m in range(12):
        if m == 0:
            X0, U0 = jsqp.init_iterate(spec, f32, data.start)
        else:
            X0 = jnp.asarray(g["plan_X_traj"][m - 1], f32)
            U0 = jnp.asarray(g["plan_U_traj"][m - 1], f32)
        st = solve(jnp.asarray(g["physical_state_traj"][m], f32), X0, U0,
                   jnp.asarray(g["eps"][m], f32))
        ref.append((int(st.status), int(st.it),
                    float(np.abs(np.asarray(st.X) - tX[m]).max()),
                    float(np.abs(np.asarray(st.U) - tU[m]).max())))
    for res in (port, ref):
        assert all(s == 0 for s, _, _, _ in res)
        assert max(dx for _, _, dx, _ in res) <= F32_TOL_X
        assert max(du for _, _, _, du in res) <= F32_TOL_U
    env_port = max(dx for _, _, dx, _ in port)
    env_jax = max(dx for _, _, dx, _ in ref)
    assert abs(env_port - env_jax) <= 0.2 * env_jax
