"""The port's approximate sampling MPC (``sampling_gpmpc_torch/approx``,
the drone of params_drone_obstacles_approx) against the JAX package's
(``sampling_gpmpc_tpu/approx``) on the CPU in float64.

The port cannot reproduce ``jax.random``, so it takes the JAX package's
standard-normal draws as tensors (``sample_weights(post, z)``,
``ApproxMPC.run(draws=...)``).  Module by module (the drone model, the BLR
fit and its rank-1 update, the weight draws, the dynamics' value and
Jacobian rows, the tightening, the assembled QPs) the two agree at 1e-8.

The solves do not, and cannot: the pessimistic planner's QP is so badly
conditioned (its Hessian reaches 1.4e7 at nU = 60) that its float64 best
KKT residual stops near 1.1e-8, and a 1e-14 relative perturbation of its
data moves the JAX package's own solution by 1.3e-7.  So a pessimistic
solve is held to the same iteration count and status and 1e-5 in u, and
the pessimistic golden steps of tests/goldens/torch_oracle_drone.npz
(written by tests/make_torch_drone_golden.py) to 1e-4: the port reads
8.7e-6 / 1.4e-5 (X / U) at step 0, where the JAX package's own plan moves
by 4.1e-6 / 7.4e-6 under a 1e-14 relative perturbation of the measured
state, and <= 2.6e-7 at the other nine.  The optimistic planner's QPs are
well determined: its golden steps hold at 1e-8 (the port reads <= 4.1e-9).
Free-running loops are not compared: a 1e-12 perturbation of the start
moves the JAX package's own pessimistic plan by 1.0 at step 0.

The loops run on one torch thread (see tests/test_torch_goldens.py).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sampling_gpmpc_tpu.approx import blr as jblr
from sampling_gpmpc_tpu.approx import solver as jsolver
from sampling_gpmpc_tpu.approx.drone import DroneModel as JDroneModel
from sampling_gpmpc_tpu.ocp import qp as jqp
from sampling_gpmpc_torch import convert
from sampling_gpmpc_torch.approx import blr
from sampling_gpmpc_torch.approx import solver as tsolver
from sampling_gpmpc_torch.approx.drone import DroneModel
from sampling_gpmpc_torch.ocp import qp as tqp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "torch_oracle_drone.npz")
F64 = torch.float64
ATOL = 1e-8
PESS_Z_TOL = 1e-5        # one pessimistic solve, in u (see the docstring)
PESS_STEP_TOL = 1e-4     # a pessimistic golden step, in X and U


@pytest.fixture(scope="module")
def params():
    with open(os.path.join(ROOT, "params",
                           "params_drone_obstacles_approx.yaml")) as fh:
        return yaml.safe_load(fh)


def _optimistic(params):
    p = copy.deepcopy(params)
    p["agent"]["run"]["optimistic"] = True
    p["agent"]["run"]["pessimistic"] = False
    return p


@pytest.fixture
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def test_drone_model_matches_jax(params):
    """True dynamics and feature maps on random points, the training grid,
    the ground-truth weights, the path and the obstacles."""
    jm, tm = JDroneModel(params), DroneModel(params)
    rng = np.random.default_rng(0)
    xu = rng.uniform(-2, 2, size=(50, 8))
    jdyn = jax.vmap(lambda z: jm.discrete_dyn(z[:6], z[6:]))(jnp.asarray(xu))
    np.testing.assert_allclose(
        tm.discrete_dyn(_t(xu[:, :6]), _t(xu[:, 6:])).numpy(),
        np.asarray(jdyn), rtol=0, atol=1e-12)
    for jf, tf in zip(jm.features(), tm.features()):
        jv = jax.vmap(lambda z: jf(z[:6], z[6:]))(jnp.asarray(xu))
        np.testing.assert_allclose(tf(_t(xu[:, :6]), _t(xu[:, 6:])).numpy(),
                                   np.asarray(jv), rtol=0, atol=1e-12)
    (jX, jY), (tX, tY) = jm.training_grid(), tm.training_grid()
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_allclose(tY, jY, rtol=0, atol=1e-12)
    for a, b in zip(tm.gt_weights(), jm.gt_weights()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.path_generator(3, 40),
                                  jm.path_generator(3, 40))
    np.testing.assert_array_equal(tm.obstacles(), jm.obstacles())


def test_blr_fit_and_update_match_jax(params):
    """Sufficient statistics, three rank-1 updates and the padded posterior
    (mean, Cholesky factor, mask), carried through convert.blr_stats."""
    jm, tm = JDroneModel(params), DroneModel(params)
    X, Y = jm.training_grid()
    js = jblr.stats_fit(jm.features(), X, Y, 1e-7)
    ts = blr.stats_fit(tm.features(), X, Y, 1e-7)
    rng = np.random.default_rng(1)
    for _ in range(3):
        x, u = rng.uniform(-1, 1, 6), rng.uniform(-1, 1, 2)
        y = np.asarray(jm.discrete_dyn(jnp.asarray(x), jnp.asarray(u)))
        js = jblr.stats_update(js, jm.features(), x, u, y)
        ts = blr.stats_update(ts, tm.features(), x, u, y)
    for a, b in zip(ts.A + ts.b, js.A + js.b):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    jp = jblr.posterior_from_stats(js, 2e-7)
    for stats in (ts, convert.blr_stats(js.A, js.b)):
        tp = blr.posterior_from_stats(stats, 2e-7, "cpu")
        for f in ("mu", "chol", "mask"):
            np.testing.assert_allclose(getattr(tp, f).numpy(),
                                       np.asarray(getattr(jp, f)), rtol=0,
                                       atol=ATOL, err_msg=f)


def test_active_learning_rank1_matches_batch_refit(params):
    """stats_update + posterior == batch fit on the augmented dataset: the
    conjugacy identity the online path relies on (as
    tests/test_approx.py holds it for the JAX package)."""
    model = DroneModel(params)
    feats = model.features()
    X, Y = model.training_grid()
    lam, nv = 1e-6, 2e-7
    stats = blr.stats_fit(feats, X, Y, lam)
    rng = np.random.default_rng(3)
    xu_new = rng.uniform(-1, 1, size=(3, 8))
    y_new = model.discrete_dyn(_t(xu_new[:, :6]), _t(xu_new[:, 6:])).numpy()
    for k in range(3):
        stats = blr.stats_update(stats, feats, xu_new[k, :6], xu_new[k, 6:],
                                 y_new[k])
    post_inc = blr.posterior_from_stats(stats, nv, "cpu")
    post_batch = blr.fit(feats, np.vstack([X, xu_new]),
                         np.vstack([Y, y_new]), lam, nv, "cpu")
    np.testing.assert_allclose(post_inc.mu.numpy(), post_batch.mu.numpy(),
                               atol=1e-9)
    np.testing.assert_allclose(post_inc.chol.numpy(),
                               post_batch.chol.numpy(), atol=1e-9)


def test_weight_draws_dynamics_and_rollout_match_jax(params):
    """sample_weights on the JAX package's own draws, the dynamics' value
    and Jacobian rows (make_dynamics) at random points and weights, and a
    batched rollout, against the JAX functions."""
    jm, tm = JDroneModel(params), DroneModel(params)
    X, Y = jm.training_grid()
    jp = jblr.fit(jm.features(), X, Y, 1e-7, 2e-7)
    tp = convert.blr_posterior(*(np.asarray(a) for a in jp), device="cpu",
                               dtype=F64)
    key = jax.random.PRNGKey(7)
    z = np.asarray(jax.random.normal(key, (5, 6, jp.mu.shape[1]),
                                     jnp.float64))
    jW = jblr.sample_weights(jp, key, 5)
    tW = blr.sample_weights(tp, _t(z))
    np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=0, atol=1e-12)
    jstep, jvj = jblr.make_dynamics(jm.features(), 6)
    tstep, tvj = blr.make_dynamics(tm.features(), 6)
    rng = np.random.default_rng(2)
    for k in range(5):
        x, u = rng.uniform(-1, 1, 6), rng.uniform(-1, 5, 2)
        got = tvj(_t(x), _t(u), tW[k]).numpy()
        ref = np.asarray(jvj(jnp.asarray(x), jnp.asarray(u), jW[k]))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    x0, U = rng.uniform(-1, 1, 6), rng.uniform(-1, 5, (30, 2))
    ref = jax.vmap(lambda W: jblr.rollout(jstep, jnp.asarray(x0),
                                          jnp.asarray(U), W))(jW)
    got = blr.rollout(tstep, _t(x0), _t(U), tW)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)


@pytest.fixture(scope="module")
def mpcs(params):
    return (jsolver.ApproxMPC(params),
            tsolver.ApproxMPC(params, device="cpu", dtype=F64))


def test_tightening_matches_jax(mpcs, params):
    """Delta_k over the 100 weight draws the JAX package makes from a key,
    the port given the same draws."""
    J, T = mpcs
    x0 = np.asarray(params["env"]["start"]) + 0.1
    U = np.full((J.H, J.nu), 2.0) + np.linspace(0, 1, J.H)[:, None]
    key = jax.random.PRNGKey(11)
    z = np.asarray(jax.random.normal(key, (J.n_tight, 6, J.post.mu.shape[1]),
                                     jnp.float64))
    ref = np.asarray(J._tighten(jnp.asarray(x0), jnp.asarray(U), key,
                                J.post, J.W_nominal))
    got = T._tightening(_t(x0), _t(U), _t(z), T.post, T.W_nominal).numpy()
    assert ref[1:].max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_observe_matches_jax(params):
    """Active learning's observation: the same transition absorbed by both
    packages gives the same posterior and nominal weights."""
    p = copy.deepcopy(params)
    p["common"]["active_learning"] = {"use": True, "frequency": 1}
    J = jsolver.ApproxMPC(p)
    T = tsolver.ApproxMPC(p, device="cpu", dtype=F64)
    x, u = np.asarray(p["env"]["start"]) + 0.2, np.asarray([1.5, 2.5])
    J.observe(x, u)
    T.observe(x, u)
    for f in ("mu", "chol"):
        np.testing.assert_allclose(getattr(T.post, f).numpy(),
                                   np.asarray(getattr(J.post, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_allclose(T.W_nominal.numpy(), np.asarray(J.W_nominal),
                               rtol=0, atol=ATOL)


def _captured(monkeypatch, module, out):
    """Record the arguments of every solve_qp_soft call of ``module`` as
    numpy (the JAX package's under jit too, by a debug callback)."""
    solve = module.solve_qp_soft

    def recording(*a, **k):
        if module is jsolver:
            jax.debug.callback(lambda *v: out.append([np.asarray(x)
                                                      for x in v]), *a)
        else:
            out.append([x.numpy() for x in a])
        return solve(*a, **k)

    monkeypatch.setattr(module, "solve_qp_soft", recording)


def _check_qp_and_solve(jqps, tqps, z_tol):
    """The assembled QPs agree (1e-9 of each array's scale); the JAX QP
    through both solvers takes the same iterations to the same status, u
    within z_tol.  Returns the largest u difference."""
    assert len(jqps) == len(tqps) >= 1
    worst = 0.0
    for ja, ta in zip(jqps, tqps):
        for k, (a, b) in enumerate(zip(ta, ja)):
            assert a.shape == b.shape, k
            scale = max(np.abs(b).max(initial=0.0), 1.0)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * scale,
                                       err_msg=f"QP argument {k}")
        sj = jqp.solve_qp_soft(*(jnp.asarray(a) for a in ja))
        st = tqp.solve_qp_soft(*(_t(a) for a in ja))
        assert int(st.iters) == int(sj.iters)
        assert int(st.status) == int(sj.status) == 0
        dz = float(np.abs(st.z.numpy() - np.asarray(sj.z)).max())
        assert dz <= z_tol, dz
        worst = max(worst, dz)
    return worst


def test_pessimistic_sqp_solve_matches_jax(mpcs, params, monkeypatch,
                                           one_thread):
    """One pessimistic SQP solve (two iterations: QP nU = 60, m_h = 482,
    m_s = 124) from the same start, tightening and weights."""
    J, T = mpcs
    x0 = np.asarray(params["env"]["start"])
    X = np.broadcast_to(x0, (J.H + 1, 6)).copy()
    U = np.full((J.H, 2), 0.5)
    wpath = J.model.path_generator(0)
    delta = np.zeros((J.H + 1, 6))
    delta[1:] = 0.01
    jqps, tqps = [], []
    _captured(monkeypatch, jsolver, jqps)
    _captured(monkeypatch, tsolver, tqps)
    J._sqp_iteration(*(jnp.asarray(a) for a in (x0, X, U, wpath, delta)),
                     J.W_nominal)
    T._sqp_iteration(*(_t(a) for a in (x0, X, U, wpath, delta)), T.W_nominal)
    assert [a[1].shape[0] for a in tqps] == [60]
    assert (tqps[0][3].shape[0], tqps[0][5].shape[0]) == (482, 124)
    _check_qp_and_solve(jqps, tqps, PESS_Z_TOL)


def test_optimistic_sqp_solve_matches_jax(params, monkeypatch, one_thread):
    """One optimistic SQP iteration (QP nU = 240, m_h = 840, no soft rows)
    from the start: its QP, its solve and its plan at 1e-8."""
    p = _optimistic(params)
    J = jsolver.ApproxMPC(p)
    T = tsolver.ApproxMPC(p, device="cpu", dtype=F64)
    jqps, tqps = [], []
    _captured(monkeypatch, jsolver, jqps)
    _captured(monkeypatch, tsolver, tqps)
    x0 = np.asarray(p["env"]["start"])
    jX, jU, js = J.solve_optimistic(x0, max_sqp_iter=1)
    tX, tU, ts = T.solve_optimistic(x0, max_sqp_iter=1)
    assert (tqps[0][1].shape[0], tqps[0][3].shape[0],
            tqps[0][5].shape[0]) == (240, 840, 0)
    _check_qp_and_solve(jqps, tqps, ATOL)
    assert ts == js == 0
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


def test_golden_pessimistic_steps(golden, params, one_thread):
    """Every pessimistic step of the golden, teacher-forced: the port's
    tightening from the step's draws (1e-8) and its two-iteration SQP solve
    from the step's state and start (PESS_STEP_TOL, see the docstring),
    status 0 as in the golden."""
    T = tsolver.ApproxMPC(params, device="cpu", dtype=F64)
    g = golden
    ex, eu = [], []
    for m in range(int(g["n_pess"])):
        x, X0, U0 = (_t(g[f"pess_{k}"][m]) for k in ("x", "X0", "U0"))
        d = T._tightening(x, U0, _t(g["pess_z"][m]), T.post, T.W_nominal)
        np.testing.assert_allclose(d.numpy(), g["pess_delta"][m], rtol=0,
                                   atol=ATOL)
        X, U, s = T._sqp_solve(x, X0, U0, _t(T.model.path_generator(m)), d,
                               T.W_nominal)
        assert int(s) == int(g["pess_status"][m]) == 0
        ex.append(float(np.abs(X.numpy() - g["pess_X"][m]).max()))
        eu.append(float(np.abs(U.numpy() - g["pess_U"][m]).max()))
    assert max(ex) <= PESS_STEP_TOL and max(eu) <= PESS_STEP_TOL, (ex, eu)


def test_golden_optimistic_steps(golden, params, one_thread):
    """Every optimistic step of the golden, teacher-forced from its state
    and its shifted previous plan, at 1e-8."""
    T = tsolver.ApproxMPC(_optimistic(params), device="cpu", dtype=F64)
    g = golden
    for m in range(int(g["n_opt"])):
        X0 = U0 = None
        if m:
            X0, U0 = (np.concatenate([g[k][m - 1][1:], g[k][m - 1][-1:]])
                      for k in ("opt_X", "opt_U"))
        X, U, s = T.solve_optimistic(_t(g["opt_x"][m]),
                                     wpath=_t(T.model.path_generator(m)),
                                     X0=X0, U0=U0)
        assert s == int(g["opt_status"][m]) == 0
        np.testing.assert_allclose(X.numpy(), g["opt_X"][m], rtol=0,
                                   atol=ATOL, err_msg=f"step {m}")
        np.testing.assert_allclose(U.numpy(), g["opt_U"][m], rtol=0,
                                   atol=ATOL, err_msg=f"step {m}")


def test_run_replays_the_golden_draws(golden, params, one_thread):
    """ApproxMPC.run on the golden's draws: the JAX package's keys, step 0
    equal to the golden's (the same state, start and draws), finite."""
    T = tsolver.ApproxMPC(params, device="cpu", dtype=F64)
    out = T.run(num_iters=3, draws=golden["pess_z"])
    assert set(out) == {"physical_state_traj", "state_traj", "solver_time",
                        "tightenings", "final_state", "status"}
    assert out["status"] == 0 and len(out["solver_time"]) == 3
    np.testing.assert_allclose(out["tightenings"][0], golden["pess_delta"][0],
                               rtol=0, atol=ATOL)
    assert np.abs(out["state_traj"][0] - golden["pess_X"][0]).max() \
        <= PESS_STEP_TOL
    assert np.all(np.isfinite(np.stack(out["physical_state_traj"])))


def test_cli_runs_on_cpu_and_refuses_without_cuda(monkeypatch, one_thread):
    """python -m sampling_gpmpc_torch.drone_obstacle_avoidance: two
    optimistic steps on the CPU write the JAX example's pickle keys; with
    no device named and no CUDA it raises."""
    from sampling_gpmpc_torch import drone_obstacle_avoidance as cli
    out = cli.main(["--device", "cpu", "--iters", "2", "--optimistic",
                    "-i", "9001"])
    assert out["status"] == 0
    assert np.allclose(np.stack(out["tightenings"]), 0.0)
    path = os.path.join(ROOT, "experiments", "drone", "env_0",
                        "params_drone_obstacles_approx", "9001",
                        "data_obstacles.pkl")
    assert os.path.exists(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--iters", "1"])
