"""The port's per-SQP-iterate debug recording against its own solve and
against the JAX package's ``sqp.solve_recorded``.

* ``solve_recorded`` runs the same iterations as ``solve``: X, U, X_prev,
  U_prev, the iteration count, the status, the QP iterations and the
  hallucination buffer come out bit for bit equal (float64 on the CPU);
* its records match JAX's in float64 on JAX's draws: X, U and dg to 1e-8,
  the posterior value moments to 1e-10, x_diff and u_diff to 1e-8
  relative, equal QP iterations;
* ``posterior_value_moments`` matches JAX to 1e-10 on an empty buffer (the
  gp entering iteration 0) and on a filled one.

params_pendulum1D_samples at ns = 6 (one SQP iteration, the sizes of
tests/test_sqp_debug.py) and params_car at ns = 4, H = 8 (four SQP
iterations, so the hall stage and the iterate chain are recorded too).
The QP exit is tightened to 1e-12 on both sides so both stop at the same
Mehrotra iteration.  The loops are chains of small torch ops and run on
one torch thread (the suite's parallel workers oversubscribe the cores).
"""

import contextlib
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
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.config import make_data as tmake_data
from sampling_gpmpc_torch.envs import make_env as tmake_env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.spec import make_ocp_data

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(device="cpu", dtype=torch.float64)
CASES = {
    "pendulum1d": ("params_pendulum1D_samples", dict(ns=6, num_mpc_iter=2)),
    "car": ("params_car", dict(ns=4, H=8, num_mpc_iter=2)),
}


@contextlib.contextmanager
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _problem(load, make_data, make_env, config, over):
    params, spec, data = load(os.path.join(HERE, "params", config + ".yaml"))
    spec = dataclasses.replace(spec, qp_tol=1e-12, **over)
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    data = make_data(params, spec)
    return params, spec, data, make_env(spec, params)


def _port(case):
    """The port's problem, float64 on the CPU, fed JAX's draws of MPC step
    0: (spec, env, hyp, ocp, gp, X0, U0, st, eps)."""
    config, over = CASES[case]
    _, spec, data, env = _problem(tload, tmake_data, tmake_env, config, over)
    _, jspec, _, _ = _problem(jload, jmake_data, jmake_env, config, over)
    eps = np.array(jagent.make_epistemic(jax.random.PRNGKey(jspec.seed),
                                         jspec, jnp.float64)[0])
    ocp = make_ocp_data(spec, data, **F64)
    hyp = GPHyperArrays.from_spec(spec.gp, **F64)
    gp = tagent.init_gp_state(spec, env, hyp=hyp, **F64)
    X0, U0 = sqp.init_iterate(spec, start=data.start, **F64)
    st = torch.as_tensor(data.start, dtype=torch.float64)
    return spec, env, hyp, ocp, gp, X0, U0, st, torch.from_numpy(eps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recorded_equals_solve(case):
    """Same inputs: the recorded solve is the solve, bit for bit."""
    spec, env, hyp, ocp, gp, X0, U0, st, eps = _port(case)
    with one_thread():
        a = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
        b, recs = sqp.solve_recorded(spec, env, hyp, ocp, st, X0, U0, gp,
                                     eps)
    assert a.it == b.it == len(recs)
    for k in ("X", "U", "X_prev", "U_prev", "status", "done", "qp_iters",
              "qp_gap", "qp_valid", "best_step", "alpha"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for x, y in zip(a.qp_ws, b.qp_ws):
        assert torch.equal(x, y)
    assert a.gp.hall_n == b.gp.hall_n
    assert torch.equal(a.gp.hall_Z, b.gp.hall_Z)
    assert torch.equal(torch.nan_to_num(a.gp.hall_Y, 7.0),
                       torch.nan_to_num(b.gp.hall_Y, 7.0))
    # the last record is the final iterate; X_prev is the one before it
    assert torch.equal(recs[-1]["X"], b.X)
    if len(recs) > 1:
        assert torch.equal(recs[-2]["X"], b.X_prev)
    else:
        assert torch.equal(b.X_prev, X0) and torch.equal(b.U_prev, U0)
    assert sum(r["qp_iters"] for r in recs) == int(b.qp_iters)
    assert [r["qp_status"] for r in recs][-1] == int(b.status)
    if case == "car":
        assert b.it == spec.max_sqp_iter == 4


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_match_jax_f64(case):
    config, over = CASES[case]
    _, jspec, jdata, jenv = _problem(jload, jmake_data, jmake_env, config,
                                     over)
    f64 = jnp.float64
    jocp, jhyp = jmake_ocp(jspec, jdata, f64), JHyp.from_spec(jspec.gp, f64)
    jgp = jagent.init_gp_state(jspec, jenv, f64)
    jeps = jagent.make_epistemic(jax.random.PRNGKey(jspec.seed), jspec,
                                 f64)[0]
    X0, U0 = jsqp.init_iterate(jspec, f64, jdata.start)
    jst = jnp.asarray(jdata.start, f64)
    # the iteration and the probe compiled once each (the JAX DEMPC's way)
    it_j = {he: jax.jit(lambda s, X, U, g, e, ws, wv, _he=he:
                        jsqp.sqp_iteration(jspec, jenv, jhyp, jocp, s, X, U,
                                           g, e, qp_ws=ws, qp_valid=wv,
                                           return_debug=True, hall_empty=_he))
            for he in (False, True)}
    probe_j = jax.jit(lambda g, Xt: jagent.posterior_value_moments(
        jspec, jhyp, g, Xt))
    jst_out, jrecs = jsqp.solve_recorded(
        jspec, jenv, jhyp, jocp, jst, X0, U0, jgp, jeps,
        iter_fn=lambda s, X, U, g, e, ws, wv, he: it_j[he](s, X, U, g, e, ws,
                                                            wv),
        probe_fn=probe_j)

    spec, env, hyp, ocp, gp, tX0, tU0, st, eps = _port(case)
    with one_thread():
        tst_out, trecs = sqp.solve_recorded(spec, env, hyp, ocp, st, tX0,
                                            tU0, gp, eps)
    assert len(trecs) == len(jrecs) == int(jst_out.it) == tst_out.it
    for it, (t, j) in enumerate(zip(trecs, jrecs)):
        for k, tol in (("X", 1e-8), ("U", 1e-8), ("dg", 1e-8),
                       ("mean", 1e-10), ("std", 1e-10)):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       rtol=0, atol=tol,
                                       err_msg=f"{k}, iteration {it}")
        for k in ("x_diff", "u_diff"):
            assert t[k] == pytest.approx(j[k], rel=1e-8, abs=1e-12), (k, it)
        assert t["qp_iters"] == j["qp_iters"]
        assert t["qp_status"] == j["qp_status"] == 0
        assert set(t["qp"]) == set(j["qp"])
        for k in t["qp"]:
            np.testing.assert_allclose(t["qp"][k].numpy(),
                                       np.asarray(j["qp"][k]), rtol=1e-8,
                                       atol=1e-8, err_msg=f"qp {k}, {it}")
    np.testing.assert_allclose(tst_out.X_prev.numpy(),
                               np.asarray(jst_out.X_prev), atol=1e-8)
    np.testing.assert_allclose(tst_out.U_prev.numpy(),
                               np.asarray(jst_out.U_prev), atol=1e-8)


def test_posterior_value_moments_match_jax():
    """params_car at ns = 4, H = 8 on one shared gp state carried from JAX:
    the empty buffer (the gp entering iteration 0 after reset_hall) and the
    buffer after one append."""
    from sampling_gpmpc_torch import convert
    config, over = CASES["car"]
    _, jspec, jdata, jenv = _problem(jload, jmake_data, jmake_env, config,
                                     over)
    _, spec, _, _ = _problem(tload, tmake_data, tmake_env, config, over)
    f64 = jnp.float64
    jhyp = JHyp.from_spec(jspec.gp, f64)
    jgp = jagent.reset_hall(jagent.init_gp_state(jspec, jenv, f64))
    rng = np.random.default_rng(0)
    lo = np.array([jdata.x_min[2], jdata.x_min[3], jdata.u_min[0]])
    hi = np.array([jdata.x_max[2], jdata.x_max[3], jdata.u_max[0]])
    Xt = rng.uniform(lo, hi, size=(spec.ns, spec.H, 3))
    dg = rng.normal(size=(spec.ns, spec.g_ny, spec.H, spec.Ty)) * 0.01
    jgp1 = jagent.append_hall(jspec, jhyp, jgp, jnp.asarray(Xt),
                              jnp.asarray(dg), None)
    hyp = convert.hyper(jhyp.lengthscale, jhyp.outputscale, jhyp.noise_diag,
                        jhyp.jitter, jhyp.beta, jhyp.variance_is_zero,
                        jhyp.min_data_dist, **F64)
    Xq = rng.uniform(lo, hi, size=(spec.ns, spec.H, 3))
    probe_j = jax.jit(lambda g, X: jagent.posterior_value_moments(
        jspec, jhyp, g, X))
    for g in (jgp, jgp1):
        tgp = convert.gp_state(g.real_Z, g.real_Y,
                               {k: np.asarray(v)
                                for k, v in g.real_fact.items()},
                               g.hall_Z, g.hall_Y, int(g.hall_n), **F64)
        jm, js = probe_j(g, jnp.asarray(Xq))
        tm, ts = tagent.posterior_value_moments(spec, hyp, tgp,
                                                torch.from_numpy(Xq))
        assert tm.shape == ts.shape == (spec.ns, spec.g_ny, spec.H)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=1e-10)
        assert np.all(ts.numpy() >= 0)
    # conditioning on the appended rows shrinks the spread there
    tgp1 = convert.gp_state(jgp1.real_Z, jgp1.real_Y,
                            {k: np.asarray(v)
                             for k, v in jgp1.real_fact.items()},
                            jgp1.hall_Z, jgp1.hall_Y, int(jgp1.hall_n), **F64)
    tgp0 = tagent.reset_hall(tgp1)
    _, s1 = tagent.posterior_value_moments(spec, hyp, tgp1,
                                           torch.from_numpy(Xt))
    _, s0 = tagent.posterior_value_moments(spec, hyp, tgp0,
                                           torch.from_numpy(Xt))
    assert torch.all(s1 <= s0 + 1e-12) and float(s1.sum()) < float(s0.sum())
