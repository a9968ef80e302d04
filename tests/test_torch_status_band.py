"""The port's status band (``sampling_gpmpc_torch.status_band``) against a
JAX loop over ``sqp.solve_recorded`` built here the way
``profiling/status_band.py`` builds it, float64 on the CPU, on the draws of
tests/goldens/oracle_pendulum1d_flagship.npz (params_pendulum1D_samples,
3 MPC steps): the QP statuses and the band histogram are equal, each
step's plan X and U agree to 1e-7; the band's edges read ``ocp/qp.py``'s
tolerance and the CLI prints the JAX script's lines.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sampling_gpmpc_tpu import agent as jagent
from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.dempc import shift_solution as jshift
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
from sampling_gpmpc_tpu.ocp import sqp as jsqp
from sampling_gpmpc_tpu.ocp.spec import make_ocp_data as jmake_ocp
from sampling_gpmpc_torch import status_band as sb
from sampling_gpmpc_torch.ocp import qp as qp_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens",
                      "oracle_pendulum1d_flagship.npz")
CONFIG = "params_pendulum1D_samples"
STEPS = 3


def _jax_loop(eps):
    params, spec, data = jload(os.path.join(ROOT, "params", CONFIG + ".yaml"))
    spec = dataclasses.replace(spec, num_mpc_iter=STEPS)
    env = jmake_env(spec, params)
    dt = jnp.float64
    ocp = jmake_ocp(spec, data, dt)
    hyp = JHyp.from_spec(spec.gp, dt)
    gp = jagent.init_gp_state(spec, env, dt)
    X, U = jsqp.init_iterate(spec, dt, data.start)
    x = jnp.asarray(data.start, dt)
    ws, wv = jsqp.init_qp_ws(spec, dt), jnp.asarray(False)
    goal = jnp.asarray(data.goal, dt)
    K_fb = jnp.asarray(data.K_fb, dt) if spec.use_feedback else None
    probe = lambda gp_, Xt: (None, None)   # noqa: E731
    # the iteration compiled once per hall_empty (the JAX DEMPC's way)
    it_j = {he: jax.jit(lambda s, X_, U_, g, e, w, v, _he=he:
                        jsqp.sqp_iteration(spec, env, hyp, ocp, s, X_, U_, g,
                                           e, qp_ws=w, qp_valid=v,
                                           return_debug=True, hall_empty=_he))
            for he in (False, True)}
    iter_fn = lambda s, X_, U_, g, e, w, v, he: it_j[he](  # noqa: E731
        s, X_, U_, g, e, w, v)
    gaps, statuses, Xs, Us = [], [], [], []
    for m in range(STEPS):
        st, recs = jsqp.solve_recorded(spec, env, hyp, ocp, x, X, U, gp,
                                       jnp.asarray(eps[m]), ws, wv,
                                       iter_fn=iter_fn, probe_fn=probe)
        gaps += [r["qp_gap"] for r in recs]
        statuses += [r["qp_status"] for r in recs]
        X, U, gp = st.X, st.U, st.gp
        ws, wv = st.qp_ws, st.qp_valid
        Xs.append(np.asarray(X))
        Us.append(np.asarray(U))
        u0 = U[0]
        if K_fb is not None:
            u0 = u0 - (goal - X[0, 0]) @ K_fb.T
        x = env.discrete_dyn(X[0, 0], u0).reshape(-1)
        if spec.shift_soln:
            X, U = jshift(spec, X, U)
    return (np.asarray(gaps, float), np.asarray(statuses, int), np.stack(Xs),
            np.stack(Us))


def test_status_band_matches_jax_loop_on_golden_draws():
    eps = np.load(GOLDEN)["eps"]
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = sb.run_config(CONFIG, STEPS, torch.device("cpu"),
                            torch.float64, eps)
    finally:
        torch.set_num_threads(old)
    gaps, statuses, X, U = _jax_loop(eps)
    assert got["tol"] == qp_mod.TOL[torch.float64] == 1e-8
    np.testing.assert_array_equal(got["statuses"], statuses)
    assert len(statuses) == STEPS and (statuses == 0).all()
    h, jh = (sb.band_histogram(g, s, got["tol"])
             for g, s in ((got["gaps"], got["statuses"]), (gaps, statuses)))
    np.testing.assert_array_equal(h["hist"], jh["hist"])
    assert h["consumed"] == jh["consumed"] == STEPS
    np.testing.assert_allclose(got["X"], X, atol=1e-7, rtol=0)
    np.testing.assert_allclose(got["U"], U, atol=1e-7, rtol=0)
    # every QP took the one-device route; no kernel runs on the CPU
    assert got["routes"] == {"run_full": STEPS, "group": 0}
    assert not any(got["launches"].values())


def test_band_histogram_edges():
    tol = qp_mod.TOL[torch.float32]
    gaps = tol * np.array([0.5, 1.0, 2.0, 3.5, 50.0, 999.0, 2000.0, 7.0])
    statuses = np.array([0, 0, 0, 0, 0, 0, 0, 4])
    h = sb.band_histogram(gaps, statuses, tol)
    assert list(h["hist"]) == [2, 1, 1, 1, 1, 1]
    assert h["consumed"] == 7 and h["rejected"] == 1
    assert h["max_ratio"] == 2000.0
    assert sb.LABELS == ["<=1x", "(1,3]x", "(3,10]x", "(10,100]x",
                         "(100,1000]x", ">1000x"]


def test_cli_prints_the_tables(capsys):
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sb.main(["--device", "cpu", "--eps-from", GOLDEN, "--steps", "2",
                 CONFIG])
    finally:
        torch.set_num_threads(old)
    out = capsys.readouterr().out
    assert f"{CONFIG}: 2 consumed QPs (0 rejected)" in out
    assert "<=1x:2" in out and "QP routes run_full=2 group=0" in out
    assert out.strip().splitlines()[-1] == "TOTAL: 2 0 0 0 0 0"
