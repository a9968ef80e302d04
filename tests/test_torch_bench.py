"""The port's bench (``sampling_gpmpc_torch.bench``) against the JAX
package, on the CPU in float64 on one torch thread.

* ``mpc_step`` over 5 closed-loop steps at ns = 8, H = 20 on JAX's draws
  equals the JAX bench's chain (``sqp.solve`` with the QP warm start
  carried, the ancillary feedback, ``discrete_dyn``, ``shift_solution``;
  bench.py ``_mpc_step``) at 1e-8;
* the first 2 steps of tests/goldens/torch_oracle_bench_ns512.npz (that
  chain at ns = 512 in JAX float64) through the port's plain route at 1e-7;
* ``fs_refit_baseline.run`` equals ``benchmarking/torch_fs_baseline.run``
  at ns = 16 x 5 steps on the same seed and training data at 1e-12;
* the percentile and summary helpers, the failure semantics, the JSON
  record's keys at a tiny CPU run, and that the CLI raises without CUDA.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu import agent as jagent
from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.config import make_data as jmake_data
from sampling_gpmpc_tpu.dempc import shift_solution as jshift
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
from sampling_gpmpc_tpu.ocp import sqp as jsqp
from sampling_gpmpc_tpu.ocp.spec import make_ocp_data as jmake_ocp
from sampling_gpmpc_torch import bench, fs_refit_baseline
from sampling_gpmpc_torch.config import load_problem as tload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens",
                      "torch_oracle_bench_ns512.npz")
F64 = torch.float64


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_chain(over):
    """The JAX bench's closed-loop chain (bench.py ``_mpc_step``) in
    float64, compiled once, with its start carry and JAX's own draws."""
    params, spec, data = jload(os.path.join(ROOT, "params",
                                            bench.LOOP_CONFIG + ".yaml"))
    spec = dataclasses.replace(spec, **over)
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    data = jmake_data(params, spec)
    env = jmake_env(spec, params)
    f64 = jnp.float64
    ocp, hyp = jmake_ocp(spec, data, f64), JHyp.from_spec(spec.gp, f64)
    K_fb = jnp.asarray(data.K_fb, f64)
    goal = jnp.asarray(data.goal, f64)

    def step(x, X, U, gp, ws, wv, eps):
        st = jsqp.solve(spec, env, hyp, ocp, x, X, U, gp, eps, qp_ws=ws,
                        qp_valid=wv)
        u0 = st.U[0] - (goal - st.X[0, 0]) @ K_fb.T
        x_next = env.discrete_dyn(st.X[0, 0], u0).reshape(-1)
        Xs, Us = jshift(spec, st.X, st.U)
        return x_next, Xs, Us, st.gp, st.qp_ws, st.qp_valid, st.status

    X, U = jsqp.init_iterate(spec, f64, data.start)
    carry = (jnp.asarray(data.start, f64), X, U,
             jagent.init_gp_state(spec, env, f64),
             jsqp.init_qp_ws(spec, f64), jnp.asarray(False))
    eps = jagent.make_epistemic(jax.random.PRNGKey(spec.seed), spec, f64)
    return spec, jax.jit(step), carry, np.array(eps)


def test_mpc_step_matches_jax_chain():
    over = dict(ns=8, H=20, max_sqp_iter=1, num_mpc_iter=5)
    jspec, jstep, carry, eps = _jax_chain(over)
    assert jspec.use_feedback and jspec.shift_soln
    _, spec, data, env = bench.build(over)
    loop = bench.ClosedLoop(spec, data, env, "cpu", F64)
    for m in range(over["num_mpc_iter"]):
        *carry, status = jstep(*carry, eps[m])
        st = loop.step(torch.from_numpy(eps[m]))
        assert int(st.status) == int(status) == 0, m
        for got, want in ((loop.x, carry[0]), (loop.X, carry[1]),
                          (loop.U, carry[2])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-8, err_msg=f"step {m}")
        assert bool(loop.qp_valid) == bool(carry[5])


def test_golden_ns512_first_steps_plain_route():
    """The ns = 512 golden's first two steps (a cold and a warm QP of
    m_h = 61,480 rows) through the port's plain route on the CPU."""
    g = np.load(GOLDEN)
    assert (int(g["ns"]), int(g["H"])) == (512, 20)
    _, spec, data, env = bench.build(dict(ns=512, H=20))
    loop = bench.ClosedLoop(spec, data, env, "cpu", F64)
    np.testing.assert_array_equal(loop.x.numpy(), g["x"][0])
    for m in range(2):
        st = loop.step(torch.from_numpy(g["eps"][m].astype(np.float64)))
        assert int(st.status) == int(g["status"][m]) == 0
        assert int(st.qp_iters) == int(g["qp_iters"][m])
        for got, want in ((st.X, g["X"][m]), (st.U, g["U"][m]),
                          (loop.x, g["x"][m + 1])):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-7,
                                       err_msg=f"step {m}")
    # the JAX float32 envelope chip_smoke.py's bar is set from
    assert np.all(g["f32_status"] == 0)
    assert 0.0 < g["f32_dX"].max() < 0.1 and 0.0 < g["f32_dU"].max() < 2.0


def test_fs_refit_baseline_matches_reference(monkeypatch):
    """The port's copy of the reference-shaped baseline against the
    original on the same seed and inputs.  The two packages' training
    targets differ in the last bit (the port's env against JAX's), which
    the per-step refit amplifies past the 1e-12 bar; both runs are given
    JAX's grid, held equal to the port's at 1e-15 here."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarking"))
    import torch_fs_baseline
    path = os.path.join(ROOT, "params", "params_car_residual_fs.yaml")
    ns, steps = 16, 5
    U = 0.1 * np.random.default_rng(1).normal(size=(steps, 2))
    jparams, jspec, jdata = jload(path)
    jspec = dataclasses.replace(jspec, ns=ns)
    ref = torch_fs_baseline.run(jparams, jspec, jdata, ns, steps, U, seed=3)
    Zj, Yj = jmake_env(jspec, jparams).training_grid()

    make_env = fs_refit_baseline.make_env

    def env_on_jax_grid(spec, params):
        env = make_env(spec, params)
        Zt, Yt = env.training_grid()
        np.testing.assert_allclose(np.asarray(Zt), np.asarray(Zj), atol=0)
        np.testing.assert_allclose(np.asarray(Yt)[..., 0],
                                   np.asarray(Yj)[..., 0], atol=1e-15)
        return dataclasses.replace(env, training_grid=lambda: (Zj, Yj))

    monkeypatch.setattr(fs_refit_baseline, "make_env", env_on_jax_grid)
    params, spec, data = tload(path)
    spec = dataclasses.replace(spec, ns=ns)
    out = fs_refit_baseline.run(params, spec, data, ns, steps, U, seed=3)
    assert out["X_traj"].shape == (steps + 1, ns, 4)
    np.testing.assert_allclose(out["X_traj"], ref["X_traj"], rtol=0,
                               atol=1e-12)
    assert out["nan_frac"] == ref["nan_frac"] == 0.0


def test_percentile_and_summary():
    steps = [float(v) for v in range(100, 0, -1)]       # 100 down to 1
    assert bench.percentile(steps, 90) == 90.0          # 10 values beyond
    assert bench.percentile(steps, 50) == 50.0
    assert bench.percentile(steps, 100) == 100.0
    assert bench.percentile([7.0], 90) == 7.0
    assert bench.percentile([1.0, 2.0, 3.0], 90) == 3.0
    s = bench.summary([2.0, 4.0, 4.0, 10.0])
    assert s == {"value": 200.0, "mean_ms": 5.0, "median_ms": 4.0,
                 "p90_ms": 10.0, "steps": 4}


@pytest.mark.parametrize("fault", ["status", "nan"])
def test_loop_failure_raises(monkeypatch, fault):
    """A QP status other than 0 or a non-finite state stops the row."""
    _, spec, data, env = bench.build(dict(ns=4))
    solve = bench.sqp.solve

    def faulty(*a, **k):
        st = solve(*a, **k)
        if fault == "status":
            return st._replace(status=torch.tensor(4, dtype=torch.int32))
        return st._replace(U=st.U * float("nan"))

    monkeypatch.setattr(bench.sqp, "solve", faulty)
    msg = "QP status 4" if fault == "status" else "non-finite state"
    with pytest.raises(RuntimeError, match=msg):
        bench.loop_row(spec, data, env, "cpu", 1, 1, 0, "ns4")


def test_record_keys_tiny_cpu_run():
    sizes = bench.Sizes(ns=4, ns_large=8, loop=(1, 3), loop_large=(1, 3),
                        car=(1, 2), fs=(64, 5), fs_runs=(0, 1))
    record, rows = bench.run("cpu", seed=7, sizes=sizes)
    line = json.loads(json.dumps(record))
    for k in ("value", "vs_baseline", "ns512_value", "ns512_vs_baseline",
              "car_value", "car_vs_baseline", "fs_value", "fs_vs_baseline",
              "fs_nan_frac", "kernel_gp_vs_plain_maxdiff",
              "kernel_ipm_vs_plain_maxdiff", "kernel_hall_vs_plain_maxdiff",
              "kernel_hall_tube_violation", "idle_share", "median_ms",
              "p90_ms", "cold_ms", "launches_per_step",
              "ns512_launches_per_step", "car_launches_per_step", "device",
              "seed", "unit", "notes", "load_avg_1min"):
        assert k in line, k
    assert line["seed"] == 7 and line["device"] == "cpu"
    assert line["steps"] == 3 and line["car_steps"] == 2
    assert line["value"] > 0 and line["ns512_value"] > 0
    assert line["car_value"] > 0 and line["fs_value"] > 0
    assert line["ns512_qp_shape"] == [20, 1000, 8]
    # on the CPU both routes are the plain versions: no kernel launches,
    # the differences exactly 0, no baseline and no device trace
    assert all(v == 0 for v in line["launches_per_step"].values())
    assert line["kernel_gp_vs_plain_maxdiff"] == 0.0
    assert line["kernel_hall_tube_violation"] == 0.0
    assert line["vs_baseline"] is None and line["idle_share"] is None
    assert rows["car"]["sqp_iters"] == [4, 4, 4]
    assert rows["fs"]["nonfinite_realizations"] == 0


def test_bench_cli_raises_without_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "sampling_gpmpc_torch.bench"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ROOT})
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "{" not in out.stdout
