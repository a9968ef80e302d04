"""The port's two GP baselines against the JAX package's, float64 on the
CPU, on params_car_residual (the baselines' default config).

* B5 (``sampling_gpmpc_torch.linearization_baseline.propagate``): means
  and covariances to 1e-10 over 10 steps of the golden plan's inputs;
* B6 (``sampling_gpmpc_torch.robust_tube_baseline``): the five checks of
  tests/test_robust_tube.py on the port (the Minkowski outer bound, the
  Lipschitz estimator, the tube around sampled rollouts, the explosion
  freeze, the ellipse polyline); ``estimate_lipschitz_from_traj`` to 1e-10
  and ``propagate_tube``'s centers and shapes to 1e-9 relative against
  JAX's on a true-dynamics trajectory under the config's feedback, and the
  same freeze step; the CLI writes the four koller_*.pkl overlays that
  ``visu_main --plot-koller`` reads.
"""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu import agent as jagent
from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
from sampling_gpmpc_torch import agent as tagent
from sampling_gpmpc_torch import linearization_baseline as lin
from sampling_gpmpc_torch import robust_tube_baseline as rtb
from sampling_gpmpc_torch.reachability import forward_sample_rollout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarking"))
import linearization_baseline as jlin  # noqa: E402
import robust_tube_baseline as jrtb  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "goldens", "params_car_residual.npz")
F64 = torch.float64
t64 = lambda a: torch.tensor(np.array(a), dtype=F64)  # noqa: E731


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_problem(param):
    params, spec, data = jload(os.path.join(ROOT, "params", param + ".yaml"))
    spec = dataclasses.replace(spec, ns=1)
    params["agent"]["num_dyn_samples"] = 1
    env = jmake_env(spec, params)
    hyp = JHyp.from_spec(spec.gp, jnp.float64)
    gp = jagent.init_gp_state(spec, env, jnp.float64, capacity=1)
    return spec, data, env, hyp, gp


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_b5_propagate_matches_jax():
    _, spec, data, env, hyp, gp = lin.one_sample_problem(
        "params_car_residual", "cpu", F64)
    U = np.load(GOLDEN)["last_plan_U"][:10]
    mus, Ps = lin.propagate(spec, env, hyp, gp, t64(data.start), t64(U))
    js, jd, jenv, jhyp, jgp = _jax_problem("params_car_residual")
    jm, jP = jlin.propagate(js, jenv, jhyp, jgp, jnp.asarray(jd.start),
                            jnp.asarray(U))
    assert mus.shape == (11, spec.nx) and Ps.shape == (11, spec.nx, spec.nx)
    np.testing.assert_allclose(mus.numpy(), np.asarray(jm), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(Ps.numpy(), np.asarray(jP), atol=1e-10,
                               rtol=0)
    assert np.trace(Ps[-1].numpy()) > 0


def test_minkowski_outer_bound_contains_sum():
    rng = np.random.default_rng(0)
    A1, A2 = rng.normal(size=(2, 2)), rng.normal(size=(2, 2))
    Q1 = A1 @ A1.T + 0.1 * np.eye(2)
    Q2 = A2 @ A2.T + 0.1 * np.eye(2)
    Qs = rtb.minkowski_ellipsoid(t64(Q1), t64(Q2)).numpy()
    np.testing.assert_allclose(Qs, np.asarray(jrtb.minkowski_ellipsoid(
        jnp.asarray(Q1), jnp.asarray(Q2))), rtol=1e-14)
    for t in np.linspace(0, np.pi, 17):
        d = np.array([np.cos(t), np.sin(t)])
        h_sum = np.sqrt(d @ Q1 @ d) + np.sqrt(d @ Q2 @ d)
        assert np.sqrt(d @ Qs @ d) >= h_sum - 1e-9
    Z = torch.zeros((2, 2), dtype=F64)
    assert np.allclose(rtb.minkowski_ellipsoid(t64(Q1), Z).numpy(), Q1)
    assert np.allclose(rtb.minkowski_ellipsoid(Z, t64(Q2)).numpy(), Q2)


def test_pairwise_lipschitz_linear_function():
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, size=(30, 2))
    W = np.array([[2.0, 0.0], [0.0, -1.0]])
    L = float(rtb.pairwise_lipschitz(t64(X), t64(X @ W.T)))
    assert 1.5 < L <= 2.0 + 1e-6
    assert abs(L - float(jrtb.pairwise_lipschitz(
        jnp.asarray(X), jnp.asarray(X @ W.T)))) <= 1e-12


def _pendulum():
    return lin.one_sample_problem("params_pendulum1D_samples", "cpu", F64)


def test_tube_contains_sampled_rollouts_early_stages():
    params, spec, data, env, hyp, gp = _pendulum()
    T = 5
    U = torch.zeros((T, spec.nu), dtype=F64)
    x0 = t64(data.start)
    cs, Qs, _ = rtb.propagate_tube(
        spec, env, hyp, gp, x0, U, np.zeros((spec.nu, spec.nx)),
        t64(data.goal), t64(np.full(spec.nx, 0.5)),
        t64(np.full(spec.nx, 0.5)), spec.gp.beta)
    spec_fs = dataclasses.replace(spec, ns=16)
    gp_fs = tagent.init_gp_state(spec_fs, env, "cpu", F64, capacity=T,
                                 hyp=hyp)
    X, _ = forward_sample_rollout(spec_fs, env, hyp, gp_fs, data.start, U,
                                  torch.Generator().manual_seed(0))
    X = X.numpy()
    for t in range(1, T + 1):
        Qinv = np.linalg.pinv(Qs[t].numpy())
        d = X[t] - cs[t].numpy()[None]
        lvl = np.einsum("si,ij,sj->s", d, Qinv, d)
        assert np.quantile(lvl, 0.9) <= 1.0 + 1e-6, (t, np.sort(lvl)[-3:])


def test_explosion_freezes_not_nan_at_jax_step():
    params, spec, data, env, hyp, gp = _pendulum()
    T = 25
    l = np.full(spec.nx, 5.0)
    args = (np.zeros((spec.nu, spec.nx)),)
    cs, Qs, means = rtb.propagate_tube(
        spec, env, hyp, gp, t64(data.start), torch.zeros((T, spec.nu),
                                                         dtype=F64),
        *args, t64(data.goal), t64(l), t64(l), spec.gp.beta)
    Qs, cs = Qs.numpy(), cs.numpy()
    assert np.all(np.isfinite(Qs)) and np.all(np.isfinite(cs))
    tr = np.trace(Qs, axis1=1, axis2=2)
    assert tr[-1] > 1e6 and tr[-1] == tr[-2]
    js, jd, jenv, jhyp, jgp = _jax_problem("params_pendulum1D_samples")
    jc, jQ, _ = jrtb.propagate_tube(
        js, jenv, jhyp, jgp, jnp.asarray(jd.start),
        jnp.zeros((T, js.nu), jnp.float64), *args, jnp.asarray(jd.goal),
        jnp.asarray(l), jnp.asarray(l), js.gp.beta)
    jtr = np.trace(np.asarray(jQ), axis1=1, axis2=2)
    frozen = lambda t: int(np.argmax(t[1:] == t[:-1]))  # noqa: E731
    assert frozen(tr) == frozen(jtr) > 0
    k = frozen(tr) + 1
    assert _rel(Qs[:k], jQ[:k]) <= 1e-9 and _rel(cs, jc) <= 1e-9


def test_b6_lipschitz_and_tube_match_jax():
    _, spec, data, env, hyp, gp = lin.one_sample_problem(
        "params_car_residual", "cpu", F64)
    T = 10
    U = t64(np.load(GOLDEN)["last_plan_U"][:T])
    k_fb = np.asarray(data.K_fb)
    X = rtb.true_rollout(env, t64(data.start), U, k_fb, t64(data.goal))
    Z, Y = tagent.full_train_set(spec, gp)
    l_mu, l_sig = rtb.estimate_lipschitz_from_traj(spec, env, hyp, Z, Y, X,
                                                   U)
    js, jd, jenv, jhyp, jgp = _jax_problem("params_car_residual")
    jZ, jY = jagent.full_train_set(js, jgp)
    jl_mu, jl_sig = jax.jit(lambda X_, U_: jrtb.estimate_lipschitz_from_traj(
        js, jenv, jhyp, jZ, jY, X_, U_))(jnp.asarray(X.numpy()),
                                         jnp.asarray(U.numpy()))
    np.testing.assert_allclose(l_mu.numpy(), np.asarray(jl_mu), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(l_sig.numpy(), np.asarray(jl_sig),
                               atol=1e-10, rtol=0)
    # the tube on the same constants on both sides
    cs, Qs, means = rtb.propagate_tube(spec, env, hyp, gp, t64(data.start),
                                       U, k_fb, t64(data.goal), t64(jl_mu),
                                       t64(jl_sig), spec.gp.beta)
    jc, jQ, jm = jrtb.propagate_tube(
        js, jenv, jhyp, jgp, jnp.asarray(jd.start), jnp.asarray(U.numpy()),
        k_fb, jnp.asarray(jd.goal), jl_mu, jl_sig, js.gp.beta)
    assert cs.shape == (T + 1, spec.nx) and means.shape == (T, spec.nx)
    assert _rel(cs, jc) <= 1e-9 and _rel(means, jm) <= 1e-9
    for t in range(T + 1):
        assert _rel(Qs[t], jQ[t]) <= 1e-9, (t, _rel(Qs[t], jQ[t]))


def test_ellipse_polyline_geometry():
    poly = rtb.ellipse_polyline(np.array([1.0, 2.0]), np.diag([4.0, 1.0]),
                                n=64)
    assert poly.shape == (2, 64)
    assert np.max(poly[0]) == pytest.approx(3.0, abs=1e-2)
    assert np.max(poly[1]) == pytest.approx(3.0, abs=1e-2)
    np.testing.assert_array_equal(poly, jrtb.ellipse_polyline(
        np.array([1.0, 2.0]), np.diag([4.0, 1.0]), n=64))


def test_b6_cli_writes_the_koller_overlays(tmp_path):
    rtb.main(["--device", "cpu", "--steps", "6", "--out", str(tmp_path)])
    names = ("koller_ellipse_data.pkl", "koller_ellipse_center_data.pkl",
             "koller_mean_data.pkl", "koller_true_data.pkl")
    got = {}
    for n in names:
        with open(tmp_path / n, "rb") as f:
            got[n] = pickle.load(f)
        assert len(got[n]) == 6
    assert got[names[0]][0].shape == (2, 100)
    assert got[names[1]][0].shape == (4, 1)
    out = tmp_path / "lin.pkl"
    lin.main(["--device", "cpu", "--steps", "6", "--out", str(out)])
    with open(out, "rb") as f:
        d = pickle.load(f)
    assert d["means"].shape == (7, 4) and d["covs"].shape == (7, 4, 4)


def _jax_baselines(dt, steps):
    """B5 and B6 of the JAX package in ``dt`` (chip_smoke's baseline_run)."""
    spec, data, env, _, _ = _jax_problem("params_car_residual")
    hyp = JHyp.from_spec(spec.gp, dt)
    gp = jagent.init_gp_state(spec, env, dt, capacity=1)
    U = jnp.asarray(np.load(GOLDEN)["last_plan_U"][:steps], dt)
    x0, goal = jnp.asarray(data.start, dt), jnp.asarray(data.goal, dt)
    k = np.asarray(data.K_fb)
    K = jnp.asarray(k, dt)
    mus, Ps = jax.jit(lambda x, u: jlin.propagate(spec, env, hyp, gp, x, u))(
        x0, U)

    def step(x, u):
        xn = env.discrete_dyn(x, u + K @ (x - goal)).reshape(-1)
        return xn, xn

    X = jnp.concatenate([x0[None], jax.lax.scan(step, x0, U)[1]])
    Z, Y = jagent.full_train_set(spec, gp)
    l_mu, l_sig = jax.jit(lambda a, b: jrtb.estimate_lipschitz_from_traj(
        spec, env, hyp, Z, Y, a, b))(X, U)
    cs_, Qs, _ = jax.jit(lambda x, u: jrtb.propagate_tube(
        spec, env, hyp, gp, x, u, k, goal, l_mu, l_sig, spec.gp.beta))(x0, U)
    out = dict(means=mus, covs=Ps, l_mu=l_mu, l_sig=l_sig, centers=cs_,
               shapes=Qs)
    return {n: np.asarray(v, np.float64) for n, v in out.items()}


@pytest.mark.slow
def test_f32_envelope_vs_jax():
    """The float32 readings behind chip_smoke.py's phase baselines, on the
    CPU: the JAX package's float32 B5/B6 against its float64 (the
    BASE_JAX_F32 constants, relative to each quantity's largest magnitude)
    and the port's float32 within ENV_FACTOR of them; both float32 tubes
    overflow and freeze before the float64 one (prints the readings)."""
    import chip_smoke as cs
    j64 = _jax_baselines(jnp.float64, cs.BASE_STEPS)
    j32 = _jax_baselines(jnp.float32, cs.BASE_STEPS)
    p32 = cs.baseline_run(torch.device("cpu"), torch.float32)
    for n, want in cs.BASE_JAX_F32.items():
        jr, pr = cs._rel(j32[n], j64[n]), cs._rel(p32[n], j64[n])
        print(f"{n}: JAX float32 {jr:.4e}, port float32 {pr:.4e}")
        assert abs(jr - want) <= 0.01 * want
        assert pr <= cs.ENV_FACTOR * want
    f64, f32 = cs.frozen_step(j64["shapes"]), cs.frozen_step(j32["shapes"])
    print(f"frozen at step {f64} (float64), {f32} (JAX float32), "
          f"{cs.frozen_step(p32['shapes'])} (port float32)")
    assert 0 < f32 < f64 and 0 < cs.frozen_step(p32["shapes"]) < f64


@pytest.mark.slow
def test_tube_float64_floor():
    """The float64 floor behind chip_smoke.py's BASE_TUBE_RTOL: the Koller
    tube's shapes (up to the freeze) move when the start moves by 1e-15
    relative, on the CPU (prints the reading)."""
    import chip_smoke as cs
    _, spec, data, env, hyp, gp = lin.one_sample_problem(
        cs.BASE_CONFIG, "cpu", F64)
    U = t64(np.load(GOLDEN)["last_plan_U"][:cs.BASE_STEPS])
    k = np.asarray(data.K_fb)
    X = rtb.true_rollout(env, t64(data.start), U, k, t64(data.goal))
    Z, Y = tagent.full_train_set(spec, gp)
    l_mu, l_sig = rtb.estimate_lipschitz_from_traj(spec, env, hyp, Z, Y, X,
                                                   U)
    Qs = [rtb.propagate_tube(spec, env, hyp, gp, t64(data.start) * s, U, k,
                             t64(data.goal), l_mu, l_sig,
                             spec.gp.beta)[1].numpy()
          for s in (1.0, 1.0 + 1e-15)]
    fz = cs.frozen_step(Qs[0])
    floor = cs._rel(Qs[1][:fz], Qs[0][:fz])
    print(f"frozen at step {fz}; shapes move {floor:.3e} relative")
    assert 1e-9 < floor < cs.BASE_TUBE_RTOL / 5
