"""The port's design tools against the JAX package's, float64 on the CPU.

* ``training_grid`` of all four GP envs equals JAX's;
* ``lipschitz``: the closed-loop Jacobians and the Lipschitz estimate to
  1e-10;
* ``terminal_set``: ``synthesize``'s P and K to 1e-9, ``synthesize_lmi``
  to 1e-6;
* ``mle``: ``masked_nll``'s value and gradient to 1e-10, a 50-step Adam fit
  to 1e-8 relative;
* ``sample_complexity``: every function to 1e-10, the Monte-Carlo ones on
  JAX's draws injected;
* ``num_of_samples.run`` at n_mc = 2,000 on JAX's draws injected: the same
  small-ball curves and the same N(delta).

torch runs on one thread here (the suite's parallel workers oversubscribe
the cores otherwise).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.envs import make_env as tmake_env

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
PEND = "params_pendulum1D_samples"


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _both(config):
    path = os.path.join(HERE, "params", config + ".yaml")
    jp, js, jd = jload(path)
    tp, ts, td = tload(path)
    return (jp, js, jd, jmake_env(js, jp)), (tp, ts, td, tmake_env(ts, tp))


@pytest.mark.parametrize("config", ["params_pendulum1D_samples",
                                    "params_pendulum", "params_car",
                                    "params_car_residual"])
def test_training_grid_matches_jax(config):
    (_, _, _, jenv), (_, _, _, tenv) = _both(config)
    jX, jY = jenv.training_grid()
    tX, tY = tenv.training_grid()
    assert isinstance(tX, np.ndarray) and isinstance(tY, np.ndarray)
    assert tX.shape == np.shape(jX) and tY.shape == np.shape(jY)
    np.testing.assert_array_equal(tX, np.asarray(jX))
    np.testing.assert_allclose(tY, np.asarray(jY), rtol=0, atol=1e-15)
    assert np.array_equal(np.isnan(tY), np.isnan(np.asarray(jY)))


@pytest.mark.parametrize("config", ["params_pendulum1D_samples",
                                    "params_pendulum", "params_car",
                                    "params_car_residual"])
def test_closed_loop_jacobian_matches_jax(config):
    from sampling_gpmpc_tpu.tools import lipschitz as jl
    from sampling_gpmpc_torch.tools import lipschitz as tl
    (_, js, jd, jenv), (_, ts, _, tenv) = _both(config)
    rng = np.random.default_rng(1)
    lo = np.concatenate([jd.x_min, jd.u_min])
    hi = np.concatenate([jd.x_max, jd.u_max])
    K = rng.normal(size=(js.nu, js.nx))
    for xu in rng.uniform(lo, hi, size=(4, len(lo))):
        j = np.asarray(jl.closed_loop_jacobian(jenv, jnp.asarray(xu),
                                               jnp.asarray(K)))
        t = tl.closed_loop_jacobian(tenv, torch.from_numpy(xu),
                                    torch.from_numpy(K)).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-10)


def test_lipschitz_matches_jax():
    from sampling_gpmpc_tpu.tools import lipschitz as jl
    from sampling_gpmpc_torch.tools import lipschitz as tl
    (_, _, jd, jenv), (_, _, td, tenv) = _both(PEND)
    grid = tl.grid_around([2.1, -2.5, -5.0], [3.6, 2.5, 5.0], 7)
    np.testing.assert_array_equal(
        grid, jl.grid_around([2.1, -2.5, -5.0], [3.6, 2.5, 5.0], 7))
    j = jl.estimate_lipschitz(jenv, jd.P_term, jd.K_fb, grid[:, :2],
                              grid[:, 2:])
    t = tl.estimate_lipschitz(tenv, td.P_term, td.K_fb, grid[:, :2],
                              grid[:, 2:], **CPU)
    assert t == pytest.approx(j, rel=0, abs=1e-10)
    assert 0.8 < t < 1.1


def test_synthesize_matches_jax():
    from sampling_gpmpc_tpu.tools import terminal_set as jts
    from sampling_gpmpc_torch.tools import terminal_set as tts
    (_, js, jd, jenv), (_, _, td, tenv) = _both(PEND)
    rng = np.random.default_rng(0)
    pts = (np.concatenate([jd.goal, np.zeros(js.nu)])[None]
           + 0.1 * rng.normal(size=(12, js.nx + js.nu)))
    args = (jd.goal, np.zeros(js.nu), np.diag([10.0, 15.0]), np.diag([0.9]),
            jd.x_min, jd.x_max, jd.u_min, jd.u_max)
    j = jts.synthesize(jenv, *args, vertices=pts)
    t = tts.synthesize(tenv, *args, vertices=pts, **CPU)
    np.testing.assert_allclose(t.P, j.P, rtol=1e-9, atol=0)
    np.testing.assert_allclose(t.K, j.K, rtol=1e-9, atol=0)
    assert t.delta == pytest.approx(j.delta, rel=1e-9)
    assert t.rho == pytest.approx(j.rho, rel=1e-9)
    assert t.rho < 1.0 and t.delta > 0


def test_synthesize_lmi_matches_jax():
    from sampling_gpmpc_tpu.tools import terminal_set as jts
    from sampling_gpmpc_torch.tools import terminal_set as tts
    (_, js, jd, jenv), (_, _, td, tenv) = _both(PEND)
    x_eq, u_eq = jd.goal, np.zeros(js.nu)
    rng = np.random.default_rng(0)
    pts = (np.concatenate([x_eq, u_eq])[None]
           + 0.1 * rng.normal(size=(12, js.nx + js.nu)))
    kw = dict(rho=0.995, x_min=jd.x_min, x_max=jd.x_max, u_min=jd.u_min,
              u_max=jd.u_max, vertices=pts)
    j = jts.synthesize_lmi(jenv, x_eq, u_eq, **kw)
    t = tts.synthesize_lmi(tenv, x_eq, u_eq, **kw, **CPU)
    np.testing.assert_allclose(t.P, j.P, rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.K, j.K, rtol=1e-6, atol=0)
    assert t.rho == pytest.approx(j.rho, rel=1e-6)
    assert t.rho <= 0.995 + 1e-6 and t.delta == 1.0


def _mle_data():
    from sampling_gpmpc_tpu.gp.kernel import rbf_grad
    rng = np.random.default_rng(0)
    Z = rng.uniform(-2, 2, size=(30, 2))
    K = np.asarray(jax.jit(rbf_grad)(jnp.asarray(Z), jnp.asarray(Z),
                                     np.array([0.8, 1.3]), 0.5))
    L = np.linalg.cholesky(K + 1e-8 * np.eye(K.shape[0]))
    Y = (L @ rng.normal(size=K.shape[0])).reshape(30, 3)
    Y[[3, 7], 1:] = np.nan        # masked gradient observations
    return Z, Y


def test_masked_nll_value_and_gradient_match_jax():
    from sampling_gpmpc_tpu.tools import mle as jm
    from sampling_gpmpc_torch.tools import mle as tm
    Z, Y = _mle_data()
    p = (np.log([0.9, 1.2]), np.log(0.7), np.log([1e-3, 2e-3, 3e-3]))
    jv, jg = jax.jit(jax.value_and_grad(
        lambda a, b, c: jm.masked_nll(jnp.asarray(Z), jnp.asarray(Y), a, b,
                                      c, True), argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in p))
    tp = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
          for a in p]
    tv = tm.masked_nll(torch.from_numpy(Z), torch.from_numpy(Y), *tp, True)
    tv.backward()
    assert tv.item() == pytest.approx(float(jv), rel=0, abs=1e-10)
    for a, b in zip(tp, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


def test_fit_matches_jax_50_steps():
    from sampling_gpmpc_tpu.tools import mle as jm
    from sampling_gpmpc_torch.tools import mle as tm
    Z, Y = _mle_data()
    kw = dict(iters=50, init={"lengthscale": np.ones(2), "outputscale": 1.0})
    j = jm.fit_gp_hyperparameters(Z, Y, **kw)
    t = tm.fit_gp_hyperparameters(Z, Y, **kw, **CPU)
    for k in ("lengthscale", "outputscale", "task_noises"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-8, atol=0, err_msg=k)
    assert t["nll"] == pytest.approx(j["nll"], rel=1e-8)


def test_fit_env_gp_runs_every_output():
    from sampling_gpmpc_torch.tools import mle as tm
    _, (_, ts, _, tenv) = _both(PEND)
    fits = tm.fit_env_gp(tenv, ts, iters=3, **CPU)
    assert len(fits) == ts.g_ny
    assert fits[0]["lengthscale"].shape == (2,)
    assert np.isfinite(fits[0]["nll"])


def _sc_problem():
    rng = np.random.default_rng(0)
    Z = rng.uniform(-1, 1, size=(20, 2))
    y = np.sin(Z[:, 0]) * np.cos(Z[:, 1])
    grid = rng.uniform(-1, 1, size=(30, 2))
    return Z, y, grid, np.array([0.7, 0.7]), 0.5, 1e-4


def test_sample_complexity_matches_jax():
    from sampling_gpmpc_tpu.tools import sample_complexity as jsc
    from sampling_gpmpc_torch.tools import sample_complexity as tsc
    Z, y, grid, ls, os_, lam = _sc_problem()
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    close(tsc.rkhs_norm(Z, y, ls, os_, lam, **CPU),
          jsc.rkhs_norm(Z, y, ls, os_, lam))
    close(tsc.info_beta(Z, ls, os_, lam, **CPU),
          jsc.info_beta(Z, ls, os_, lam))
    close(tsc.posterior_mean_at_train(Z, y, ls, os_, lam, **CPU),
          np.asarray(jsc.posterior_mean_at_train(Z, y, ls, os_, lam)))
    close(tsc.posterior_norm_diff(Z, y, ls, os_, lam, 2e-4, 1e-3, **CPU),
          jsc.posterior_norm_diff(Z, y, ls, os_, lam, 2e-4, 1e-3))
    Zd = np.random.default_rng(1).uniform(-1, 1, size=(60, 2))
    yd = np.sin(Zd[:, 0]) * np.cos(Zd[:, 1])
    jcd = jsc.change_of_measure_cd(Z, y, Zd, yd, ls, os_, lam, 2e-4, 1e-3)
    tcd = tsc.change_of_measure_cd(Z, y, Zd, yd, ls, os_, lam, 2e-4, 1e-3,
                                   **CPU)
    assert set(tcd) == set(jcd)
    for k in jcd:
        assert tcd[k] == pytest.approx(jcd[k], rel=1e-10, abs=1e-10), k
    for args in ((0.0, 0.5, 0.05), (1.0, 0.5, 0.05), (0.0, 0.0, 0.05),
                 (2.0, 0.3, 0.001)):
        assert (tsc.num_samples_with_measure_shift(*args)
                == jsc.num_samples_with_measure_shift(*args))
    for args in ((0.5, 0.05), (1.0, 0.05), (0.0, 0.05), (0.2, 0.001)):
        assert (tsc.num_samples_for_coverage(*args)
                == jsc.num_samples_for_coverage(*args))

    # the posterior on the grid and its factor
    jmean, jcov = jsc._posterior_on_grid(Z, y, grid, ls, os_, lam)
    tmean, tcov = tsc._posterior_on_grid(Z, y, grid, ls, os_, lam,
                                         torch.device("cpu"))
    close(tmean.numpy(), np.asarray(jmean))
    close(tcov.numpy(), np.asarray(jcov))
    close(tsc._psd_factor(tcov).numpy(), np.asarray(jsc._psd_factor(jcov)))

    # Monte-Carlo functions on JAX's draws
    n = 500
    key = jax.random.PRNGKey(0)
    eps = np.asarray(jax.random.normal(key, (n, grid.shape[0]),
                                       jnp.float64))
    close(tsc.max_deviation_samples(Z, y, grid, ls, os_, lam, n, eps=eps,
                                    **CPU),
          jsc.max_deviation_samples(Z, y, grid, ls, os_, lam, n, key))
    for e in (0.01, 0.05, 0.5):
        assert (tsc.small_ball_probability(Z, y, grid, ls, os_, lam, e, n,
                                           draws=eps, **CPU)
                == jsc.small_ball_probability(Z, y, grid, ls, os_, lam, e,
                                              n, key))
    for p in (0.5, 0.9):
        close(tsc.epsilon_for_probability(Z, y, grid, ls, os_, lam, p, n,
                                          draws=eps, **CPU),
              jsc.epsilon_for_probability(Z, y, grid, ls, os_, lam, p, n,
                                          key))
    chunk, n = 512, 1300
    k7 = jax.random.PRNGKey(7)
    eps_c = np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(k7, c), (chunk, grid.shape[0]), jnp.float64))
        for c in range(-(-n // chunk))])[:n]
    close(tsc.max_deviation_samples_chunked(Z, y, grid, ls, os_, lam, n,
                                            chunk=chunk, eps=eps_c, **CPU),
          jsc.max_deviation_samples_chunked(Z, y, grid, ls, os_, lam, n, k7,
                                            chunk=chunk))
    # the port's own draws: a generator on the device, chunked or not
    g = torch.Generator().manual_seed(3)
    d1 = tsc.max_deviation_samples_chunked(Z, y, grid, ls, os_, lam, 3000,
                                           g, chunk=1024, **CPU)
    d2 = tsc.max_deviation_samples(Z, y, grid, ls, os_, lam, 3000, **CPU)
    assert d1.shape == d2.shape == (3000,)
    assert abs(np.median(d1) - np.median(d2)) < 0.1 * np.median(d2)


def _jax_run_draws(params, spec, data, n_mc, n_grid_max, seed=0,
                   chunk=8192):
    """The standard normals JAX's num_of_samples.run draws per grid size."""
    from sampling_gpmpc_tpu.tools import sample_complexity as jsc
    key = jax.random.PRNGKey(seed)
    out = {}
    for n in range(1, n_grid_max + 1):
        G = jsc.gp_input_grid(spec, data, n).shape[0]
        kn = jax.random.fold_in(key, n)
        out[n] = np.concatenate([np.asarray(jax.random.normal(
            jax.random.fold_in(kn, c), (chunk, G), jnp.float64))
            for c in range(-(-n_mc // chunk))])[:n_mc]
    return out


def test_num_of_samples_run_matches_jax():
    from sampling_gpmpc_tpu.tools import num_of_samples as jnos
    from sampling_gpmpc_torch.tools import num_of_samples as tnos
    (jp, js, jd, _), (tp, ts, td, _) = _both(PEND)
    # the dense grid of the true-norm stand-in 4x (not 10x) finer, as
    # tests/test_tools.py runs it, and grid sizes 1-5 (not 1-8): the JAX
    # package compiles its eager ops anew for every grid size (276
    # compilations, 14 of its 19 s at 1-8); chip_smoke.py's phase tools
    # runs the published 1-8 on the card against the CPU
    n_mc, kw = 2000, dict(dense_factor=4, n_grid_max=5)
    j = jnos.run(jp, js, jd, n_mc=n_mc, **kw)
    t = tnos.run(tp, ts, td, n_mc=n_mc,
                 draws=_jax_run_draws(jp, js, jd, n_mc, 5), **kw, **CPU)
    assert t["grids"] == j["grids"]
    assert t["p_ball"] == j["p_ball"]
    assert t["b_phi"] == j["b_phi"]
    # the quantiles of the deviations: the grid covariance cancels to
    # ~1e-6 of the prior's scale, so the two packages' covariances agree
    # ~1e-10 relatively and the factor's near-null eigenvectors move with
    # them (measured: 1.4e-7 relative at the worst grid size)
    for p in j["eps_curves"]:
        np.testing.assert_allclose(t["eps_curves"][p], j["eps_curves"][p],
                                   rtol=1e-6, atol=0)
    for k in j["Cd"]:
        assert t["Cd"][k] == pytest.approx(j["Cd"][k], rel=1e-8), k
    assert t["beta"] == pytest.approx(j["beta"], rel=1e-10)
    assert t["num_samples"] == pytest.approx(j["num_samples"], rel=1e-8)
    assert np.ceil(t["num_samples"]) == np.ceil(j["num_samples"])


def test_num_of_samples_cli_without_matplotlib(monkeypatch, capsys,
                                               tmp_path):
    """The CLI computes N(delta) and skips its figures, with a note, where
    matplotlib cannot be imported (as on a machine with only the card's
    stack)."""
    import sys
    from sampling_gpmpc_torch.tools import num_of_samples
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "figures")
    res = num_of_samples.main(["--n-mc", "100", "--device", "cpu",
                               "--out", out])
    assert np.isfinite(res["num_samples"]) and res["num_samples"] > 0
    assert "no matplotlib: no figures" in capsys.readouterr().out
    assert not os.path.exists(out)


def test_goldens_run_load_and_save():
    """tools/goldens.py: the port's float64 loop of params_car_residual (one
    MPC step) on JAX's draws reproduces the JAX package's committed golden
    that load_golden reads; save_golden writes under experiments/, never
    into tests/goldens/."""
    from sampling_gpmpc_tpu import agent as jagent
    from sampling_gpmpc_torch.tools import goldens
    config = "params_car_residual"
    (_, js, _, _), _ = _both(config)
    eps = np.array(jagent.make_epistemic(jax.random.PRNGKey(js.seed), js,
                                         jnp.float64))
    got = goldens.run_closed_loop(config, device="cpu", epistemic=eps)
    ref = goldens.load_golden(config)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    name = f"unit_test_{os.getpid()}"
    path = goldens.save_golden(name, {"a": np.arange(3)})
    try:
        assert path == os.path.join(HERE, "experiments", "torch_goldens",
                                    name + ".npz")
        assert not os.path.exists(os.path.join(HERE, "tests", "goldens",
                                               name + ".npz"))
        with np.load(path) as z:
            np.testing.assert_array_equal(z["a"], np.arange(3))
    finally:
        os.remove(path)


def test_tools_entry_points_raise_without_cuda(monkeypatch):
    """Called without a device on a host without CUDA, every tool raises
    (they run on the card unless the caller asks for the CPU)."""
    from sampling_gpmpc_torch.tools import (goldens, lipschitz, mle,
                                            num_of_samples,
                                            sample_complexity, terminal_set)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (tp, ts, td, tenv) = _both(PEND)
    Z, y, grid, ls, os_, lam = _sc_problem()
    g = lipschitz.grid_around([2.1, -2.5, -5.0], [3.6, 2.5, 5.0], 2)
    box = (td.x_min, td.x_max, td.u_min, td.u_max)
    for call in (
            lambda: lipschitz.estimate_lipschitz(tenv, td.P_term, td.K_fb,
                                                 g[:, :2], g[:, 2:]),
            lambda: terminal_set.synthesize(tenv, td.goal, np.zeros(1),
                                            np.eye(2), np.eye(1), *box),
            lambda: terminal_set.synthesize_lmi(tenv, td.goal, np.zeros(1),
                                                0.995, *box),
            lambda: mle.fit_gp_hyperparameters(Z, y[:, None], iters=1),
            lambda: sample_complexity.rkhs_norm(Z, y, ls, os_, lam),
            lambda: sample_complexity.max_deviation_samples_chunked(
                Z, y, grid, ls, os_, lam, 10),
            lambda: num_of_samples.run(tp, ts, td, n_mc=10),
            lambda: num_of_samples.main(["--n-mc", "10"]),
            lambda: goldens.run_closed_loop("params_pendulum1D_samples"),
            lambda: goldens.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
