"""Forward-sampling reachability of the PyTorch port vs the JAX package.

* the rank-Ty factor append (``append_rows_update``) chained over a buffer
  against the block refactorization of the filled buffer and against the
  JAX chain, and ``predict_from_w`` against ``predict_update`` and JAX
  (float64, the JAX test's bars: 1e-9 factor, 1e-10 mean), and its
  sanitizer acting per batch entry;
* ``forward_sample_rollout`` on ``params_car_residual_fs`` (ns=16, T=10,
  ancillary feedback) against JAX on shared draws in float64 (bar 1e-6;
  measured 1.7e-11 on the CPU);
* determinism, value-only appended rows and the pinned function
  (pendulum1D, ns=8; as tests/test_reachability.py);
* ``reject_and_resample`` with everything rejected / everything alive,
  and a 4-step closed loop with dynamics rejection;
* the float32 rollout at ns=64, T=50 against the port's own float64 on
  the same draws (tests/test_f32_envelope.py's bars: 0.25 per
  realization, 0.15 on the envelope);
* (slow) the same at the full ns=4000, the JAX package's and the port's
  envelope errors side by side by width.
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
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_tpu.gp import exact as jexact
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
from sampling_gpmpc_tpu.reachability import \
    forward_sample_rollout as jforward
from sampling_gpmpc_torch import agent as tagent
from sampling_gpmpc_torch import convert
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.dempc import DEMPC
from sampling_gpmpc_torch.envs import make_env as tmake_env
from sampling_gpmpc_torch.gp import exact as texact
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.reachability import (forward_sample_rollout,
                                               reject_and_resample)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PDIR = os.path.join(HERE, "params")
FS = os.path.join(PDIR, "params_car_residual_fs.yaml")
GOLDEN = os.path.join(HERE, "tests", "goldens", "params_car_residual.npz")
LS = np.array([0.9, 1.3])
OS = 0.7
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These rollouts are chains of small torch ops: one intra-op thread
    keeps them from oversubscribing the cores that the suite's parallel
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _np(x):
    return np.asarray(x)


def test_rank_append_matches_block_refactor():
    """Chained rank-Ty appends reproduce the block refactorization of the
    filled buffer and the JAX chain: same factor, same w, same posterior,
    with value-only (NaN-gradient) observations and empty FAR slots."""
    rng = np.random.default_rng(7)
    Ty, cap, T = 3, 6, 4
    Zr = rng.normal(size=(8, 2))
    Yr = rng.normal(size=(8, Ty))
    Yr[::2, 1:] = np.nan
    noise = np.array([1e-6, 2e-6, 3e-6])
    Zh = np.full((cap, 2), 1.0e5)
    Yh = np.full((cap, Ty), np.nan)
    pts = rng.normal(size=(T, 2))
    obs = np.full((T, Ty), np.nan)
    obs[:, 0] = rng.normal(size=T)
    obs[2, 1] = rng.normal()
    J = jnp.asarray
    # each JAX function compiled once as a whole (eager dispatch compiles
    # every op on its own, which dominates this test's time)
    jit = lambda f, n: jax.jit(f, static_argnums=n)
    jrf = jit(jexact.factor_real, 6)(J(Zr), J(Yr), LS, OS, J(noise), 1e-12,
                                     True)
    trf = texact.factor_real(_t(Zr), _t(Yr), LS, OS, _t(noise), 1e-12, True)
    j_update = jit(jexact.condition_update, 8)
    juf = j_update(jrf, J(Zr), J(Zh), J(Yh), LS, OS, J(noise), 1e-12, True)
    tuf = texact.condition_update(trf, _t(Zr), _t(Zh), _t(Yh), LS, OS,
                                  _t(noise), 1e-12, True)
    keys = ("C", "L_s", "w_h", "mask_h")
    juf = {k: juf[k] for k in keys}
    tuf = {k: tuf[k] for k in keys}
    j_append = jit(jexact.append_rows_update, (11, 12))
    for t in range(T):
        Zh[t], Yh[t] = pts[t], obs[t]
        juf = j_append(
            jrf, juf, J(Zr), J(Zh), J(pts[t][None]), J(obs[t][None]),
            t * Ty, LS, OS, J(noise), 1e-12, True, False)
        tuf = texact.append_rows_update(
            trf, tuf, _t(Zr), _t(Zh), _t(pts[t][None]), _t(obs[t][None]),
            t * Ty, LS, OS, _t(noise), 1e-12, True)
    full = texact.condition_update(trf, _t(Zr), _t(Zh), _t(Yh), LS, OS,
                                   _t(noise), 1e-12, True)
    for key in keys:
        np.testing.assert_allclose(tuf[key].numpy(), full[key].numpy(),
                                   atol=1e-9, err_msg=key)
        np.testing.assert_allclose(tuf[key].numpy(), _np(juf[key]),
                                   atol=1e-9, err_msg=key)
    Xt = rng.normal(size=(3, 2))
    mean_w, cov_w = texact.predict_from_w(_t(Xt), _t(Zr), _t(Zh), trf, tuf,
                                          LS, OS, True, refine=True)
    mean_f, cov_f = texact.predict_update(_t(Xt), _t(Zr), _t(Zh), trf, full,
                                          LS, OS, True)
    jm, jc = jit(jexact.predict_from_w, (7, 8))(J(Xt), J(Zr), J(Zh), jrf,
                                                juf, LS, OS, True, True)
    np.testing.assert_allclose(mean_w.numpy(), mean_f.numpy(), atol=1e-10)
    np.testing.assert_allclose(cov_w.numpy(), cov_f.numpy(), atol=1e-9)
    np.testing.assert_allclose(mean_w.numpy(), _np(jm), atol=1e-10)
    np.testing.assert_allclose(cov_w.numpy(), _np(jc), atol=1e-9)
    # the JAX chain's w-form factor, carried over, predicts the same
    mean_j, _ = texact.predict_from_w(
        _t(Xt), _t(Zr), _t(Zh), trf,
        convert.update_factor({k: _np(v) for k, v in juf.items()}, "cpu"),
        LS, OS, True, refine=True)
    np.testing.assert_allclose(mean_j.numpy(), _np(jm), atol=1e-10)


def test_append_sanitizer_acts_per_entry():
    """A batched append whose computation fails for one entry (a NaN input
    point) masks that entry's new rows only (identity block, zero
    couplings and mask); the other entries get their own appends."""
    rng = np.random.default_rng(3)
    Ty, cap, B = 3, 4, 3
    Zr, Yr = _t(rng.normal(size=(6, 2))), _t(rng.normal(size=(6, Ty)))
    noise = _t([1e-6, 2e-6, 3e-6])
    rf = texact.factor_real(Zr, Yr, LS, OS, noise, 1e-12, True)
    Zh = torch.full((B, cap, 2), 1.0e5, dtype=F64)
    Yh = torch.full((B, cap, Ty), float("nan"), dtype=F64)
    keys = ("C", "L_s", "w_h", "mask_h")
    base = texact.condition_update(rf, Zr, Zh, Yh, LS, OS, noise, 1e-12,
                                   True)
    z = _t(rng.normal(size=(B, 1, 2)))
    z[1] = float("nan")
    y = _t(rng.normal(size=(B, 1, Ty)))
    Zh[:, 0] = z[:, 0]
    uf = texact.append_rows_update(
        rf, {k: base[k].clone() for k in keys}, Zr, Zh, z, y, 0, LS, OS,
        noise, 1e-12, True)
    eye = torch.eye(Ty, dtype=F64)
    assert torch.equal(uf["L_s"][1, :Ty, :Ty], eye)
    assert not uf["mask_h"][1].any() and not uf["C"][1].any()
    assert all(bool(torch.isfinite(v).all()) for v in uf.values())
    for i in (0, 2):
        one = texact.append_rows_update(
            rf, {k: base[k][i].clone() for k in keys}, Zr, Zh[i], z[i],
            y[i], 0, LS, OS, noise, 1e-12, True)
        for k in keys:
            np.testing.assert_allclose(uf[k][i].numpy(), one[k].numpy(),
                                       atol=1e-12, err_msg=k)
        assert uf["mask_h"][i, :Ty].all()


def _fs_problem(load, make_env, ns):
    params, spec, data = load(FS)
    spec = dataclasses.replace(spec, ns=ns)
    params["agent"]["num_dyn_samples"] = ns
    return params, spec, data, make_env(spec, params)


def test_fs_rollout_matches_jax_float64():
    ns, T = 16, 10
    _, js, jd, jenv = _fs_problem(jload, jmake_env, ns)
    _, ts, td, tenv = _fs_problem(tload, tmake_env, ns)
    U = np.load(GOLDEN)["last_plan_U"][:T]
    eps = np.clip(np.random.default_rng(0).normal(
        size=(T, ns, js.g_ny, 1, js.Ty)), -js.gp.beta, js.gp.beta)
    gpj = jagent.init_gp_state(js, jenv, jnp.float64, capacity=T)
    Xj, gpj = jforward(js, jenv, JHyp.from_spec(js.gp, jnp.float64), gpj,
                       jnp.asarray(jd.start), jnp.asarray(U),
                       jax.random.PRNGKey(0),
                       use_feedback={"K": jd.K_fb, "x_eq": jd.goal},
                       eps=jnp.asarray(eps))
    hyp = GPHyperArrays.from_spec(ts.gp, "cpu", F64)
    gpt = tagent.init_gp_state(ts, tenv, "cpu", F64, capacity=T, hyp=hyp)
    Xt, gpt = forward_sample_rollout(
        ts, tenv, hyp, gpt, td.start, U,
        use_feedback={"K": td.K_fb, "x_eq": td.goal}, eps=eps)
    assert Xt.shape == (T + 1, ns, ts.nx) and gpt.hall_n == T
    np.testing.assert_allclose(Xt.numpy(), _np(Xj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gpt.hall_Y.numpy(), _np(gpj.hall_Y),
                               atol=1e-6)


@pytest.fixture(scope="module")
def pend():
    params, spec, data = tload(os.path.join(
        PDIR, "params_pendulum1D_samples.yaml"))
    spec = dataclasses.replace(spec, ns=8)
    params["agent"]["num_dyn_samples"] = 8
    env = tmake_env(spec, params)
    return params, spec, data, env, GPHyperArrays.from_spec(spec.gp, "cpu",
                                                            F64)


def test_rollout_deterministic_and_consistent(pend):
    params, spec, data, env, hyp = pend
    T = 6
    gp = tagent.init_gp_state(spec, env, "cpu", F64, capacity=T, hyp=hyp)
    U = np.full((T, spec.nu), 0.5)
    run = lambda: forward_sample_rollout(
        spec, env, hyp, gp, data.start, U, torch.Generator().manual_seed(7))
    X1, gp1 = run()
    X2, _ = run()
    assert torch.equal(X1, X2)
    assert X1.shape == (T + 1, spec.ns, spec.nx) and gp1.hall_n == T
    assert float((X1[-1].max(0).values - X1[-1].min(0).values).max()) > 1e-6
    # every appended observation is value-only (gradients NaN-masked)
    assert torch.isnan(gp1.hall_Y[:, :, :T, 1:]).all()
    assert not torch.isnan(gp1.hall_Y[:, :, :T, 0]).any()
    assert gp.hall_n == 0 and torch.isnan(gp.hall_Y).all()   # unchanged


def test_iterative_conditioning_pins_the_function(pend):
    """After appending a sampled value, the posterior at that input
    reproduces it (function-realization semantics)."""
    params, spec, data, env, hyp = pend
    T = 4
    gp = tagent.init_gp_state(spec, env, "cpu", F64, capacity=T, hyp=hyp)
    _, gp1 = forward_sample_rollout(spec, env, hyp, gp, data.start,
                                    np.ones((T, spec.nu)),
                                    torch.Generator().manual_seed(3))
    mean, cov = tagent._batched_posterior_incremental(
        spec, hyp, gp1, gp1.hall_Z[:, 0, :T, :])
    mean = mean.reshape(spec.ns, spec.g_ny, T, spec.Ty)
    np.testing.assert_allclose(mean[..., 0].numpy(),
                               gp1.hall_Y[:, :, :T, 0].numpy(), atol=5e-3)
    var = torch.diagonal(cov, dim1=-2, dim2=-1).reshape(
        spec.ns, spec.g_ny, T, spec.Ty)
    assert float(var[..., 0].max()) < 1e-4


def test_reject_and_resample(pend):
    params, spec, data, env, hyp = pend
    gp = tagent.init_gp_state(spec, env, "cpu", F64, hyp=hyp)
    hall_Z = gp.hall_Z.clone()
    hall_Z[..., 0] = torch.arange(spec.ns, dtype=F64)[:, None, None]
    gp = gp._replace(hall_Z=hall_Z)
    H = spec.H
    U_plan = np.zeros((H, spec.nu))
    x_next = data.start
    X_far = np.full((H + 1, spec.ns, spec.nx), 50.0)
    gen = torch.Generator().manual_seed(0)
    gp2, n_alive = reject_and_resample(spec, env, hyp, gp, X_far, U_plan,
                                       x_next, np.full(H, 1e-3), 1e-3, gen)
    assert n_alive == 0 and torch.equal(gp2.hall_Z, gp.hall_Z)
    X_ok = np.broadcast_to(x_next, (H + 1, spec.ns, spec.nx)).copy()
    gp3, n_alive = reject_and_resample(spec, env, hyp, gp, X_ok, U_plan,
                                       x_next, np.full(H, 1e3), 1e3, gen)
    assert n_alive == spec.ns
    np.testing.assert_array_equal(gp3.hall_Z[:, 0, 0, 0].numpy(),
                                  np.arange(spec.ns))
    # some rejected: each takes a survivor's data, drawn from the
    # generator or injected
    X_mix = X_ok.copy()
    X_mix[1, ::2] = 5e3
    gp4, n_alive = reject_and_resample(spec, env, hyp, gp, X_mix, U_plan,
                                       x_next, np.full(H, 1e3), 1e3, gen)
    src = gp4.hall_Z[:, 0, 0, 0].numpy()
    assert n_alive == spec.ns // 2
    np.testing.assert_array_equal(src[1::2], np.arange(1, spec.ns, 2))
    assert np.all(src[::2] % 2 == 1)
    donors = np.arange(spec.ns)[::-1].copy()            # i -> ns - 1 - i
    gp5, _ = reject_and_resample(spec, env, hyp, gp, X_mix, U_plan, x_next,
                                 np.full(H, 1e3), 1e3, gen, donors=donors)
    np.testing.assert_array_equal(
        gp5.hall_Z[:, 0, 0, 0].numpy(),
        np.where(np.arange(spec.ns) % 2 == 0, donors, np.arange(spec.ns)))
    np.testing.assert_array_equal(gp5.hall_Y.numpy()[::2],
                                  gp.hall_Y.numpy()[donors[::2]])


def test_closed_loop_with_rejection(pend):
    """The closed loop with dynamics_rejection: True completes, records a
    survivor count per step, and still moves toward the goal."""
    params, spec, data, env, _ = pend
    spec = dataclasses.replace(spec, dynamics_rejection=True,
                               num_mpc_iter=4)
    out = DEMPC(params, spec, data, env, device="cpu", dtype=F64).run()
    surv = out["rejection_survivors"]
    assert len(surv) == 4 and all(0 <= n <= spec.ns for n in surv)
    assert max(surv) > 0
    start_err = abs(float(data.start[0]) - float(data.goal[0]))
    assert abs(float(out["final_state"][0]) - float(data.goal[0])) < start_err


def test_f32_fs_rollout_envelope_vs_f64():
    """The float32 rollout of the solved car_residual plan against the
    port's float64 on the same draws (ns=64, T=50)."""
    ns, T = 64, 50
    params, spec, data, env = _fs_problem(tload, tmake_env, ns)
    U = np.load(GOLDEN)["last_plan_U"][:T]
    fb = {"K": data.K_fb, "x_eq": data.goal}
    eps = tagent.truncated_normal((T, ns, spec.g_ny, 1, spec.Ty),
                                  spec.gp.beta,
                                  torch.Generator().manual_seed(11), "cpu",
                                  F64)

    def run(dtype):
        hyp = GPHyperArrays.from_spec(spec.gp, "cpu", dtype)
        gp = tagent.init_gp_state(spec, env, "cpu", dtype, capacity=T,
                                  hyp=hyp)
        X, _ = forward_sample_rollout(spec, env, hyp, gp, data.start, U,
                                      use_feedback=fb, eps=eps.to(dtype))
        return X.double().numpy()

    X64, X32 = run(F64), run(torch.float32)
    assert np.all(np.isfinite(X32)), "f32 rollout must stay bounded"
    assert np.abs(X32 - X64).max() < 0.25
    env64 = np.stack([X64.min(1), X64.max(1)])
    env32 = np.stack([X32.min(1), X32.max(1)])
    assert np.abs(env32 - env64).max() < 0.15


def _f32_envelope_by_width(package, inputs, ns, widths):
    """Float32 vs float64 ``forward_sample_rollout`` of one package on
    ``params_car_residual_fs`` (50 steps, ancillary feedback) on the same
    draws: chip_smoke.py's (the config's seed through the port's sampler).
    Returns the non-finite realizations, the min/max envelope error over
    the first w realizations for each w in ``widths``, and the largest
    per-realization error over the survivors."""
    load, make_env = (jload, jmake_env) if package == "jax" else \
        (tload, tmake_env)
    _, spec, data, env = _fs_problem(load, make_env, ns)
    T = spec.num_mpc_iter
    U = (np.load(GOLDEN)["last_plan_U"][:T] if inputs == "replay"
         else np.zeros((T, spec.nu)))
    eps = tagent.truncated_normal((T, ns, spec.g_ny, 1, spec.Ty),
                                  spec.gp.beta,
                                  torch.Generator().manual_seed(spec.seed),
                                  "cpu", F64).numpy()
    fb = {"K": data.K_fb, "x_eq": data.goal}

    def run(bits):
        if package == "jax":
            dt = jnp.float64 if bits == 64 else jnp.float32
            gp = jagent.init_gp_state(spec, env, dt, capacity=T)
            X, _ = jforward(spec, env, JHyp.from_spec(spec.gp, dt), gp,
                            jnp.asarray(data.start, dt), jnp.asarray(U, dt),
                            jax.random.PRNGKey(0), use_feedback=fb,
                            eps=jnp.asarray(eps, dt))
            return np.asarray(X, np.float64)
        dt = F64 if bits == 64 else torch.float32
        hyp = GPHyperArrays.from_spec(spec.gp, "cpu", dt)
        gp = tagent.init_gp_state(spec, env, "cpu", dt, capacity=T, hyp=hyp)
        X, _ = forward_sample_rollout(spec, env, hyp, gp, data.start, U,
                                      use_feedback=fb,
                                      eps=torch.as_tensor(eps).to(dt))
        return X.double().numpy()

    X64, X32 = run(64), run(32)
    alive = np.isfinite(X32).all((0, 2)) & np.isfinite(X64).all((0, 2))
    env = {}
    for w in widths:
        keep = alive & (np.arange(ns) < w)
        e32 = np.stack([X32[:, keep].min(1), X32[:, keep].max(1)])
        e64 = np.stack([X64[:, keep].min(1), X64[:, keep].max(1)])
        env[w] = float(np.abs(e32 - e64).max())
    return (int((~alive).sum()), env,
            float(np.abs(X32[:, alive] - X64[:, alive]).max()))


@pytest.mark.slow
@pytest.mark.parametrize("inputs", ["replay", "zero"])
def test_f32_envelope_by_width_vs_jax(inputs):
    """The float32 forward-sampling envelope error at the full width
    (ns=4000 x 50, the golden's replayed plan or zero inputs), for the JAX
    package and the port side by side on the same draws (printed; run with
    -s; a few minutes per package).  The reference itself exceeds
    tests/test_f32_envelope.py's 0.15 over 4000 realizations: the extremes
    of a larger sample are its most chaotic realizations.  The port is
    held to tests/test_f32_envelope.py's bars where the reference meets
    them (0.25 per realization, 0.15 over the first 256) and to 1.2 times
    the reference's own reading over all 4000, as chip_smoke.py holds the
    card."""
    ns, widths = 4000, (256, 1000, 4000)
    res = {p: _f32_envelope_by_width(p, inputs, ns, widths)
           for p in ("jax", "torch")}
    for p, (bad, env, per) in res.items():
        print(f"{p} {inputs} ns={ns}: non-finite {bad}; envelope error over "
              f"the first {', '.join(f'{w}: {e:.4f}' for w, e in env.items())}"
              f"; per realization {per:.4f}")
    bad, env, per = res["torch"]
    assert bad <= 1 and per < 0.25 and env[256] < 0.15
    assert env[ns] <= 1.2 * res["jax"][1][ns]
