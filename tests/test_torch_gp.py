"""GP core of the PyTorch port vs the JAX package.

* kernel_matrix, factor_real, predict_real and sample_with_overrides agree
  with their JAX counterparts in float64 on numpy-seeded inputs (1e-9:
  the same closed forms and LAPACK factorizations, so only summation order
  differs);
* the plain version of the fused GP-sample kernel (ops/gp_sample.py)
  agrees with the Pallas kernel run in interpret mode in float32 (the same
  algorithm, so agreement is at float32 rounding of the posterior
  variance), and with the float32 XLA twin by the tube criterion
  |y - mu| <= beta (sigma + sigma_noise);
* the plain version of the hall-block kernels (ops/gp_hall.py) agrees
  with the Pallas hall kernel run in interpret mode on the same inputs,
  which the port's ``hall_stage_inputs`` builds as the JAX package does;
* the GP-sample kernel takes the car shape (Ht=60, R=180) on CUDA.
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
from sampling_gpmpc_tpu.gp import kernel as jkernel
from sampling_gpmpc_tpu.ops import pallas_gp
from sampling_gpmpc_torch import agent as tagent
from sampling_gpmpc_torch import convert
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.envs import make_env as tmake_env
from sampling_gpmpc_torch.gp import exact as texact
from sampling_gpmpc_torch.gp import kernel as tkernel
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ops import build, gp_hall, gp_sample

PARAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "params", "params_pendulum1D_samples.yaml")
F64 = 1e-9
NOISE_REL = 1e-3     # f32 variance-cancellation floor of the tube criterion


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("with_grad", [True, False])
def test_kernel_matrix_matches_jax(with_grad):
    rng = np.random.default_rng(0)
    X, Z = rng.normal(size=(6, 3)), rng.normal(size=(9, 3))
    ls, os_ = rng.uniform(0.5, 2.0, size=3), 0.7
    ref = np.asarray(jkernel.kernel_matrix(jnp.asarray(X), jnp.asarray(Z),
                                           jnp.asarray(ls), os_, with_grad))
    got = tkernel.kernel_matrix(_t(X), _t(Z), _t(ls), os_, with_grad).numpy()
    np.testing.assert_allclose(got, ref, rtol=F64, atol=F64)


@pytest.fixture(scope="module")
def pend():
    """Pendulum1D at ns=8, H=5 on both sides, f64 GP states."""
    over = dict(ns=8, H=5, max_sqp_iter=1, num_mpc_iter=1)
    out = {}
    for side, load, make_env in (("jax", jload, jmake_env),
                                 ("torch", tload, tmake_env)):
        params, spec, data = load(PARAMS)
        spec = dataclasses.replace(spec, **over)
        params["agent"]["num_dyn_samples"] = spec.ns
        params["optimizer"]["H"] = spec.H
        out[side] = (params, spec, make_env(spec, params))
    rng = np.random.default_rng(3)
    H = over["H"]
    Xt = np.stack([np.linspace(2.2, 3.3, H), np.linspace(-1.0, 1.2, H)], -1)
    Xt = Xt[None] + 0.05 * rng.normal(size=(over["ns"], H, 2))
    return out, Xt


def test_factor_and_predict_real_match_jax(pend):
    sides, Xt = pend
    _, jspec, jenv = sides["jax"]
    _, tspec, tenv = sides["torch"]
    jhyp = jexact.GPHyperArrays.from_spec(jspec.gp, jnp.float64)
    thyp = GPHyperArrays.from_spec(tspec.gp, "cpu", torch.float64)
    jgp = jagent.init_gp_state(jspec, jenv, jnp.float64)
    tgp = tagent.init_gp_state(tspec, tenv, "cpu", torch.float64)
    np.testing.assert_allclose(tgp.real_Z.numpy(), np.asarray(jgp.real_Z))
    np.testing.assert_allclose(tgp.real_Y.numpy(), np.asarray(jgp.real_Y))
    for k in ("L", "w", "mask", "Linv", "alpha"):
        np.testing.assert_allclose(tgp.real_fact[k].numpy(),
                                   np.asarray(jgp.real_fact[k]),
                                   rtol=F64, atol=F64, err_msg=k)
    jm, jc = jagent._batched_posterior_real(jspec, jhyp, jgp, jnp.asarray(Xt))
    tm, tc = tagent._batched_posterior_real(tspec, thyp, tgp, _t(Xt))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=F64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=F64)


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(min_data_dist=0.15, variance_is_zero=1.1e-6),
])
def test_sample_with_overrides_matches_jax(overrides):
    """Random posterior moments through both override pipelines, with the
    min-dist and zero-variance overrides on and off."""
    rng = np.random.default_rng(5)
    H, Ty, M, D = 6, 3, 10, 2
    Ht = H * Ty
    Xt = rng.uniform(0, 1, size=(H, D))
    Z = np.concatenate([Xt[:2] + 0.05, rng.uniform(0, 1, size=(M - 2, D))])
    Y = rng.normal(size=(M, Ty))
    Y[4] = np.nan
    A = rng.normal(size=(Ht, Ht)) * 1e-2
    cov = A @ A.T
    cov[:Ty, :] = 0.0        # a point with exactly zero posterior variance
    cov[:, :Ty] = 0.0
    cov[np.arange(Ty), np.arange(Ty)] = 1e-9
    mean = rng.normal(size=Ht)
    eps = np.clip(rng.normal(size=Ht), -2.5, 2.5)
    pv = np.array([0.03, 0.01, 0.008])
    base = dict(jitter=1e-6, beta=2.5, variance_is_zero=-1.0,
                min_data_dist=-1.0)
    base.update(overrides)
    jhyp = jexact.GPHyperArrays(jnp.ones((1, D)), jnp.ones(1),
                                jnp.ones(Ty), **base)
    thyp = GPHyperArrays(torch.ones(1, D), torch.ones(1), torch.ones(Ty),
                         **base)
    ref = jexact.sample_with_overrides(
        jnp.asarray(Xt), jnp.asarray(Z), jnp.asarray(Y), None,
        jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(eps), jhyp, Ty,
        prior_var=jnp.asarray(pv))
    got = texact.sample_with_overrides(
        _t(Xt), _t(Z), _t(Y), _t(mean), _t(cov), _t(eps), thyp, Ty,
        prior_var=_t(pv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F64)
    assert np.all(np.isfinite(got.numpy()))


def _kernel_inputs(pend, j=0):
    """The fused kernel's inputs for one output, built by the JAX side
    (float32, as agent._fused_sample_empty builds them)."""
    sides, Xt = pend
    _, spec, env = sides["jax"]
    f32 = jnp.float32
    hyp = jexact.GPHyperArrays.from_spec(spec.gp, f32)
    gp = jagent.init_gp_state(spec, env, f32, hyp=hyp)
    R = gp.real_fact["mask"].shape[-1]
    Xt = jnp.asarray(Xt, f32)
    ls, os_ = hyp.lengthscale[j], hyp.outputscale[j]
    Kall = jax.vmap(lambda x: jkernel.kernel_matrix(
        x, jnp.concatenate([gp.real_Z, x]), ls, os_, True))(Xt)
    Kxm = Kall[..., :R] * gp.real_fact["mask"][j]
    Ktt = Kall[..., R:]
    eps = jax.random.truncated_normal(
        jax.random.PRNGKey(7), -spec.gp.beta, spec.gp.beta,
        (spec.ns, spec.H * spec.Ty), f32)
    pv = jnp.tile(jexact.prior_task_variances(ls, os_, spec.Ty), spec.H)
    arrays = dict(Kxm=Kxm, Ktt=Ktt, eps=eps, Linv=gp.real_fact["Linv"][j],
                  alpha=gp.real_fact["alpha"][j], prior_var=pv)
    return ({k: np.array(v, np.float32) for k, v in arrays.items()},
            spec, hyp, gp)


@pytest.mark.parametrize("overrides", ["none", "min_dist_var_zero"])
def test_plain_gp_sample_matches_pallas_interpret(pend, monkeypatch,
                                                  overrides):
    arrs, spec, hyp, _ = _kernel_inputs(pend)
    kw = dict(jitter=max(hyp.jitter, 1e-6), beta=hyp.beta,
              var_zero=hyp.variance_is_zero, rel_floor=1e-5, ty=spec.Ty)
    ns, Ht = arrs["eps"].shape
    if overrides != "none":
        rng = np.random.default_rng(11)
        kw["var_zero"] = 1.1e-6
        kw["close"] = (rng.uniform(size=(ns, Ht)) < 0.2).astype(np.float32)
        kw["ynear"] = rng.normal(size=(ns, Ht)).astype(np.float32) * 1e-3
    monkeypatch.setattr(pallas_gp, "_INTERPRET", True)
    ref = np.asarray(pallas_gp.sample_empty_one(
        **{k: jnp.asarray(v) for k, v in arrs.items()},
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}))
    def plain(dtype):
        return gp_sample.sample_empty_one(
            **{k: torch.tensor(v, dtype=dtype) for k, v in arrs.items()},
            **{k: (torch.tensor(v, dtype=dtype) if isinstance(v, np.ndarray)
                   else v) for k, v in kw.items()}).numpy()

    got, exact64 = plain(torch.float32), plain(torch.float64)
    assert np.all(np.isfinite(got))
    # The same algorithm on the same float32 inputs.  Posterior variances
    # here are 1e-4..3e-3 of the prior, so Ktt - V'V cancels 3-4 of f32's
    # 7 digits: each f32 evaluation sits ~2e-3*scale from the float64
    # evaluation of the algorithm (measured 2.2e-3 Pallas, 1.5e-3 plain).
    scale = float(np.max(np.abs(exact64)))
    np.testing.assert_allclose(ref, exact64, atol=3e-3 * scale)
    np.testing.assert_allclose(got, exact64, atol=3e-3 * scale)
    np.testing.assert_allclose(got, ref, atol=4e-3 * scale)


def test_plain_gp_sample_within_tube_of_xla_twin(pend):
    """Kernel algorithm (Linv matmuls, no jitter retry) vs the f32 twin's
    posterior: every sample inside mu ± beta (sigma + sigma_noise)."""
    arrs, spec, hyp, gp = _kernel_inputs(pend)
    got = gp_sample.sample_empty_one(
        **{k: torch.as_tensor(v) for k, v in arrs.items()},
        jitter=max(hyp.jitter, 1e-6), beta=hyp.beta,
        var_zero=hyp.variance_is_zero, rel_floor=1e-5, ty=spec.Ty).numpy()
    _, Xt = pend
    mean, cov = jagent._batched_posterior_real(
        spec, hyp, gp, jnp.asarray(Xt, jnp.float32))
    mu = np.asarray(mean)[:, 0]
    var = np.clip(np.asarray(jnp.diagonal(cov, axis1=-2, axis2=-1))[:, 0],
                  0, None)
    sigma_n = np.sqrt(NOISE_REL * arrs["prior_var"])
    viol = np.abs(got - mu) - hyp.beta * (np.sqrt(var) + sigma_n)
    assert viol.max() <= 0.0, viol.max()


def test_sample_dynamics_iteration0_matches_jax(pend):
    """The whole iteration-0 GP stage (posterior, draw, overrides,
    hallucination append) in float64 on both sides."""
    sides, Xt = pend
    _, jspec, jenv = sides["jax"]
    _, tspec, tenv = sides["torch"]
    jhyp = jexact.GPHyperArrays.from_spec(jspec.gp, jnp.float64)
    thyp = GPHyperArrays.from_spec(tspec.gp, "cpu", torch.float64)
    # capacity for two appends: the second call conditions on the first's
    jgp = jagent.init_gp_state(jspec, jenv, jnp.float64,
                               capacity=2 * jspec.H)
    # the JAX state carried across, so the stage is held in isolation
    tgp = convert.gp_state(jgp.real_Z, jgp.real_Y,
                           {k: np.asarray(v) for k, v in jgp.real_fact.items()},
                           jgp.hall_Z, jgp.hall_Y, jgp.hall_n, "cpu",
                           torch.float64)
    thyp = convert.hyper(jhyp.lengthscale, jhyp.outputscale, jhyp.noise_diag,
                         jhyp.jitter, jhyp.beta, jhyp.variance_is_zero,
                         jhyp.min_data_dist, "cpu", torch.float64)
    eps = np.clip(np.random.default_rng(2).normal(
        size=(jspec.ns, jspec.g_ny, jspec.H, jspec.Ty)), -2.5, 2.5)
    jdg, jgp1 = jagent.sample_dynamics(jspec, jenv, jhyp, jgp,
                                       jnp.asarray(Xt), jnp.asarray(eps),
                                       hall_empty=True)
    tdg, tgp1 = tagent.sample_dynamics(tspec, tenv, thyp, tgp, _t(Xt),
                                       _t(eps), hall_empty=True)
    np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), atol=F64)
    assert tgp1.hall_n == int(jgp1.hall_n)
    np.testing.assert_allclose(tgp1.hall_Z.numpy(), np.asarray(jgp1.hall_Z))
    np.testing.assert_allclose(tgp1.hall_Y.numpy(), np.asarray(jgp1.hall_Y),
                               atol=F64)
    # the second call conditions on the filled buffer: it is JAX's hall
    # stage, and its draw moves away from the real-data-only draw
    Xt2 = Xt + 0.02
    jdg2, jgp2 = jagent.sample_dynamics(jspec, jenv, jhyp, jgp1,
                                        jnp.asarray(Xt2), jnp.asarray(eps))
    tdg2, tgp2 = tagent.sample_dynamics(tspec, tenv, thyp, tgp1, _t(Xt2),
                                        _t(eps))
    tdg_real, _ = tagent.sample_dynamics(tspec, tenv, thyp, tgp, _t(Xt2),
                                         _t(eps), hall_empty=True)
    np.testing.assert_allclose(tdg2.numpy(), np.asarray(jdg2), atol=1e-8)
    assert tgp2.hall_n == int(jgp2.hall_n) == 2 * jspec.H
    assert float(torch.max(torch.abs(tdg2 - tdg_real))) > 1e-6


def test_gp_sample_takes_the_car_shape():
    """The car's iteration-0 stage (Ht=60 test rows, R=180 train rows) fits
    one CTA: Linv stays in global memory, so shared memory grows with
    Ht*R (about 103 KB here) and not with R*R."""
    assert gp_sample.smem_bytes(60, 180) <= build.SMEM_MAX
    gp_sample.check_supported(60, 180, torch.float32)
    gp_sample.check_supported(51, 108, torch.float32)      # flagship


@pytest.fixture(scope="module")
def pend_hall():
    """Pendulum1D at ns=8, H=12 (tests/test_pallas_gp.py's shape) in
    float32 on the JAX side: the GP state after an iteration-0 append
    (hall_n = H of a 2H capacity), a perturbed iterate and fresh draws."""
    params, spec, _ = jload(PARAMS)
    spec = dataclasses.replace(spec, ns=8, H=12, max_sqp_iter=2,
                               num_mpc_iter=1)
    params["agent"]["num_dyn_samples"] = spec.ns
    params["optimizer"]["H"] = spec.H
    env = jmake_env(spec, params)
    f32 = jnp.float32
    hyp = jexact.GPHyperArrays.from_spec(spec.gp, f32)
    gp = jagent.init_gp_state(spec, env, f32, hyp=hyp)
    rng = np.random.default_rng(9)
    Xt = np.stack([np.linspace(2.2, 3.3, spec.H),
                   np.linspace(-1.0, 1.2, spec.H)], -1)
    Xt = (Xt[None] + 0.05 * rng.normal(size=(spec.ns, spec.H, 2))
          ).astype(np.float32)
    eps0, eps1 = (np.clip(rng.normal(size=(spec.ns, 1, spec.H, spec.Ty)),
                          -2.5, 2.5).astype(np.float32) for _ in range(2))
    _, gp = jagent.sample_dynamics(spec, env, hyp, gp, jnp.asarray(Xt),
                                   jnp.asarray(eps0), hall_empty=True)
    assert int(gp.hall_n) == spec.H and gp.hall_Z.shape[2] == 2 * spec.H
    Xt1 = (Xt + 0.03 * rng.normal(size=Xt.shape)).astype(np.float32)
    return spec, hyp, gp, Xt1, eps1


def _jax_hall_inputs(spec, hyp, gp, Xt, j=0):
    """The hall kernel's blocks for output j, as agent._fused_sample_hall
    builds them on the JAX side."""
    Ty, ns = spec.Ty, spec.ns
    Rr = gp.real_fact["mask"].shape[-1]
    Mh = gp.hall_Z.shape[2]
    Rh = Mh * Ty
    ls, os_ = hyp.lengthscale[j], hyp.outputscale[j]
    m_r = gp.real_fact["mask"][j]
    Zh = gp.hall_Z[:, j]
    yh_flat = gp.hall_Y[:, j].reshape(ns, Rh)
    m_h = (~jnp.isnan(yh_flat)).astype(jnp.float32)
    ev1 = jax.vmap(lambda z: jkernel.kernel_matrix(
        jnp.concatenate([gp.real_Z, z]), z, ls, os_, True))(Zh)
    Khh = ev1[:, Rr:] + jnp.diag(jnp.tile(hyp.noise_diag, Mh))[None]
    ev2 = jax.vmap(lambda x, z: jkernel.kernel_matrix(
        x, jnp.concatenate([gp.real_Z, z, x]), ls, os_, True))(Xt, Zh)
    arrs = dict(
        Kxr=ev2[..., :Rr] * m_r, Kxh=ev2[..., Rr:Rr + Rh] * m_h[:, None, :],
        Ktt=ev2[..., Rr + Rh:],
        Arh=ev1[:, :Rr] * m_r[None, :, None] * m_h[:, None, :],
        Ahh=(m_h[:, :, None] * Khh * m_h[:, None, :]
             + jnp.eye(Rh)[None] * (1.0 - m_h)[:, None, :]),
        yh=jnp.nan_to_num(yh_flat) * m_h, Linv=gp.real_fact["Linv"][j],
        w_r=gp.real_fact["w"][j],
        prior_var=jnp.tile(jexact.prior_task_variances(ls, os_, Ty), spec.H))
    return {k: np.array(v, np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("overrides", ["none", "min_dist_var_zero"])
def test_plain_gp_hall_matches_pallas_interpret(pend_hall, monkeypatch,
                                                overrides):
    spec, hyp, gp, Xt, eps = pend_hall
    ref_in = _jax_hall_inputs(spec, hyp, gp, jnp.asarray(Xt))
    # the port builds the same blocks from the carried-across state
    thyp, tgp = (convert.hyper(hyp.lengthscale, hyp.outputscale,
                               hyp.noise_diag, hyp.jitter, hyp.beta,
                               hyp.variance_is_zero, hyp.min_data_dist,
                               "cpu", torch.float32),
                 convert.gp_state(gp.real_Z, gp.real_Y,
                                  {k: np.asarray(v)
                                   for k, v in gp.real_fact.items()},
                                  gp.hall_Z, gp.hall_Y, gp.hall_n, "cpu",
                                  torch.float32))
    kw = tagent.hall_stage_inputs(spec, thyp, tgp, torch.as_tensor(Xt),
                                  torch.as_tensor(eps), 0)
    for k, v in ref_in.items():
        np.testing.assert_allclose(kw[k].numpy(), v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert kw["nh"] == spec.H * spec.Ty
    arrs = dict(ref_in, eps=eps[:, 0].reshape(spec.ns, -1))
    scal = dict(jitter=kw["jitter"], beta=kw["beta"],
                var_zero=kw["var_zero"], rel_floor=kw["rel_floor"],
                ty=kw["ty"])
    ns, Ht = arrs["eps"].shape
    if overrides != "none":
        rng = np.random.default_rng(12)
        scal["var_zero"] = 1.1e-6
        arrs["close"] = (rng.uniform(size=(ns, Ht)) < 0.2).astype(np.float32)
        arrs["ynear"] = rng.normal(size=(ns, Ht)).astype(np.float32) * 1e-3
    monkeypatch.setattr(pallas_gp, "_INTERPRET", True)
    ref = np.asarray(pallas_gp.sample_hall_one(
        kw["nh"], **{k: jnp.asarray(v) for k, v in arrs.items()}, **scal))

    def plain(dtype):
        return gp_hall.sample_hall_one(
            kw["nh"], **{k: torch.tensor(v, dtype=dtype)
                         for k, v in arrs.items()}, **scal).numpy()

    got, exact64 = plain(torch.float32), plain(torch.float64)
    assert np.all(np.isfinite(got))
    # The same algorithm on the same float32 inputs; each float32
    # evaluation sits within float32 cancellation of the posterior
    # variance from the float64 evaluation of the algorithm.
    scale = float(np.max(np.abs(exact64)))
    np.testing.assert_allclose(ref, exact64, atol=3e-3 * scale)
    np.testing.assert_allclose(got, exact64, atol=3e-3 * scale)
    np.testing.assert_allclose(got, ref, atol=4e-3 * scale)
