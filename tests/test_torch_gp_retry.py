"""The GP kernels' covariance factor retried with more jitter
(``ops/gp_sample.py::factor_retried``, ``csrc/common.cuh``
``sgp::factor_retry``), on the CPU.

A float32 posterior covariance that is not positive definite at the first
jitter (a non-positive pivot) is factored again with ten times the jitter
while that stays within max(1e-3 x the mean variance, 1e-2), as
``gp/exact.py::safe_cholesky`` does in float32; before, the kernels and
their plain versions left NaN from the failing column on, and the
non-finite -> mean backstop put those entries of the draw at the mean.

* a covariance with a smallest eigenvalue of -5e-6 fails at the first
  jitter (1e-6) and factors at the second (1e-5): both plain versions,
  every panel width, give the factor of cov + 1e-5 I and draws that follow
  eps, as ``safe_cholesky`` does;
* at ``params_car``'s published GP (Ht = 60, R = 180, noise 7e-9) the
  float32 covariance of the first output fails at the configured jitter
  (1e-6) on every hall stage, and the float32 rounding of each output's
  covariance reaches the configured jitter: its smallest eigenvalue, in
  units of the rows' prior variances, reads down to -1.7e-6.  With each
  row's first jitter at least ``gp_sample.JITTER_REL`` of its prior
  variance the first factor holds on every stage with room to spare, so
  rounding does not decide which jitter a sample is drawn at; no entry of
  a draw sits at the mean, and the draws' spread along the float64
  posterior's principal directions (``hall_var_gap``, perfbench/check.py)
  moves toward float64 against the configured jitter's first factor alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import check
from sampling_gpmpc_torch import agent, bench
from sampling_gpmpc_torch.gp import exact
from sampling_gpmpc_torch.ops import gp_hall, gp_sample

SCAL = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5)
NS, HT, RR, RH, TY = 3, 12, 20, 45, 3
NEG = 5e-6


def _rng_problem(seed, nh):
    """A hall stage from random feature-space covariances, float64 (the
    hall rows past nh masked as empty slots)."""
    rng = np.random.default_rng(seed)
    F = 2 * (RR + RH + HT)
    P_r = rng.normal(size=(RR, F)) / np.sqrt(F)
    P_h = rng.normal(size=(NS, RH, F)) / np.sqrt(F)
    P_t = rng.normal(size=(NS, HT, F)) / np.sqrt(F)
    m = (np.arange(RH) < nh).astype(np.float64)
    Linv = np.linalg.inv(np.linalg.cholesky(P_r @ P_r.T + 1e-3 * np.eye(RR)))
    Ahh = P_h @ np.swapaxes(P_h, 1, 2) + 1e-3 * np.eye(RH)
    kw = dict(
        Kxr=P_t @ P_r.T, Kxh=(P_t @ np.swapaxes(P_h, 1, 2)) * m,
        Ktt=P_t @ np.swapaxes(P_t, 1, 2),
        Arh=np.einsum("rf,shf->srh", P_r, P_h) * m,
        Ahh=m[:, None] * Ahh * m[None, :] + np.diag(1.0 - m),
        yh=rng.normal(size=(NS, RH)) * 0.3 * m,
        eps=np.clip(rng.normal(size=(NS, HT)), -2.5, 2.5), Linv=Linv,
        w_r=Linv @ (rng.normal(size=RR) * 0.3), prior_var=np.full(HT, 1.0))
    return {k: torch.tensor(v) for k, v in kw.items()}


def _indefinite(cov, Ktt):
    """Ktt moved along cov's last principal direction so that the
    covariance it gives has smallest eigenvalue -NEG in every sample."""
    lam, V = torch.linalg.eigh(cov)
    u = V[..., :, 0]
    return Ktt - (lam[..., 0] + NEG)[:, None, None] * (u[..., :, None]
                                                      * u[..., None, :])


FACTOR = ("Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh", "Linv", "w_r")


def _stage(stage, panel, nh=30):
    """(arguments, covariance without jitter, draw(eps)) of a stage whose
    covariance is indefinite by NEG, float64."""
    kw = _rng_problem(seed=7, nh=nh)
    if stage == "empty":
        kw = dict(Kxm=kw["Kxr"], Ktt=kw["Ktt"], eps=kw["eps"],
                  Linv=kw["Linv"], alpha=kw["Linv"].T @ kw["w_r"],
                  prior_var=kw["prior_var"])

        def cov_of(kw):
            V = kw["Linv"] @ kw["Kxm"].transpose(1, 2)
            return kw["Ktt"] - V.transpose(1, 2) @ V

        def draw(eps):
            return gp_sample.sample_empty_plain(**dict(kw, eps=eps), **SCAL,
                                                ty=TY, panel=panel)
    else:
        def cov_of(kw):
            # the last block of the bordered matrix once the hall columns
            # (with the jitter on S) are eliminated, less the jitter
            M = gp_hall.bordered_matrix(nh, **{k: kw[k] for k in FACTOR},
                                        prior_var=kw["prior_var"],
                                        jitter=SCAL["jitter"])
            gp_sample.factor_panels(M, 0, nh, nh + HT + 1, 1)
            cov = M[:, nh:nh + HT, nh:nh + HT] - SCAL["jitter"] * torch.eye(
                HT, dtype=M.dtype)
            return torch.tril(cov) + torch.tril(cov, -1).transpose(1, 2)

        def draw(eps):
            return gp_hall.sample_hall_plain(nh, **dict(kw, eps=eps), **SCAL,
                                             ty=TY, panel=panel)
    kw["Ktt"] = _indefinite(cov_of(kw), kw["Ktt"])
    cov = cov_of(kw)
    return kw, cov, draw


@pytest.mark.parametrize("panel", [1, 8, 32])
@pytest.mark.parametrize("stage", ["empty", "hall"])
def test_failed_covariance_factor_is_retried_with_more_jitter(stage, panel):
    """Smallest eigenvalue -5e-6: the factor fails at the first jitter
    (1e-6) and is the factor of cov + 1e-5 I, as safe_cholesky gives; the
    draws are finite and follow eps in every entry."""
    kw, cov, draw = _stage(stage, panel)
    lam = torch.linalg.eigvalsh(cov)[:, 0]
    np.testing.assert_allclose(lam.numpy(), -NEG, rtol=1e-3)
    eye = torch.eye(HT, dtype=cov.dtype)
    assert bool((torch.linalg.cholesky_ex(cov + 1e-6 * eye).info > 0).all())
    L10 = torch.linalg.cholesky(cov + 1e-5 * eye)
    np.testing.assert_allclose(exact.safe_cholesky(cov, 1e-6).numpy(),
                               L10.numpy(), rtol=0, atol=1e-9)
    if stage == "hall":
        L, _, _ = gp_hall.bordered_factor(30, **{k: kw[k] for k in FACTOR},
                                          prior_var=kw["prior_var"],
                                          jitter=SCAL["jitter"], panel=panel)
        np.testing.assert_allclose(L.numpy(), L10.numpy(), rtol=0,
                                   atol=1e-9)
    dg, mean = draw(kw["eps"]), draw(torch.zeros_like(kw["eps"]))
    assert bool(torch.isfinite(dg).all()) and bool(torch.isfinite(mean).all())
    assert bool(((dg - mean).abs() > 1e-9).all())
    # the first factor alone: NaN from the failing column on, those
    # entries at the mean
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gp_sample, "factor_retried",
                   lambda M, c0, n, *a: gp_sample.factor_panels(
                       M, c0, n, n, panel))
        mp.setattr(gp_hall, "factor_retried",
                   lambda M, c0, n, *a: gp_sample.factor_panels(
                       M, c0, n, n, panel))
        old = draw(kw["eps"])
    assert bool((old == mean).any())


@pytest.fixture(scope="module")
def car_stages():
    """The hall stages of one closed-loop step of params_car as published
    (H = 15: Ht = 60, R = 180) at ns = 4, float32 on the CPU through the
    kernels' plain versions (the card's algorithm): each stage's
    ``gp_hall.sample_hall`` arguments, the blocks that the stage from the
    points (``gp_hall.sample_hall_points``) hands its plain factor."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    seen = []
    orig = gp_hall.sample_hall_plain_stacked
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(agent, "uses_gp_kernels", lambda spec, device: True)
        mp.setattr(gp_hall, "sample_hall_plain_stacked",
                   lambda **kw: seen.append(kw) or orig(**kw))
        _, spec, data, env = bench.build_car(dict(ns=4))
        spec = dataclasses.replace(spec, tol_nlp=0.0)
        loop = bench.ClosedLoop(spec, data, env, "cpu", torch.float32)
        loop.step(bench.draws(spec, 1, 3, "cpu", torch.float32)[0])
    torch.set_num_threads(n)
    assert [kw["nh"] for kw in seen] == [60, 120, 180]
    return spec, seen


def _whitened(dg, kw, ref):
    """Draws dg and the float64 draws ref of one stage, each (no, ns, Ht),
    as z-scores along the float64 posterior's principal directions
    (check.py's ``whitened``)."""
    k64 = {k: (v.double() if torch.is_tensor(v) else v)
           for k, v in kw.items()}
    cov, mean = [], []
    for o in range(dg.shape[0]):
        L, m, _ = gp_hall.bordered_factor(
            kw["nh"], **{k: k64[k][o] for k in FACTOR + ("prior_var",)},
            jitter=kw["jitter"])
        cov.append(L @ L.transpose(1, 2))
        mean.append(m)
    cov, mean = torch.stack(cov, 1), torch.stack(mean, 1)    # (ns, no, ...)
    std = k64["prior_var"].sqrt()[None]                      # (1, no, Ht)
    return check.whitened(dg.double().transpose(0, 1) - mean,
                          ref.transpose(0, 1) - mean, cov, std)


def _var_gap(pairs):
    """check.py's ``hall_var_gap``: |sum z^2 / sum z_ref^2 - 1| pooled
    over the stages' (z, z_ref)."""
    z = torch.cat([p[0] for p in pairs])
    z_ref = torch.cat([p[1] for p in pairs])
    return float(abs((z * z).sum() / (z_ref * z_ref).sum() - 1.0))


def test_car_hall_draws_keep_their_spread_in_float32(car_stages):
    """params_car's hall stages, float32: at the configured jitter alone
    the first output's covariance fails on every stage and its first
    factor leaves most of that output's entries at the mean.  At each
    row's first jitter (``gp_sample.row_jitter``) the first factor holds
    for every sample of every output, so the retry changes nothing; no
    entry sits at the mean, and hall_var_gap against float64, pooled over
    the step's hall stages as check.py pools it, is at least fourfold
    below the configured jitter's first factor alone."""
    _, stages = car_stages
    new, old = [], []
    for kw in stages:
        k64 = {k: (v.double() if torch.is_tensor(v) else v)
               for k, v in kw.items()}
        ref = gp_hall.sample_hall(**k64)
        mean = gp_hall.sample_hall(**dict(kw, eps=torch.zeros_like(
            kw["eps"])))
        dg = gp_hall.sample_hall(**kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gp_hall, "factor_retried",
                       lambda M, c0, n, *a: gp_sample.factor_panels(
                           M, c0, n, n, a[-1]))
            assert torch.equal(gp_hall.sample_hall(**kw), dg)
            mp.setattr(gp_hall, "row_jitter",
                       lambda jitter, pv: torch.full_like(pv, jitter))
            first = gp_hall.sample_hall(**kw)
        assert float((first[0] == mean[0]).double().mean()) > 0.3
        assert not bool((dg == mean).any())
        assert bool(torch.isfinite(dg).all())
        new.append(_whitened(dg, kw, ref))
        old.append(_whitened(first, kw, ref))
    assert _var_gap(new) * 4 < _var_gap(old)


def test_car_row_jitter_clears_the_float32_rounding(car_stages):
    """params_car's hall stages, float32: the covariance each sample's
    factor starts from (the bordered matrix after the hall columns, less
    its jitter), scaled by the rows' prior standard deviations, has a
    smallest eigenvalue (float64) below zero by float32 rounding, down to
    about -1.7e-6, which reaches the configured jitter; the rows' first
    jitter clears it at least threefold, so the first factor's success
    does not rest on rounding."""
    _, stages = car_stages
    worst = 0.0
    for kw in stages:
        nh, Ht = kw["nh"], kw["Ktt"].shape[-1]
        for o in range(kw["Kxr"].shape[0]):
            M = gp_hall.bordered_matrix(
                nh, **{k: kw[k][o] for k in FACTOR + ("prior_var",)},
                jitter=kw["jitter"])
            gp_sample.factor_panels(M, 0, nh, nh + Ht + 1, gp_sample.PANEL)
            jit0 = gp_sample.row_jitter(kw["jitter"], kw["prior_var"][o])
            cov = (M[:, nh:nh + Ht, nh:nh + Ht].double()
                   - torch.diag(jit0.double()))
            cov = torch.tril(cov) + torch.tril(cov, -1).transpose(1, 2)
            d = kw["prior_var"][o].double().rsqrt()
            lam = torch.linalg.eigvalsh(cov * d[:, None] * d[None, :])[:, 0]
            worst = min(worst, float(lam.min()))
            assert bool((jit0 >= gp_sample.JITTER_REL * kw["prior_var"][o])
                        .all())
    assert -1e-5 < worst < -1e-7, worst
    assert 3 * -worst < gp_sample.JITTER_REL
