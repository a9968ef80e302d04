"""The port's CUDA kernels against their plain torch versions, on the GPU.

Marked ``cuda``: on a host without an NVIDIA GPU every test skips.  Run on
the GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest configures JAX, which the GPU
machine does not have; this file imports only the port.)

(chip_smoke.py runs the same comparisons at the shapes of the main paths.)
"""

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch.ocp import qp as qp_mod
from sampling_gpmpc_torch.ocp.assemble import (assemble_iteration,
                                               condensed_qp, row_counts)
from sampling_gpmpc_torch.ops import (batch_linalg, batched_chol, glue,
                                      gp_hall, gp_sample, ipm, routes)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from sampling_gpmpc_torch import setup
    return setup.resolve_device("cuda")


def _empty_problem(ns, Ht, R, seed):
    """An empty-hall stage from random feature-space covariances (K = Phi
    Phi' / F, F > R + Ht), so every posterior block is a true covariance."""
    rng = np.random.default_rng(seed)
    F = R + Ht + 16
    P_tr = rng.normal(size=(R, F)) / np.sqrt(F)
    P_te = rng.normal(size=(ns, Ht, F)) / np.sqrt(F)
    L = np.linalg.cholesky(P_tr @ P_tr.T + 1e-6 * np.eye(R))
    return dict(Kxm=P_te @ P_tr.T, Ktt=P_te @ np.swapaxes(P_te, 1, 2),
                eps=np.clip(rng.normal(size=(ns, Ht)), -2.5, 2.5),
                Linv=np.linalg.inv(L), alpha=rng.normal(size=R) * 0.1,
                prior_var=np.full(Ht, 1.0))


@pytest.mark.parametrize("ns,H,ty,R", [(8, 5, 3, 36), (70, 17, 3, 108),
                                       (20, 15, 4, 180)])
def test_gp_sample_kernel_matches_plain(dev, ns, H, ty, R):
    """Random feature-space covariances, float32 rounding only (2e-4
    relative)."""
    Ht = H * ty
    kw = _empty_problem(ns, Ht, R, seed=ns)
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev).contiguous()
         for k, v in kw.items()}
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    got = gp_sample.sample_empty_one(**t, **args)
    ref = gp_sample.sample_empty_plain(**t, **args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-4 * scale)


@pytest.mark.parametrize("no,ns,Ht,R,glob", [
    (3, 20, 60, 180, 0),    # the car, all outputs in one launch
    (1, 70, 51, 108, 0),    # the 1D pendulum
    (2, 20, 120, 180, 0),   # the 2D pendulum (the earlier layout refused it)
    (2, 500, 4, 180, 0),    # params_pendulum_samples (H = 1)
    (1, 50, 3, 135, 0),     # params_pendulum1D_invariant (H = 1)
    (1, 3, 200, 150, 1),    # Ktt_i's tiles in the global workspace
    (1, 3, 300, 200, 2),    # the covariance tiles too
    (1, 2, 800, 100, 3),    # and the V' block
])
def test_gp_sample_stacked_matches_plain(dev, no, ns, Ht, R, glob):
    """Every output in one launch against the plain version of each
    output (2e-4 relative) and against its own one-output call; the larger
    Ht run the branches whose last ``glob`` regions sit in the global
    workspace."""
    probs = [_empty_problem(ns, Ht, R, seed=200 + o) for o in range(no)]
    t = [{k: torch.as_tensor(v, dtype=torch.float32, device=dev)
          .contiguous() for k, v in kw.items()} for kw in probs]
    stacked = {k: torch.stack([kw[k] for kw in t]) for k in t[0]}
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=4)
    if Ht % 4:
        args["ty"] = 1
    got = gp_sample.sample_empty(**stacked, **args)
    assert got.shape == (no, ns, Ht)
    assert gp_sample.sample_layout(Ht)[2] == (False,) * (4 - glob) + (
        True,) * glob
    for o in range(no):
        ref = gp_sample.sample_empty_plain(**t[o], **args)
        one = gp_sample.sample_empty_one(**t[o], **args)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got[o]).all())
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got[o].cpu().numpy(), ref.cpu().numpy(),
                                   atol=2e-4 * scale)
        assert torch.equal(one, got[o])


def _hall_problem(ns, Ht, Rr, Rh, nh, seed):
    """A hall-block stage from random feature-space covariances (every
    block a true covariance, F = 2 (Rr + Rh + Ht) features), with the hall
    rows past the fill masked as the agent masks empty slots: zero
    couplings, identity diagonal, zero targets."""
    rng = np.random.default_rng(seed)
    F = 2 * (Rr + Rh + Ht)
    P_r = rng.normal(size=(Rr, F)) / np.sqrt(F)
    P_h = rng.normal(size=(ns, Rh, F)) / np.sqrt(F)
    P_t = rng.normal(size=(ns, Ht, F)) / np.sqrt(F)
    m = (np.arange(Rh) < nh).astype(np.float64)
    L = np.linalg.cholesky(P_r @ P_r.T + 1e-3 * np.eye(Rr))
    Linv = np.linalg.inv(L)
    y_r = rng.normal(size=Rr) * 0.3
    Ahh = P_h @ np.swapaxes(P_h, 1, 2) + 1e-3 * np.eye(Rh)
    Ahh = m[:, None] * Ahh * m[None, :] + np.diag(1.0 - m)
    return dict(
        Kxr=P_t @ P_r.T, Kxh=(P_t @ np.swapaxes(P_h, 1, 2)) * m,
        Ktt=P_t @ np.swapaxes(P_t, 1, 2),
        Arh=np.einsum("rf,shf->srh", P_r, P_h) * m, Ahh=Ahh,
        yh=rng.normal(size=(ns, Rh)) * 0.3 * m,
        eps=np.clip(rng.normal(size=(ns, Ht)), -2.5, 2.5), Linv=Linv,
        w_r=Linv @ y_r, prior_var=np.full(Ht, 1.0))


@pytest.mark.parametrize("ns,H,ty,Rr,Rh,nh", [
    (8, 5, 3, 36, 45, 30),          # small, partly filled
    (20, 15, 4, 180, 240, 180),     # the car at its largest fill
    (50, 1, 3, 135, 9, 3),          # params_pendulum1D_invariant (Ht = 3),
    (50, 1, 3, 135, 9, 6),          #   SQP iterations 1 and 2
])
def test_gp_hall_kernel_matches_plain(dev, ns, H, ty, Rr, Rh, nh):
    """The kernels against the plain version on the same float32 inputs:
    the kernel may be no farther from the float64 evaluation of the
    algorithm than four times the plain float32 evaluation (both cancel the
    same posterior variances in float32), and it must follow eps."""
    Ht = H * ty
    kw = _hall_problem(ns, Ht, Rr, Rh, nh, seed=ns)
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    t = lambda dtype: {k: torch.as_tensor(v, dtype=dtype, device=dev)
                       .contiguous() for k, v in kw.items()}
    t32 = t(torch.float32)
    got = gp_hall.sample_hall_one(nh, **t32, **args)
    ref = gp_hall.sample_hall_plain(nh, **t32, **args)
    ex = gp_hall.sample_hall_plain(nh, **t(torch.float64), **args)
    mean = gp_hall.sample_hall_plain(
        nh, **dict(t32, eps=torch.zeros_like(t32["eps"])), **args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(ex.abs().max())
    err_k = float((got.double() - ex).abs().max())
    err_p = float((ref.double() - ex).abs().max())
    assert err_k <= 4 * err_p + 1e-6 * scale, (err_k, err_p)
    assert float((got - mean).abs().max()) > 100 * (err_k + 1e-7 * scale)


def _indefinite_by(kw, stage, neg, nh=0):
    """The stage's Ktt moved along its covariance's last principal
    direction so that the covariance (float64, without jitter) has
    smallest eigenvalue -neg in every sample."""
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in kw.items()}
    if stage == "empty":
        V = t["Linv"] @ t["Kxm"].transpose(1, 2)
        cov = t["Ktt"] - V.transpose(1, 2) @ V
    else:
        Ht = t["Ktt"].shape[-1]
        M = gp_hall.bordered_matrix(nh, *(t[k] for k in (
            "Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh", "Linv", "w_r",
            "prior_var")), jitter=1e-6)
        gp_sample.factor_panels(M, 0, nh, nh + Ht + 1, 32)
        cov = M[:, nh:nh + Ht, nh:nh + Ht] - 1e-6 * torch.eye(
            Ht, dtype=M.dtype)
        cov = torch.tril(cov) + torch.tril(cov, -1).transpose(1, 2)
    lam, V = torch.linalg.eigh(cov)
    u = V[..., :, 0]
    move = (lam[..., 0] + neg)[:, None, None] * u[..., :, None] * u[..., None, :]
    return dict(kw, Ktt=kw["Ktt"] - move.numpy())


@pytest.mark.parametrize("stage", ["empty", "hall"])
def test_gp_kernels_retry_a_failed_covariance_factor(dev, stage):
    """At the car's shape (ns = 20, Ht = 60, R = 180; the hall stage at nh
    = 180), covariances whose smallest eigenvalue is -3e-5 fail at the
    first jitter (1e-5 on every row: gp_sample.JITTER_REL times the rows'
    prior variance 1): the kernels factor them again at 1e-4, as the plain
    versions do (2e-4 relative), and every entry of every draw follows eps
    (none fell back to the mean)."""
    ns, Ht, ty, nh = 20, 60, 4, 180
    if stage == "empty":
        kw = _indefinite_by(_empty_problem(ns, Ht, 180, seed=31), stage,
                            3e-5)
        run = lambda **t: gp_sample.sample_empty_one(**t, **args)  # noqa
        plain = lambda **t: gp_sample.sample_empty_plain(**t, **args)  # noqa
    else:
        kw = _indefinite_by(_hall_problem(ns, Ht, 180, 240, nh, seed=31),
                            stage, 3e-5, nh)
        run = lambda **t: gp_hall.sample_hall_one(nh, **t, **args)  # noqa
        plain = lambda **t: gp_hall.sample_hall_plain(nh, **t, **args)  # noqa
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev).contiguous()
         for k, v in kw.items()}
    got, ref = run(**t), plain(**t)
    mean = run(**dict(t, eps=torch.zeros_like(t["eps"])))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(mean).all())
    assert not bool((got == mean).any())
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-4 * scale)


@pytest.mark.parametrize("nh", [120, 240, 360])
def test_gp_hall_pendulum_shape_matches_plain(dev, nh):
    """The 2D pendulum's stage (ns = 20, Ht = 120, Rr = 180, Rh = 360) at
    fills the earlier design refused: 240 and 360 on the global-tile
    branch, 120 on the shared one; by the one-output test's criterion."""
    ns, Ht, ty, Rr, Rh = 20, 120, 4, 180, 360
    assert gp_hall.factor_tiles_global(Ht, nh) == (nh >= 240)
    kw = _hall_problem(ns, Ht, Rr, Rh, nh, seed=nh)
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    t = lambda dtype: {k: torch.as_tensor(v, dtype=dtype, device=dev)
                       .contiguous() for k, v in kw.items()}
    t32 = t(torch.float32)
    got = gp_hall.sample_hall_one(nh, **t32, **args)
    ref = gp_hall.sample_hall_plain(nh, **t32, **args)
    ex = gp_hall.sample_hall_plain(nh, **t(torch.float64), **args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(ex.abs().max())
    err_k = float((got.double() - ex).abs().max())
    err_p = float((ref.double() - ex).abs().max())
    assert err_k <= 4 * err_p + 1e-6 * scale, (err_k, err_p)


def _draw64(kw, nh, add, ty, args):
    """Float64 draws mean + chol(cov + add I) eps through the override tail,
    with mean and cov from the hall columns' elimination (jitter 1e-6 on
    S and on cov's rows, taken off cov again)."""
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in kw.items()}
    Ht = t["Ktt"].shape[-1]
    M = gp_hall.bordered_matrix(nh, *(t[k] for k in (
        "Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh", "Linv", "w_r",
        "prior_var")), jitter=1e-6)
    gp_sample.factor_panels(M, 0, nh, nh + Ht + 1, 32)
    mean = -M[:, nh + Ht, nh:nh + Ht]
    cov = M[:, nh:nh + Ht, nh:nh + Ht] - 1e-6 * torch.eye(Ht,
                                                          dtype=M.dtype)
    cov = torch.tril(cov) + torch.tril(cov, -1).transpose(1, 2)
    L = torch.linalg.cholesky(cov + add * torch.eye(Ht, dtype=M.dtype))
    y = mean + (L @ t["eps"][..., None])[..., 0]
    return gp_sample.override_tail(
        mean, y, torch.diagonal(cov, 0, 1, 2), t["prior_var"], args["beta"],
        args["var_zero"], args["rel_floor"], ty)


def test_gp_hall_global_tiles_retry_a_failed_covariance_factor(dev):
    """The global-tile branch's retry (ns = 4, Ht = 60, Rr = 60, nh = Rh =
    240: the tiles past shared memory), on covariances whose smallest
    eigenvalue is -5e-6, with prior variance 0.1 on every row so that the
    float32 first jitter is the configured 1e-6: the factor fails there and
    is the factor of cov + 1e-5 I, as in float64.  The draws are those of
    cov + 1e-5 I: within four times the plain float32 version's distance
    of the float64 ones (which are them to 1e-9), and within a quarter of
    the distance between the draws at 1e-5 and at 1e-4; finite, none at
    the mean."""
    ns, Ht, ty, Rr, nh = 4, 60, 4, 60, 240
    assert gp_hall.factor_tiles_global(Ht, nh)
    kw = dict(_hall_problem(ns, Ht, Rr, nh, nh, seed=37),
              prior_var=np.full(Ht, 0.1))
    kw = _indefinite_by(kw, "hall", 5e-6, nh)
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    t = lambda dtype: {k: torch.as_tensor(v, dtype=dtype, device=dev)
                       .contiguous() for k, v in kw.items()}
    t32 = t(torch.float32)
    got = gp_hall.sample_hall_one(nh, **t32, **args)
    ref = gp_hall.sample_hall_plain(nh, **t32, **args)
    ex = gp_hall.sample_hall_plain(nh, **t(torch.float64), **args).cpu()
    mean = gp_hall.sample_hall_one(
        nh, **dict(t32, eps=torch.zeros_like(t32["eps"])), **args)
    torch.cuda.synchronize()
    at5, at4 = (_draw64(kw, nh, add, ty, args) for add in (1e-5, 1e-4))
    scale = float(ex.abs().max())
    assert float((ex - at5).abs().max()) <= 1e-9 * scale
    assert bool(torch.isfinite(got).all()) and not bool((got == mean).any())
    err_k = float((got.double().cpu() - ex).abs().max())
    err_p = float((ref.double().cpu() - ex).abs().max())
    assert err_k <= 4 * err_p + 1e-6 * scale, (err_k, err_p)
    assert err_k <= 0.25 * float((at4 - at5).abs().max())


def test_gp_hall_car_samples_stages_match_plain(dev):
    """params_car_samples' hall stages (Ht = 400, Rr = 448, 3 outputs x ns
    = 10, fills 400 / 800 / 1200) through the entry from the points, the
    factor's hall columns in panel steps over every (output, sample) at
    once: no farther from the float64 plain version than four times the
    float32 plain version, as the 2D pendulum's global fills; following
    eps; each stage's panel steps counted from the shapes."""
    fills = []
    for spec, _, _, _, _, kw in _hall_point_stages(
            dev, "params_car_samples", 10, 4):
        nh, Ht = kw["nh"], spec.H * spec.Ty
        assert gp_hall.factor_tiles_global(Ht, nh)
        routes.zero_launch_counts()
        got = gp_hall.sample_hall_points(**kw)
        n = routes.launch_counts()
        ref = gp_hall.sample_hall_points_plain(**kw)
        ex = gp_hall.sample_hall_points_plain(
            **{k: v.double() if torch.is_tensor(v) else v
               for k, v in kw.items()})
        mean = gp_hall.sample_hall_points(
            **dict(kw, eps=torch.zeros_like(kw["eps"])))
        torch.cuda.synchronize()
        assert (n["gp_hall_global"], n["gp_hall_panels"]) == (
            1, gp_hall.hall_panels(Ht, nh))
        assert bool(torch.isfinite(got).all())
        scale = float(ex.abs().max())
        err_k = float((got.double() - ex).abs().max())
        err_p = float((ref.double() - ex).abs().max())
        assert err_k <= 4 * err_p + 1e-6 * scale, (nh, err_k, err_p)
        assert not torch.equal(got, mean)
        fills.append(nh)
    assert fills == [400, 800, 1200]


@pytest.mark.parametrize("nh", [0, 45, 180])
def test_gp_hall_stacked_outputs_match_plain(dev, nh):
    """Three outputs at the car shape in one launch set (the agent's call)
    against the plain version of each output, by the same criterion as the
    one-output test; and each output equal to its own one-output call."""
    ns, Ht, ty, Rr, Rh = 20, 60, 4, 180, 240
    probs = [_hall_problem(ns, Ht, Rr, Rh, nh, seed=100 + o) for o in range(3)]
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    t = lambda kw, dtype: {k: torch.as_tensor(v, dtype=dtype, device=dev)
                           .contiguous() for k, v in kw.items()}
    t32 = [t(kw, torch.float32) for kw in probs]
    stacked = {k: torch.stack([kw[k] for kw in t32]) for k in t32[0]}
    got = gp_hall.sample_hall(nh, **stacked, **args)
    assert got.shape == (3, ns, Ht)
    for o in range(3):
        ref = gp_hall.sample_hall_plain(nh, **t32[o], **args)
        ex = gp_hall.sample_hall_plain(nh, **t(probs[o], torch.float64),
                                       **args)
        one = gp_hall.sample_hall_one(nh, **t32[o], **args)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got[o]).all())
        scale = float(ex.abs().max())
        err_k = float((got[o].double() - ex).abs().max())
        err_p = float((ref.double() - ex).abs().max())
        assert err_k <= 4 * err_p + 1e-6 * scale, (o, err_k, err_p)
        np.testing.assert_allclose(one.cpu().numpy(), got[o].cpu().numpy(),
                                   rtol=0, atol=1e-6 * scale)


def _mehrotra_vs_f64(dev, nU, mh, ms, resident):
    """The loop kernel and the plain loop on the same prepared seeded QP,
    both held to the float64 solution: the kernel no farther from it than
    twice the plain float32 loop plus 1e-3 of its scale (chip_smoke.py's
    bar), both within the status tolerance."""
    args = ipm.seeded_qp(nU, mh, ms, 3, dev)
    assert ipm.loop_layout(nU, mh, ms).resident == resident
    d = ipm.prepare(*args, None, None)
    consts = (qp_mod.STALL_ITERS, qp_mod.STALL_RTOL, qp_mod.MU_GRIND)
    bk, rk, _ = ipm.mehrotra(d, 3e-5, 1e-7, 150, *consts)
    h, s = d.h0, d.s0
    st = (torch.zeros_like(d.g), s[2], s[3], h[0], h[1], s[0], s[4], s[1],
          s[5], s[6], s[7])
    p = ipm.Prepared(d.H, d.g, d.Gth.T, d.dh[0], d.Gts.T, *d.sd[:6], d.qs[0],
                     st, d.sch, d.scs)
    bp, rp, _ = ipm.mehrotra_plain(p, 3e-5, 1e-7, 150, *consts)
    ex = qp_mod._finish(*ipm.run_full_plain(
        *[a.double() for a in args], None, None, 1e-12, 1e-13, 150, *consts,
        qp_mod.WS_BAND), 1e-12)
    torch.cuda.synchronize()
    assert int(ex.status) == 0
    assert float(rk) <= 3e-5 * qp_mod.STATUS_RTOL
    assert float(rp) <= 3e-5 * qp_mod.STATUS_RTOL
    err_k = float((bk[0].double() - ex.z).abs().max())
    err_p = float((bp[0].double() - ex.z).abs().max())
    scale = 1.0 + float(ex.z.abs().max())
    assert err_k <= 2.0 * err_p + 1e-3 * scale, (err_k, err_p)


@pytest.mark.parametrize("nU,mh,ms", [
    (20, 52000, 512),    # the pendulum's width at ns=512, one-warp factor
    (64, 30000, 1000),   # block-wide factor
    (128, 20000, 1000),  # the widest Schur matrix, 33 pairs a thread
])
def test_ipm_mehrotra_streamed_slices_match_plain(dev, nU, mh, ms):
    """QPs too wide for their G slices to stay in shared memory: the loop
    kernel reads them from global memory."""
    _mehrotra_vs_f64(dev, nU, mh, ms, resident=False)


@pytest.mark.parametrize("nU,mh,ms", [(64, 4000, 400), (128, 1500, 200)])
def test_ipm_mehrotra_wide_schur_resident_matches_plain(dev, nU, mh, ms):
    """Schur matrices past the closed loops' (nU > 38: the kernel build of
    33 Schur pairs a thread, the block-wide factor) with the G slices in
    shared memory."""
    _mehrotra_vs_f64(dev, nU, mh, ms, resident=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ipm_kernels_match_plain(dev, seed):
    """The test_pallas_ipm problem family, cold and warm, float32."""
    rng = np.random.default_rng(seed)
    nU, mh, ms = 12, 384, 64
    Hh = rng.normal(size=(nU, nU))
    prob = [Hh @ Hh.T + np.eye(nU), rng.normal(size=nU) * 3,
            rng.normal(size=(mh, nU)), rng.uniform(0.1, 1.5, size=mh),
            rng.normal(size=(ms, nU)), rng.uniform(-0.5, -0.1, size=ms),
            rng.uniform(0.05, 2.0, size=ms), np.full(ms, 3.0),
            np.full(ms, 2.0), np.full(ms, 5.0), np.full(ms, 4.0)]
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
            for a in prob]
    ipm.check_supported(nU, mh, ms, torch.float32)
    cold = qp_mod.solve_qp_soft(*args)
    kw = (3e-5, 1e-7, 150, qp_mod.STALL_ITERS, qp_mod.STALL_RTOL,
          qp_mod.MU_GRIND, qp_mod.WS_BAND)
    plain = qp_mod._finish(*ipm.run_full_plain(*args, None, None, *kw), 3e-5)
    assert int(cold.status) == 0 and int(plain.status) == 0
    np.testing.assert_allclose(cold.z.cpu().numpy(), plain.z.cpu().numpy(),
                               atol=2e-3)
    args[1] = args[1] + 1e-3
    valid = torch.ones((), dtype=torch.bool, device=dev)
    warm = qp_mod.solve_qp_soft(*args, ws=cold.state, ws_valid=valid)
    warm_p = qp_mod._finish(*ipm.run_full_plain(*args, cold.state, valid,
                                                *kw), 3e-5)
    assert int(warm.status) == 0
    np.testing.assert_allclose(warm.z.cpu().numpy(), warm_p.z.cpu().numpy(),
                               atol=2e-4)
    assert abs(int(warm.iters) - int(warm_p.iters)) <= 2


PREP_RTOL = 1e-5   # chip_smoke.PREP_RTOL: per field, of its largest |plain|


def _prepare_vs_plain(dev, args, ws, wv):
    """The prepare kernel against prepare_plain on the same inputs: the same
    warm/cold choice, and every output field within PREP_RTOL of the
    field's largest magnitude (the same float32 formulas in the same
    order).  An accepted warm start also carries tau = rq, the staleness of
    the carried pair: a max over a stationarity vector that cancels to a
    few 1e-3 of its terms, so its float32 rounding (another summation order
    in the kernel's matvecs than in the plain version's) reaches ~1e-4 of
    tau where tau is not clamped.  There each field is held to the float64
    evaluation of prepare_plain on the same inputs instead, no farther from
    it than four times the plain float32 version plus PREP_RTOL of its
    scale.  Returns the plain version's choice."""
    d = ipm.prepare(*args, ws, wv, qp_mod.WS_BAND)
    torch.cuda.synchronize()
    p = ipm.prepare_plain(*args, ws, wv, qp_mod.WS_BAND)
    warm_p = p.warm is not None and bool(p.warm)
    assert bool(d.warm[0]) == warm_p
    fields = ipm.prepared_fields(d, p)
    if warm_p:
        f64 = lambda a: a.double()
        ex = ipm.prepare_plain(*map(f64, args), tuple(map(f64, ws)), wv,
                               qp_mod.WS_BAND)
        assert bool(ex.warm)
        for (name, k, v), (_, _, e) in zip(fields,
                                           ipm.prepared_fields(d, ex)):
            err_k = float((k.double() - e).abs().max())
            err_p = float((v.double() - e).abs().max())
            scale = max(float(e.abs().max()), 1e-30)
            assert err_k <= 4 * err_p + PREP_RTOL * scale, (name, err_k,
                                                            err_p, scale)
        return True
    for name, k, v in fields:
        err = float((k - v).abs().max())
        scale = max(float(v.abs().max()), 1e-30)
        assert err <= PREP_RTOL * scale, (name, err, scale)
    return False


def _carried(args, dg):
    """A plain solve's state, carried to the same QP with g moved by dg."""
    kw = (3e-5, 1e-7, 150, qp_mod.STALL_ITERS, qp_mod.STALL_RTOL,
          qp_mod.MU_GRIND, qp_mod.WS_BAND)
    sol = qp_mod._finish(*ipm.run_full_plain(*args, None, None, *kw), 3e-5)
    moved = list(args)
    moved[1] = args[1] + dg
    return moved, sol.state


@pytest.mark.parametrize("nU,mh,ms,resident", [
    (17, 7174, 70, True),      # the pendulum loop's QP
    (30, 60, 2480, True),      # the car loop's QP
    (6, 1, 1, True),           # m_h, m_s < 16: most ranks hold no row
    (6, 5, 3, True),
    (6, 15, 1, True),
    (6, 15, 3, True),
    (20, 52000, 512, False),   # chip_smoke.WIDE_QP, streamed
    (128, 20000, 1000, False),
])
def test_ipm_prepare_matches_plain(dev, nU, mh, ms, resident):
    """Seeded QPs cold, then warm from a plain solve of the same QP with g
    moved by 1e-3 (accepted), field by field and the choice."""
    assert ipm.prepare_layout(nU, mh, ms).resident == resident
    args = ipm.seeded_qp(nU, mh, ms, 5, dev)
    assert not _prepare_vs_plain(dev, args, None, None)
    moved, ws = _carried(args, 1e-3)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    assert _prepare_vs_plain(dev, moved, ws, valid)


@pytest.mark.parametrize("nU,mh,ms", [(17, 7174, 70), (20, 52000, 512)])
def test_ipm_prepare_rejected_warm_start(dev, nU, mh, ms):
    """A stale carried pair (g moved by 5: rq >= 1e-2) and a carried pair
    flagged invalid both give the cold start, as in prepare_plain."""
    args = ipm.seeded_qp(nU, mh, ms, 6, dev)
    moved, ws = _carried(args, 5.0)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    assert not _prepare_vs_plain(dev, moved, ws, valid)
    moved, ws = _carried(args, 1e-3)
    assert not _prepare_vs_plain(dev, moved, ws, ~valid)


# Hard-only QPs (m_s = 0): the shapes of the configs with no soft rows,
# (nU, m_h, G slices resident): params_pendulum_invariant and
# params_pendulum1D_invariant, params_pendulum_samples, params_pendulum,
# params_car_residual, and one too wide for shared memory.
HARD_ONLY = [(1, 202, True), (1, 2002, True), (30, 2460, True),
             (100, 800, True), (20, 52000, False)]


@pytest.mark.parametrize("nU,mh,resident", HARD_ONLY)
def test_ipm_hard_only_prepare_matches_plain(dev, nU, mh, resident):
    """The hard-only build of the prepare kernel, cold, and warm from a
    plain solve carried to g moved by 1e-3 (accepted), field by field and
    the choice; its layout has no soft slice."""
    lay = ipm.prepare_layout(nU, mh, 0)
    assert lay.resident == resident == ipm.loop_layout(nU, mh, 0).resident
    args = ipm.seeded_qp(nU, mh, 0, 5, dev)
    assert not _prepare_vs_plain(dev, args, None, None)
    moved, ws = _carried(args, 1e-3)
    assert all(ws[k].numel() == 0 for k in (1, 2, 5, 6, 7, 8, 9, 10))
    valid = torch.ones((), dtype=torch.bool, device=dev)
    assert _prepare_vs_plain(dev, moved, ws, valid)


@pytest.mark.parametrize("nU,mh,resident", HARD_ONLY)
def test_ipm_hard_only_mehrotra_matches_plain(dev, nU, mh, resident):
    """The hard-only build of the loop kernel on the same prepared problem
    as the plain loop, both held to the float64 solution."""
    _mehrotra_vs_f64(dev, nU, mh, 0, resident)


@pytest.mark.parametrize("nU,mh,resident", HARD_ONLY)
def test_ipm_hard_only_solve_matches_plain(dev, nU, mh, resident):
    """solve_qp_soft through both kernels, cold and then warm on the QP
    with g moved by 1e-3: status 0, no farther from the float64 solution
    than twice the plain float32 solver plus 1e-3 of its scale; launches
    counted once per kernel and solve."""
    _solve_vs_plain(dev, nU, mh, 0)


def _solve_vs_plain(dev, nU, mh, ms):
    """The checks of test_ipm_hard_only_solve_matches_plain on a seeded QP
    of any row counts."""
    args = ipm.seeded_qp(nU, mh, ms, 7, dev)
    kw = (3e-5, 1e-7, 150, qp_mod.STALL_ITERS, qp_mod.STALL_RTOL,
          qp_mod.MU_GRIND, qp_mod.WS_BAND)
    kw64 = (1e-12, 1e-13) + kw[2:]
    before = routes.launch_counts()
    ws = wv = ws64 = None
    for dg in (0.0, 1e-3):
        a = list(args)
        a[1] = args[1] + dg
        sol = qp_mod.solve_qp_soft(*a, ws=ws, ws_valid=wv)
        plain = qp_mod._finish(*ipm.run_full_plain(*a, ws, wv, *kw), 3e-5)
        ex = qp_mod._finish(*ipm.run_full_plain(
            *[x.double() for x in a], ws64, wv, *kw64), 1e-12)
        torch.cuda.synchronize()
        assert int(sol.status) == 0 and int(plain.status) == 0
        assert int(ex.status) == 0
        err_k = float((sol.z.double() - ex.z).abs().max())
        err_p = float((plain.z.double() - ex.z).abs().max())
        scale = 1.0 + float(ex.z.abs().max())
        assert err_k <= 2.0 * err_p + 1e-3 * scale, (dg, err_k, err_p)
        ws, ws64 = sol.state, ex.state
        wv = torch.ones((), dtype=torch.bool, device=dev)
    after = routes.launch_counts()
    assert {k: after[k] - before[k] for k in ipm.KERNELS} == {
        "ipm_prepare": 2, "ipm_mehrotra": 2}


# Wide QPs (128 < nU <= 256, the wide builds: Schur tiles, slices always
# streamed), (nU, m_h, m_s): the narrowest, params_car_samples' QP, the
# drone's optimistic planner's (hard-only) and the widest, soft and hard.
WIDE = [(129, 600, 300), (200, 400, 5010), (240, 840, 0), (256, 1000, 400),
        (256, 1000, 0)]


@pytest.mark.parametrize("nU,mh,ms", WIDE)
def test_ipm_wide_prepare_matches_plain(dev, nU, mh, ms):
    """The wide build of the prepare kernel, cold and warm from a plain
    solve carried to g moved by 1e-3 (accepted), field by field and the
    choice."""
    assert not ipm.loop_layout(nU, mh, ms).resident
    args = ipm.seeded_qp(nU, mh, ms, 5, dev)
    assert not _prepare_vs_plain(dev, args, None, None)
    moved, ws = _carried(args, 1e-3)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    assert _prepare_vs_plain(dev, moved, ws, valid)


@pytest.mark.parametrize("nU,mh,ms", WIDE)
def test_ipm_wide_mehrotra_matches_plain(dev, nU, mh, ms):
    """The wide loop kernel on the same prepared problem as the plain
    loop, both held to the float64 solution."""
    _mehrotra_vs_f64(dev, nU, mh, ms, resident=False)


@pytest.mark.parametrize("nU,mh,ms", WIDE)
def test_ipm_wide_solve_matches_plain(dev, nU, mh, ms):
    """solve_qp_soft through the wide builds, cold and warm, as
    test_ipm_hard_only_solve_matches_plain."""
    _solve_vs_plain(dev, nU, mh, ms)


def test_ipm_refuses_past_the_wide_limit(dev):
    """nU = 257 raises, naming the limit, before any launch."""
    args = ipm.seeded_qp(257, 600, 10, 5, dev)
    before = dict(ipm.LAUNCHES)
    with pytest.raises(ValueError, match="nU <= 256"):
        qp_mod.solve_qp_soft(*args)
    assert ipm.LAUNCHES == before


def _close(got, ref, tol):
    """assert_allclose at rtol = atol = tol (the JAX tests' bars)."""
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,n,m", [(64, 60, 8), (60, 180, 8),
                                   (12000, 50, 1)])
def test_linalg_kernels_match_plain(dev, B, n, m):
    """Kernels 5-7 against their plain versions on the same float32
    inputs: factors 2e-4, solves 3e-4 (tests/test_batch_linalg.py's
    bars), upper triangles exactly zero."""
    from sampling_gpmpc_torch.microbench_linalg import spd_inputs
    S, R = spd_inputs(B, n, m, dev, seed=B)
    L = batch_linalg.chol(S)
    _close(L, batch_linalg.chol_plain(S), 2e-4)
    assert bool((torch.triu(L, 1) == 0).all())
    for tr in (False, True):
        _close(batch_linalg.tri_solve(L, R, lower_factor_transposed=tr),
               batch_linalg.tri_solve_plain(L, R, tr), 3e-4)
    Lb = batched_chol.batched_cholesky(S, 0.1, use_kernel=True)
    _close(Lb, batched_chol.batched_cholesky_plain(S, 0.1), 2e-4)
    assert bool((torch.triu(Lb, 1) == 0).all())


def test_linalg_kernels_nan_pattern(dev):
    """A pivot that goes negative: each kernel's NaN entries are its plain
    version's, its finite entries agree."""
    from sampling_gpmpc_torch.microbench_linalg import spd_inputs
    S, _ = spd_inputs(8, 40, 1, dev)
    S[:, 11, 11] = -1.0
    for got, ref in ((batch_linalg.chol(S), batch_linalg.chol_plain(S)),
                     (batched_chol.batched_cholesky(S, use_kernel=True),
                      batched_chol.batched_cholesky_plain(S))):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        fin = torch.isfinite(ref)
        _close(got[fin], ref[fin], 2e-4)


@pytest.mark.parametrize("B,n,m", [(64, 60, 8), (64, 108, 8), (128, 60, 8),
                                   (512, 60, 8), (12000, 50, 1),
                                   (60, 180, 8), (5, 17, 3), (3, 180, 186)])
def test_tri_solve_kernel_matches_plain(dev, B, n, m):
    """The blocked solve at the six linalg shapes, one ragged panel, and
    the widest right-hand side n = 180 takes, both directions: within 3e-4
    of the plain version (the same updates in the same order: measured
    bit-identical); a zero pivot and a NaN in one right-hand-side column
    give the plain version's NaN entries."""
    from sampling_gpmpc_torch.microbench_linalg import spd_inputs
    S, R = spd_inputs(B, n, m, dev, seed=n + m)
    L = batch_linalg.chol(S)
    assert batch_linalg.use_kernel(n, m)
    L0 = L.clone()
    L0[:, n // 2, n // 2] = 0.0
    R1 = R.clone()
    R1[:, n // 3, m - 1] = float("nan")
    for tr in (False, True):
        _close(batch_linalg.tri_solve(L, R, lower_factor_transposed=tr),
               batch_linalg.tri_solve_plain(L, R, tr), 3e-4)
        for Lx, Rx in ((L0, R), (L, R1)):
            got = batch_linalg.tri_solve(Lx, Rx, lower_factor_transposed=tr)
            ref = batch_linalg.tri_solve_plain(Lx, Rx, tr)
            assert torch.equal(torch.isnan(got), torch.isnan(ref))
            assert bool(torch.isnan(got[..., m - 1]).all())
            if Lx is L:
                assert bool(torch.isfinite(got[..., :m - 1]).all())
            fin = torch.isfinite(ref)
            if bool(fin.any()):
                _close(got[fin], ref[fin], 3e-4)


@pytest.mark.parametrize("n", [16, 33, 50, 64, 65, 108, 180, 239, 320])
def test_chol_kernels_match_plain_by_n(dev, n):
    """The blocked Cholesky kernels at both launch shapes (a 64-thread CTA
    up to n = 64, 256 threads above), one, two and several panels, a
    ragged last tile, at B = 7 and B = 1: against their plain versions at
    2e-4, upper triangles exactly 0.  chol takes n in its window (16..180);
    batched_chol up to the column sweep's limit (239) and the tiles'
    (320)."""
    from sampling_gpmpc_torch.microbench_linalg import spd_inputs
    for B in (7, 1):
        S, _ = spd_inputs(B, n, 1, dev, seed=n + B)
        pairs = [(batched_chol.batched_cholesky(S, 0.1, use_kernel=True),
                  batched_chol.batched_cholesky_plain(S, 0.1))]
        if batch_linalg.use_kernel(n):
            pairs.append((batch_linalg.chol(S), batch_linalg.chol_plain(S)))
        for got, ref in pairs:
            _close(got, ref, 2e-4)
            assert bool((torch.triu(got, 1) == 0).all())
    assert n > batch_linalg.MAX_N or len(pairs) == 2


@pytest.mark.parametrize("n", [50, 180])
def test_chol_kernels_empty_batch(dev, n):
    """B = 0 launches nothing and returns the empty factor."""
    S = torch.empty((0, n, n), device=dev)
    counts = (batch_linalg.LAUNCHES["chol"],
              batched_chol.LAUNCHES["batched_chol"])
    assert batch_linalg.chol(S).shape == (0, n, n)
    assert batched_chol.batched_cholesky(S, use_kernel=True).shape == \
        (0, n, n)
    assert counts == (batch_linalg.LAUNCHES["chol"],
                      batched_chol.LAUNCHES["batched_chol"])


@pytest.mark.parametrize("j0", [17, 32, 100])
def test_chol_kernels_nan_pattern_n180(dev, j0):
    """A failed pivot inside a panel (17), on a panel's first column (32)
    and deep in the factor (100) of an n = 180 batch: each kernel's NaN
    entries are its plain version's, its finite entries agree."""
    from sampling_gpmpc_torch.microbench_linalg import spd_inputs
    S, _ = spd_inputs(4, 180, 1, dev, seed=j0)
    S[:, j0, j0] = -1.0
    for got, ref in ((batch_linalg.chol(S), batch_linalg.chol_plain(S)),
                     (batched_chol.batched_cholesky(S, use_kernel=True),
                      batched_chol.batched_cholesky_plain(S))):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert bool(torch.isnan(got[:, j0, j0]).all())
        fin = torch.isfinite(ref)
        _close(got[fin], ref[fin], 2e-4)


def test_solve_recorded_matches_solve_bitwise(dev):
    """params_car's first step (ns=20, H=15, four SQP iterations) on the
    draws of tests/goldens/torch_oracle_car.npz, float32 through the
    kernels: the recorded solve is the solve, bit for bit, and launches
    each loop kernel as often."""
    import os

    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g = np.load(os.path.join(root, "tests", "goldens",
                             "torch_oracle_car.npz"))
    params, spec, data = load_problem(os.path.join(root, "params",
                                                   "params_car.yaml"))
    env = make_env(spec, params)
    f32 = torch.float32
    hyp = GPHyperArrays.from_spec(spec.gp, dev, f32)
    args = (spec, env, hyp, make_ocp_data(spec, data, dev, f32),
            torch.as_tensor(g["physical_state_traj"][0], dtype=f32,
                            device=dev),
            *sqp.init_iterate(spec, dev, f32, data.start),
            agent.init_gp_state(spec, env, dev, f32, hyp=hyp),
            torch.as_tensor(g["eps"][0], dtype=f32, device=dev))
    counts = []
    out = []
    for recorded in (False, True):
        routes.zero_launch_counts()
        st = (sqp.solve_recorded(*args)[0] if recorded
              else sqp.solve(*args))
        torch.cuda.synchronize()
        # the car's hall factor keeps its tiles in shared memory: no
        # gp_hall_global launch set and no gp_hall_panels step
        counts.append({k: v for k, v in routes.launch_counts().items()
                       if k not in glue.LAUNCHES
                       and k not in ("gp_hall_global", "gp_hall_panels")})
        out.append(st)
    a, b = out
    assert a.it == b.it == spec.max_sqp_iter
    for k in ("X", "U", "X_prev", "U_prev", "status", "qp_iters", "qp_gap"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert counts[0] == counts[1] and min(counts[0].values()) > 0


def test_sample_complexity_matches_cpu(dev):
    """The small-ball calculators in float64 on the card against the CPU:
    deviations on injected draws to 1e-10, the closed forms to 1e-10
    relative, p_ball on each device's own draws within 5 binomial
    standard deviations."""
    from sampling_gpmpc_torch.tools import sample_complexity as sc
    rng = np.random.default_rng(0)
    Z = rng.uniform(-1, 1, size=(20, 2))
    y = np.sin(Z[:, 0]) * np.cos(Z[:, 1])
    grid = rng.uniform(-1, 1, size=(30, 2))
    p = (Z, y, grid, np.array([0.7, 0.7]), 0.5, 1e-4)
    cpu = torch.device("cpu")
    eps = rng.normal(size=(20000, grid.shape[0]))
    dk = sc.max_deviation_samples_chunked(*p, 20000, eps=eps, device=dev)
    dc = sc.max_deviation_samples_chunked(*p, 20000, eps=eps, device=cpu)
    np.testing.assert_allclose(dk, dc, rtol=0, atol=1e-10)
    for fn in (sc.rkhs_norm, sc.info_beta):
        a = (Z, y) + p[3:] if fn is sc.rkhs_norm else (Z,) + p[3:]
        assert fn(*a, device=dev) == pytest.approx(fn(*a, device=cpu),
                                                   rel=1e-10)
    n = 200_000
    pk = sc.small_ball_probability(*p, 0.05, n, device=dev)
    pc = sc.small_ball_probability(*p, 0.05, n, device=cpu)
    sd = np.sqrt((pk * (1 - pk) + pc * (1 - pc)) / n)
    assert 0.0 < pk < 1.0 and abs(pk - pc) <= 5 * sd


def test_blocked_solve_matches_one_device_flagship(dev):
    """The in-process blocked solve (4 blocks of 16, ordered sums, one
    CUDA stream per block) at the flagship shape, params_pendulum1D_
    samples at ns = 64, one RTI iteration: status 0 like the one-device
    kernel solve and within the pendulum's float32 caps of it (0.5 in X,
    5.0 in U); every block ran gp_sample and took the group QP route, and
    no IPM kernel ran (the JAX gate keeps it off under a sample axis)."""
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.parallel.sharded import make_blocked_solve
    from sampling_gpmpc_torch.parallel.worker import problem
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_pendulum1D_samples", 64, 1, dev, torch.float32)
    ref = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    before = dict(ipm.LAUNCHES)
    blocked = make_blocked_solve(spec, env, hyp, ocp, 4)
    out = blocked(st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    assert ipm.LAUNCHES == before
    assert int(out.status) == int(ref.status) == 0 and out.it == 1
    assert bool(torch.isfinite(out.X).all())
    assert float((out.X - ref.X).abs().max()) <= 0.5
    assert float((out.U - ref.U).abs().max()) <= 5.0
    for b in blocked.group.launches:
        assert b.get("gp_sample") == 1 and b.get("group") == 1, b
        assert not b.get("ipm_prepare") and not b.get("run_full"), b


# synchronising calls a params_pendulum1D_samples step makes, each counted
# in obs.SYNCS at its site, all copies from host memory: sqp._initial_state's
# two scalars, the index lists of sqp._assemble, Env.assemble_val_jac and
# Env.g_inputs (in the plant step), the pendulum's B_d in the linearization
# and in the plant step
PENDULUM_STEP_SYNCS = 7


def test_pendulum_steps_sync_as_counted(dev):
    """One cold and one warm params_pendulum1D_samples step as published
    (ns = 70, H = 17, one RTI iteration: the solve, the plant step with the
    feedback, the shift) under ``torch.cuda.set_sync_debug_mode("warn")``:
    torch's count of synchronising calls in each step equals the step's
    gain in ``obs.SYNCS``, the pinned count."""
    import warnings
    from collections import Counter

    from sampling_gpmpc_torch import bench, obs
    _, spec, data, env = bench.build(dict(ns=70, H=17))
    eps = bench.draws(spec, 3, 5, dev)
    bench.ClosedLoop(spec, data, env, dev).step(eps[2])   # build, warm up
    loop = bench.ClosedLoop(spec, data, env, dev)
    torch.cuda.synchronize()
    for m, kind in enumerate(("cold", "warm")):
        before = Counter(obs.SYNCS)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st = loop.step(eps[m])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counted = Counter(obs.SYNCS)
        counted.subtract(before)
        found = [str(w.message) for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        loop.check(st, f"{kind} step")
        assert len(found) == sum(counted.values()) == PENDULUM_STEP_SYNCS, (
            kind, found, +counted)


def _glue_problem(dev, config, ns, **over):
    """One SQP iteration's glue inputs on the card in float32 (the shared
    builder ``worker.glue_inputs``): (spec, ocp, combined, X, U, st)."""
    from sampling_gpmpc_torch.parallel.worker import glue_inputs
    return glue_inputs(config, ns, dev, torch.float32, **over)[0]


# float32 rounding of the condensing's sums of products along two
# association orders (the kernel's stage-by-stage recursion against the
# plain version's prefix compositions, at up to H = 128 stages) and of the
# cost's sums over samples and stages in two orders: a few hundred ulps of
# an output's largest entry; the 1e8 upper bounds of the ellipse rows are
# held exactly
GLUE_RTOL = 1e-4


def _glue_close(got, ref):
    qp, T, Gamma = got
    qp_r, T_r, Gamma_r = ref
    from sampling_gpmpc_torch.ocp import sqp
    for name, a, b in zip(sqp.QP_KEYS + ("T", "Gamma"), (*qp, T, Gamma),
                          (*qp_r, T_r, Gamma_r)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert bool(torch.isfinite(a).all()), name
        big = b.abs() >= 1e7
        assert torch.equal(a[big], b[big]), name
        if (~big).any():
            scale = float(b[~big].abs().max())
            err = float((a - b)[~big].abs().max())
            assert err <= GLUE_RTOL * scale, (name, err, scale)


GLUE_CASES = [
    ("params_pendulum1D_samples", 70, {}),     # feedback, terminal ellipse
    ("params_pendulum", 20, {}),               # hard rows only
    ("params_car", 20, {}),                    # ellipses, nx = 4, nu = 2
    ("params_car_samples", 10, {}),            # nU = 200: the Gram launch
    ("params_car_samples", 4, {"H": 128}),     # nU = 256: Gram, tile edge
    ("params_pendulum1D_samples", 300, {}),    # CTAs loop past MAX_CTAS
    ("params_pendulum1D_samples", 70, {"use_feedback": False}),
    ("params_car_residual", 1, {}),            # ns = 1, nu = 2, Gram
    ("params_pendulum_samples", 500, {}),      # H = 1
]


@pytest.mark.parametrize("config,ns,over", GLUE_CASES)
def test_glue_kernel_matches_plain(dev, config, ns, over):
    """The condensing and assembly kernel against its plain version on
    every output: the QP tuple, T and Gamma (GLUE_RTOL)."""
    spec, ocp, comb, X, U, st = _glue_problem(dev, config, ns, **over)
    got = condensed_qp(spec, ocp, comb, X, U, st)
    ref = assemble_iteration(spec, ocp, comb, X, U, st)
    torch.cuda.synchronize()
    _glue_close(got, ref)


@pytest.mark.parametrize("config,ns,gram", [
    ("params_pendulum1D_samples", 70, True),
    ("params_car", 20, True),
    ("params_car_residual", 1, False),
    ("params_pendulum_samples", 500, True),
])
def test_glue_other_branch_matches_plain(dev, config, ns, gram):
    """The branch the shape does not pick, asked for: the Gram launch at
    the narrow shapes, the sums in shared memory at nU = 100; both agree
    with the plain version (GLUE_RTOL)."""
    spec, ocp, comb, X, U, st = _glue_problem(dev, config, ns)
    assert glue.layout(spec, row_counts(spec))[1] != gram
    got = glue.launch(spec, row_counts(spec), ocp, comb, X, U, st, gram=gram)
    ref = assemble_iteration(spec, ocp, comb, X, U, st)
    torch.cuda.synchronize()
    _glue_close(got, ref)


@pytest.mark.parametrize("config,ns,over", [GLUE_CASES[0], GLUE_CASES[3],
                                            GLUE_CASES[4], GLUE_CASES[5]])
def test_glue_kernel_is_deterministic(dev, config, ns, over):
    """Two launches on the same inputs give the same bits: the cost's sums
    over samples run in sample order in the last CTA, with no float
    atomics (the flagship, the Gram launch at nU = 200 and 256, CTAs
    looping over samples)."""
    spec, ocp, comb, X, U, st = _glue_problem(dev, config, ns, **over)
    a = glue.launch(spec, row_counts(spec), ocp, comb, X, U, st)
    b = glue.launch(spec, row_counts(spec), ocp, comb, X, U, st)
    torch.cuda.synchronize()
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("config,ns", [("params_pendulum1D_samples", 70),
                                       ("params_car", 20),
                                       ("params_car_samples", 10)])
def test_glue_group_route_adds_the_input_block_after(dev, config, ns):
    """Under a sample-axis group the launch leaves the input block out of
    (H, g) and ``condensed_qp`` adds ``input_cost`` after the psum: with the
    block added so, the result equals the ungrouped launch (H bit for bit,
    g to the float32 rounding of 2 Ubar Qu's sum over nu), every row
    bit for bit."""
    from sampling_gpmpc_torch.ocp.assemble import input_cost
    spec, ocp, comb, X, U, st = _glue_problem(dev, config, ns)
    whole = glue.launch(spec, row_counts(spec), ocp, comb, X, U, st)
    part = glue.launch(spec, row_counts(spec), ocp, comb, X, U, st,
                       with_block=False)
    H_in, g_in = input_cost(spec, ocp, U)
    torch.cuda.synchronize()
    assert torch.equal(part[0][0] + H_in, whole[0][0])
    g_ref = whole[0][1]
    assert float((part[0][1] + g_in - g_ref).abs().max()) <= \
        1e-6 * float(g_ref.abs().max())
    for x, y in zip((*part[0][2:], part[1], part[2]),
                    (*whole[0][2:], whole[1], whole[2])):
        assert torch.equal(x, y)


def test_glue_refuses_float64_on_the_card(dev):
    """A float64 problem on the card raises (run it on the CPU or under
    plain_route()); nothing falls back to the plain chain."""
    spec, ocp, comb, X, U, st = _glue_problem(dev, "params_car", 4)
    ocp64 = type(ocp)(*(t.double() for t in ocp))
    before = glue.LAUNCHES["glue_condense"]
    with pytest.raises(ValueError, match="need float32"):
        condensed_qp(spec, ocp64, comb.double(), X.double(), U.double(),
                     st.double())
    assert glue.LAUNCHES["glue_condense"] == before


def test_glue_launches_once_per_sqp_iteration(dev):
    """On the main path the glue kernel launches once per SQP iteration:
    params_car's four-iteration solve and three params_pendulum1D_samples
    steps as published (one RTI iteration each), with no Gram launch;
    params_car_residual (nU = 100) adds one Gram launch an iteration."""
    from sampling_gpmpc_torch import bench
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.parallel.worker import problem
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_car", 20, 4, dev, torch.float32)
    routes.zero_launch_counts()
    s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    assert s.it == 4 and routes.launch_counts()["glue_condense"] == 4
    assert routes.launch_counts()["glue_gram"] == 0
    _, spec, data, env = bench.build(dict(ns=70, H=17))
    draws = bench.draws(spec, 3, 5, dev)
    loop = bench.ClosedLoop(spec, data, env, dev)
    routes.zero_launch_counts()
    its = sum(loop.step(draws[m]).it for m in range(3))
    torch.cuda.synchronize()
    assert its == 3 and routes.launch_counts()["glue_condense"] == 3
    assert routes.launch_counts()["glue_gram"] == 0
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_car_residual", 1, 3, dev, torch.float32)
    routes.zero_launch_counts()
    s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    n = routes.launch_counts()
    assert s.it == 3 and n["glue_condense"] == n["glue_gram"] == 3


# the hall stages from the points (gp_hall.sample_hall_points): the car's
# fills as published, the 2D pendulum's global-tile fills, params_car_samples
# (Rr = 448, fills 400 / 800 / 1200), no derivatives (Ty = 1) and D = 2
HALL_POINT_CASES = [("params_car", 20, 4), ("params_pendulum", 20, 3),
                    ("params_car_samples", 10, 4),
                    ("params_car_residual_fs", 8, 3),
                    ("params_pendulum1D_samples", 70, 3)]
_BLOCK_ARGS = ("real_Z", "m_r", "hall_Z", "hall_Y", "Xt", "eps", "lengthscale",
               "outputscale", "noise_diag")


def _hall_point_stages(dev, config, ns, its):
    """The hall stages of one forced-iteration MPC step on the card in
    float32 (the shared helper ``worker.hall_inputs``), each with the
    entry's arguments: [(spec, hyp, gp, Xt, eps, kw)]."""
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.parallel.worker import hall_inputs
    return [(spec, hyp, gp, Xt, eps,
             agent.hall_point_inputs(spec, hyp, gp, Xt, eps))
            for spec, hyp, gp, Xt, eps in hall_inputs(config, ns, its, dev,
                                                      torch.float32)]


@pytest.mark.parametrize("config,ns,its", HALL_POINT_CASES)
def test_hall_blocks_kernel_matches_plain(dev, config, ns, its):
    """The blocks hall_blocks_kernel writes (the first nh hall columns)
    against its plain version on the same float32 points: expf's and the
    sum's rounding only, within 1e-5 of each block's largest entry; the
    eps rows and prior_var exactly."""
    for spec, _, gp, _, _, kw in _hall_point_stages(dev, config, ns, its):
        nh = kw["nh"]
        args = [kw[k] for k in _BLOCK_ARGS]
        got = gp_hall.hall_blocks(nh, *args, ty=kw["ty"])
        ref = gp_hall.hall_blocks_plain(nh, *args, kw["ty"])
        torch.cuda.synchronize()
        assert list(got) == list(ref)
        for k, v in ref.items():
            assert got[k].shape == v.shape, (nh, k)
            if k in ("eps", "prior_var", "yh"):
                assert torch.equal(got[k], v), (nh, k)
            elif v.numel():
                scale = float(v.abs().max())
                assert float((got[k] - v).abs().max()) <= 1e-5 * scale, (
                    config, nh, k)


@pytest.mark.parametrize("config,ns,its", HALL_POINT_CASES)
def test_hall_points_entry_matches_blocks_entry(dev, config, ns, its):
    """Each stage's draws through the entry from the points against those
    through the agent's blocks (``hall_stage_inputs_all`` +
    ``sample_hall``) from the same eps: no farther from the float64
    evaluation of the algorithm on those blocks than four times the blocks
    entry, both of them cancelling the same float32 variances; and
    following eps, with no more entries at the mean than the blocks
    entry."""
    from sampling_gpmpc_torch import agent
    fills = []
    for spec, hyp, gp, Xt, eps, kw in _hall_point_stages(dev, config, ns,
                                                         its):
        blocks = agent.hall_stage_inputs_all(spec, hyp, gp, Xt, eps)
        got = gp_hall.sample_hall_points(**kw)
        old = gp_hall.sample_hall(**blocks)
        ex = gp_hall.sample_hall_plain_stacked(
            **{k: v.double() if torch.is_tensor(v) else v
               for k, v in blocks.items()})
        mean = gp_hall.sample_hall_points(
            **dict(kw, eps=torch.zeros_like(kw["eps"])))
        old_mean = gp_hall.sample_hall(
            **dict(blocks, eps=torch.zeros_like(blocks["eps"])))
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        scale = float(ex.abs().max())
        err_new = float((got.double() - ex).abs().max())
        err_old = float((old.double() - ex).abs().max())
        assert err_new <= 4 * err_old + 1e-6 * scale, (kw["nh"], err_new,
                                                       err_old)
        # the car's float32 draws sit ~0.1 of their scale from float64 on
        # both routes (variance cancellation): follow eps as the blocks
        # entry does, no more entries at the mean (zero-variance rows go
        # there on both routes: two thirds at the 2D pendulum)
        at_mean = float((got == mean).double().mean())
        assert at_mean <= float((old == old_mean).double().mean()) + 0.01
        assert not torch.equal(got, mean)
        fills.append(kw["nh"])
    H, Ty = spec.H, spec.Ty
    assert fills == [k * H * Ty for k in range(1, its)]


def test_hall_points_launch_once_per_hall_stage(dev):
    """On the main path each hall stage is one call of the entry from the
    points: params_car's four-iteration solve launches the blocks kernel
    and the hall launch set three times, the blocks entry never."""
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.parallel.worker import problem
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_car", 20, 4, dev, torch.float32)
    routes.zero_launch_counts()
    s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    n = routes.launch_counts()
    assert s.it == 4 and n["gp_hall_blocks"] == n["gp_hall"] == 3
    assert n["gp_sample"] == 1 and n["gp_hall_global"] == 0
    assert n["gp_hall_panels"] == 0
    with routes.plain_route(gp=True, qp=False, glue=False):
        routes.zero_launch_counts()
        s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
        torch.cuda.synchronize()
        n = routes.launch_counts()
    assert s.it == 4 and n["gp_hall_blocks"] == n["gp_hall"] == 0


def test_hall_global_tiles_counted_at_car_samples(dev):
    """params_car_samples' hall stages (Ht = 400, fills 400 / 800 / 1200)
    take the factor's global-tile branch, each counted once under
    gp_hall_global, and its 7 + 13 + 19 panel steps under gp_hall_panels;
    the car's (Ht = 60) never do."""
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.parallel.worker import problem
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_car_samples", 10, 4, dev, torch.float32)
    routes.zero_launch_counts()
    s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    n = routes.launch_counts()
    assert s.it == 4 and n["gp_hall_global"] == n["gp_hall"] == 3
    assert n["gp_hall_panels"] == sum(gp_hall.hall_panels(400, nh)
                                      for nh in (400, 800, 1200)) == 39
    assert n["glue_gram"] == n["glue_condense"] == 4


# the step's consumption (ops/glue.py::advance) at every shape the port
# solves on the card, as published
ADVANCE_CASES = [("params_pendulum1D_samples", 70), ("params_pendulum", 20),
                 ("params_car", 20), ("params_car_residual", 1),
                 ("params_car_samples", 10), ("params_pendulum_samples", 500)]
# the state each branch starts from, given the full step's sn (the raw
# relative step norm x_diff + u_diff): (status, best_step / sn, stall_count,
# mono_count, alpha) and the alpha it must leave; every threshold at least
# 5 % away.  "done": a step of ~1e-6 of the iterate's scale, dU = 0.
_ADVANCE_STATES = {
    "first": (0, float("inf"), 0, 0, 1.0, 1.0),        # a solve's first step
    "full": (0, 2.0, 3, 1, 1.0, 1.0),                  # a new minimum
    "failed": (4, 0.5, 2, 1, 0.5, 0.5),                # nothing consumed
    "stall": (0, 0.5, 5, 0, 1.0, 0.5),                 # alpha halves
    "floor": (0, 0.5, 5, 0, 1.0 / 16.0, 1.0 / 16.0),   # ... not past 1/16
    "recover": (0, 2.0, 0, 3, 0.25, 0.5),              # alpha doubles
    "recover_full": (0, 2.0, 0, 3, 0.5, 1.0),          # ... back to 1
    "done": (0, float("inf"), 0, 0, 1.0, 1.0),         # converged
}
_ADVANCE_BASE: dict = {}


def _advance_base(dev, config, ns):
    """A configuration's iterate and the glue kernel's T, Gamma on the
    card (``_glue_problem``), with a seeded QP step z = 0.5 N(0, 1)."""
    key = (config, ns)
    if key not in _ADVANCE_BASE:
        from sampling_gpmpc_torch.ocp import sqp
        spec, ocp, comb, X, U, st = _glue_problem(dev, config, ns)
        _, T, Gamma = condensed_qp(spec, ocp, comb, X, U, st)
        g = torch.Generator().manual_seed(7)
        z = (0.5 * torch.randn(spec.H * spec.nu, generator=g)).to(dev)
        assert sqp.STALL == (6, 0.95, 4, 1.0 / 16.0)
        _ADVANCE_BASE[key] = (spec, X, U, T.clone(), Gamma.clone(), z)
    return _ADVANCE_BASE[key]


def _advance_inputs(dev, config, ns, branch):
    """(spec, args of ``glue.advance`` without ``stall``, the alpha the
    branch leaves): status and iterations (int64 where the QP failed, as
    the plain IPM counts) and the state's scalars as ``_ADVANCE_STATES``."""
    from sampling_gpmpc_torch.ocp import sqp
    spec, X, U, T, Gamma, z = _advance_base(dev, config, ns)
    if branch == "done":
        T = T * (1e-6 * float(X.abs().max()) / float(T.abs().max()))
        z = torch.zeros_like(z)
    X_c, U_c = sqp.candidate(spec, X, U, T, Gamma, z)
    one = torch.ones((), dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    sn = sum(float(v) for v in sqp.consume_step(
        spec, X, U, X_c, U_c, one, inf, torch.zeros((), dtype=torch.int32,
                                                     device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.ones((), device=dev))[2:4])
    status, best, stall, mono, alpha, alpha_new = _ADVANCE_STATES[branch]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    iters = torch.tensor(9, dtype=torch.int64 if status else torch.int32,
                         device=dev)
    args = (X, U, T, Gamma, z, torch.tensor(status, device=dev), iters,
            f32(best * sn), i32(stall), i32(mono), f32(alpha), i32(31))
    return spec, args, alpha_new


def _advance_plain(spec, X, U, T, Gamma, z, status, iters, best_step,
                   stall_count, mono_count, alpha, qp_iters):
    """The torch chain the kernel replaces, on the same device."""
    from sampling_gpmpc_torch.ocp import sqp
    ok = status == 0
    return sqp.consume_step(spec, X, U, *sqp.candidate(spec, X, U, T, Gamma,
                                                       z), ok, best_step,
                            stall_count, mono_count, alpha) + (
        ok, qp_iters + iters)


# the kernel's sums in another order than torch's: the four squared norms
# to float32 rounding; the iterate within the float32 bound of a dot of nU
# terms (gamma_n = n u, u = 2^-24) for each of the two orders, on the
# magnitude of what is summed, |X| + |T| + |Gamma| |dU| (|U| + |dU|)
ADVANCE_NORM_RTOL = 1e-6


def _advance_scales(X, U, T, Gamma, z):
    """The magnitude of the terms summed into each entry of X and U, the
    largest of each."""
    terms = T.abs() + torch.einsum("ikau,u->ika", Gamma.abs(), z.abs())
    return (float((X.abs() + terms.transpose(0, 1)).max()),
            float((U.abs() + z.abs().reshape(U.shape)).max()))


@pytest.mark.parametrize("branch", list(_ADVANCE_STATES))
@pytest.mark.parametrize("config,ns", ADVANCE_CASES)
def test_glue_advance_matches_consume_step(dev, config, ns, branch):
    """The step's consumption in one launch against ``consume_step`` on
    the candidate X + (T + Gamma dU)', U + dU: counters, alpha, done and
    qp_valid equal, qp_iters equal in value and dtype; X and U within two
    dot products' float32 bound of their terms' scale, x_diff, u_diff and
    best_step to ADVANCE_NORM_RTOL; the branch taken as set up, and the
    inputs left as they were."""
    from sampling_gpmpc_torch.ocp import sqp
    spec, args, alpha_new = _advance_inputs(dev, config, ns, branch)
    before = [a.clone() for a in args]
    got = glue.advance(spec, *args, sqp.STALL)
    ref = _advance_plain(spec, *args)
    torch.cuda.synchronize()
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    out = dict(zip(glue.ADVANCE_OUTPUTS, got))
    want = dict(zip(glue.ADVANCE_OUTPUTS, ref))
    scale = dict(zip(("X", "U"), _advance_scales(*args[:5])))
    gamma = 2 * (spec.H * spec.nu + 2) * 2.0 ** -24
    for k in glue.ADVANCE_OUTPUTS:
        a, b = out[k], want[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in ("X", "U"):
            err = float((a - b).abs().max())
            assert err <= gamma * scale[k], (k, err, scale[k])
        elif k in ("x_diff", "u_diff", "best_step"):
            assert float(a) == pytest.approx(float(b), rel=ADVANCE_NORM_RTOL,
                                             abs=0), k
        else:
            assert torch.equal(a, b), (k, a, b)
    assert float(out["alpha"]) == alpha_new
    assert bool(out["done"]) == (branch == "done")
    assert bool(out["qp_valid"]) == (branch != "failed")
    X, U = args[:2]
    if branch == "failed":
        assert torch.equal(out["X"], X) and torch.equal(out["U"], U)
        assert int(out["stall_count"]) == 2 and int(out["mono_count"]) == 1
    elif alpha_new == 1.0:
        assert torch.equal(out["U"], U + args[4].reshape(U.shape))


@pytest.mark.parametrize("config,ns", ADVANCE_CASES)
def test_glue_advance_is_deterministic(dev, config, ns):
    """Two launches on the same inputs give the same bits: the sums run
    in a fixed tree, with no atomics (a partial step, so both passes
    run)."""
    from sampling_gpmpc_torch.ocp import sqp
    spec, args, _ = _advance_inputs(dev, config, ns, "stall")
    a = glue.advance(spec, *args, sqp.STALL)
    b = glue.advance(spec, *args, sqp.STALL)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_glue_advance_refuses_float64_on_the_card(dev):
    """A float64 iterate on the card raises, naming it; nothing is
    launched and nothing falls back to the torch chain."""
    from sampling_gpmpc_torch.ocp import sqp
    spec, args, _ = _advance_inputs(dev, "params_car", 20, "first")
    before = glue.LAUNCHES["glue_advance"]
    with pytest.raises(ValueError, match="X: need float32"):
        glue.advance(spec, args[0].double(), *args[1:], sqp.STALL)
    assert glue.LAUNCHES["glue_advance"] == before


def test_glue_advance_launches_once_per_sqp_iteration(dev):
    """On the main path the step's consumption is one launch per SQP
    iteration: params_car's four-iteration solve launches it 4 times and
    three params_pendulum1D_samples steps as published (one RTI iteration
    each) 3 times; under plain_route(glue=True) the torch chain runs
    instead and the car's solve launches it never."""
    from sampling_gpmpc_torch import bench
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.parallel.worker import problem
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_car", 20, 4, dev, torch.float32)
    routes.zero_launch_counts()
    s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    assert s.it == 4 and routes.launch_counts()["glue_advance"] == 4
    with routes.plain_route(gp=False, qp=False, glue=True):
        routes.zero_launch_counts()
        s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
        torch.cuda.synchronize()
        n = routes.launch_counts()
    assert s.it == 4 and n["glue_advance"] == n["glue_condense"] == 0
    _, spec, data, env = bench.build(dict(ns=70, H=17))
    draws = bench.draws(spec, 3, 5, dev)
    loop = bench.ClosedLoop(spec, data, env, dev)
    routes.zero_launch_counts()
    its = sum(loop.step(draws[m]).it for m in range(3))
    torch.cuda.synchronize()
    assert its == 3 and routes.launch_counts()["glue_advance"] == 3


@pytest.mark.parametrize("seed", [123451, 123454, 123456])
def test_hall_kernel_matches_plain_on_the_car_check(dev, seed):
    """bench.hall_equiv_check (params_car's hall stage from a solved
    iterate, kernel against plain on the same inputs) at seeds where,
    with the configured jitter alone on every row, the kernel's and the
    plain version's rounding put one sample's covariance factor on
    different jitters (0.26-0.39 of the tube apart): within chip_smoke's
    GP_HALL_REL_TOL (0.01 of the tube), inside the tube."""
    from sampling_gpmpc_torch import bench
    r = bench.hall_equiv_check(dev, seed)
    assert r["rel"] <= 1e-2, r
    assert r["viol"] == 0.0, r
