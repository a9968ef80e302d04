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
from sampling_gpmpc_torch.ops import (batch_linalg, batched_chol, gp_hall,
                                      gp_sample, ipm)

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
    args = ipm.seeded_qp(nU, mh, 0, 7, dev)
    kw = (3e-5, 1e-7, 150, qp_mod.STALL_ITERS, qp_mod.STALL_RTOL,
          qp_mod.MU_GRIND, qp_mod.WS_BAND)
    kw64 = (1e-12, 1e-13) + kw[2:]
    before = dict(ipm.LAUNCHES)
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
    assert {k: ipm.LAUNCHES[k] - before[k] for k in before} == {
        "ipm_prepare": 2, "ipm_mehrotra": 2}


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
