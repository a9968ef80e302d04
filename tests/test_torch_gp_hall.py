"""The hall-block stage's blocked factorization (ops/gp_hall.py) on the CPU.

The kernels factor one bordered matrix per (output, sample) in panels of 32
columns; the plain version carries the same algorithm with the panel width
as an argument, whose width-1 case is the column sweep of the earlier
design (Schur Cholesky, substitution W L_s^-T, fold, covariance Cholesky),
written out here as the reference.  In float64:

* every panel width agrees with the column sweep at rounding level, at an
  empty, a ragged and a full fill, with Ty > 1;
* a non-positive pivot gives the same NaN pattern at every width and the
  same draws after the non-finite -> mean backstop;
* ``sample_hall`` over outputs stacked on a leading axis equals one
  ``sample_hall_one`` per output;
* the kernels take every fill: the earlier factor CTA's fills keep their
  tiles in shared memory, the others run on the global-tile branch (the
  2D pendulum's Ht = 120 stage at every fill up to its capacity of 360);
  and the Mehrotra kernel's cluster layout keeps the closed loops' QPs
  resident in shared memory.
"""

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch.ops import build, gp_hall, ipm
from sampling_gpmpc_torch.ops.gp_sample import (chol_right_looking,
                                                override_tail,
                                                subst_right_looking)

SCAL = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5)
NS, HT, RR, RH, TY = 3, 12, 20, 45, 3


def _problem(nh, seed, ns=NS, Ht=HT, Rr=RR, Rh=RH):
    """A hall-block stage from random feature-space covariances (every
    block a true covariance), hall rows past the fill masked as the agent
    masks empty slots; float64."""
    rng = np.random.default_rng(seed)
    F = 2 * (Rr + Rh + Ht)
    P_r = rng.normal(size=(Rr, F)) / np.sqrt(F)
    P_h = rng.normal(size=(ns, Rh, F)) / np.sqrt(F)
    P_t = rng.normal(size=(ns, Ht, F)) / np.sqrt(F)
    m = (np.arange(Rh) < nh).astype(np.float64)
    Linv = np.linalg.inv(np.linalg.cholesky(P_r @ P_r.T + 1e-3 * np.eye(Rr)))
    Ahh = P_h @ np.swapaxes(P_h, 1, 2) + 1e-3 * np.eye(Rh)
    kw = dict(
        Kxr=P_t @ P_r.T, Kxh=(P_t @ np.swapaxes(P_h, 1, 2)) * m,
        Ktt=P_t @ np.swapaxes(P_t, 1, 2),
        Arh=np.einsum("rf,shf->srh", P_r, P_h) * m,
        Ahh=m[:, None] * Ahh * m[None, :] + np.diag(1.0 - m),
        yh=rng.normal(size=(ns, Rh)) * 0.3 * m,
        eps=np.clip(rng.normal(size=(ns, Ht)), -2.5, 2.5), Linv=Linv,
        w_r=Linv @ (rng.normal(size=Rr) * 0.3),
        prior_var=np.full(Ht, 1.0))
    return {k: torch.tensor(v) for k, v in kw.items()}


def _factor_args(kw):
    return {k: kw[k] for k in ("Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh",
                               "Linv", "w_r")}


def _column_sweep(nh, Kxr, Kxh, Ktt, Arh, Ahh, yh, Linv, w_r, jitter):
    """The earlier design's unblocked sweeps: chol(S), W L_s^-T, the fold
    into cov and mean, chol(cov)."""
    Ht = Kxr.shape[1]
    eye = lambda n: torch.eye(n, dtype=Kxr.dtype)
    C = Linv @ Arh[..., :nh]
    Vr = Linv @ Kxr.transpose(1, 2)
    Ct, Vrt = C.transpose(1, 2), Vr.transpose(1, 2)
    S = Ahh[:, :nh, :nh] - Ct @ C + jitter * eye(nh)
    W = torch.cat([Kxh[..., :nh] - Vrt @ C,
                   (yh[:, :nh] - (w_r @ C))[:, None]], dim=1)
    W = subst_right_looking(W, chol_right_looking(S))
    Vh, wh = W[:, :Ht], W[:, Ht]
    cov = Ktt - Vrt @ Vr - Vh @ Vh.transpose(1, 2) + jitter * eye(Ht)
    mean = (Vrt @ w_r[:, None])[..., 0] + (Vh @ wh[..., None])[..., 0]
    var = torch.diagonal(cov, dim1=-2, dim2=-1) - jitter
    return chol_right_looking(cov), mean, var


def _draw(L, mean, var, kw, ty=TY):
    y = mean + (L @ kw["eps"][..., None])[..., 0]
    return override_tail(mean, y, var, kw["prior_var"], SCAL["beta"],
                         SCAL["var_zero"], SCAL["rel_floor"], ty)


@pytest.mark.parametrize("panel", [1, 8, 32])
@pytest.mark.parametrize("nh", [0, 13, RH])
def test_blocked_factor_matches_column_sweep(nh, panel):
    """Empty, ragged (13 is no multiple of 8 or 32) and full fills, Ty = 3:
    the blocked factor, mean, variance and draws agree with the column
    sweep in float64 at rounding level."""
    kw = _problem(nh, seed=nh + panel)
    L, mean, var = gp_hall.bordered_factor(nh, **_factor_args(kw),
                                           jitter=SCAL["jitter"], panel=panel)
    L0, mean0, var0 = _column_sweep(nh, **_factor_args(kw),
                                    jitter=SCAL["jitter"])
    for got, ref in ((L, L0), (mean, mean0), (var, var0)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12)
    dg = gp_hall.sample_hall_plain(nh, **kw, **SCAL, ty=TY, panel=panel)
    np.testing.assert_allclose(dg.numpy(), _draw(L0, mean0, var0, kw).numpy(),
                               rtol=0, atol=1e-12)
    assert np.isfinite(dg.numpy()).all()
    # the draw follows eps: the bar above is far below a mean-only result
    assert float((dg - mean0).abs().max()) > 1e-3


@pytest.mark.parametrize("panel", [1, 8, 32])
def test_nonpositive_pivot_same_nan_pattern_and_backstop(panel):
    """A covariance pivot that goes negative (sample 0, column 7): NaN from
    that column on, in the same entries at every panel width as in the
    column sweep, and those rows' draws fall back to the finite mean; a
    Schur pivot that goes negative (sample 1, hall column 5) turns that
    sample's factor, mean and draws NaN alike."""
    nh, j0, h0 = 30, 7, 5
    kw = _problem(nh, seed=4)
    kw["Ktt"][0, j0, j0] -= 10.0
    kw["Ahh"][1, h0, h0] = -1.0
    L, mean, var = gp_hall.bordered_factor(nh, **_factor_args(kw),
                                           jitter=SCAL["jitter"], panel=panel)
    L0, mean0, var0 = _column_sweep(nh, **_factor_args(kw),
                                    jitter=SCAL["jitter"])
    for got, ref in ((L, L0), (mean, mean0), (var, var0)):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        fin = torch.isfinite(ref)
        np.testing.assert_allclose(got[fin].numpy(), ref[fin].numpy(),
                                   rtol=0, atol=1e-12)
    assert bool(torch.isnan(L[0, j0:, j0]).all())
    assert not bool(torch.isnan(L[0, :, :j0]).any())
    low = torch.tril(torch.ones(HT, HT, dtype=torch.bool))
    assert bool(torch.isnan(L[1][low]).all()) and bool(torch.isnan(mean[1]).all())
    dg = gp_hall.sample_hall_plain(nh, **kw, **SCAL, ty=TY, panel=panel)
    ref = _draw(L0, mean0, var0, kw)
    assert torch.equal(torch.isnan(dg), torch.isnan(ref))
    assert torch.equal(dg[0, j0:], mean[0, j0:])          # the backstop
    assert bool(torch.isfinite(dg[0]).all())
    assert bool(torch.isnan(dg[1]).all())
    np.testing.assert_allclose(dg[2].numpy(), ref[2].numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("overrides", [False, True])
def test_stacked_outputs_equal_one_call_per_output(overrides):
    """sample_hall over three outputs stacked on a leading axis (each its
    own Linv, w_r and prior variances) equals sample_hall_one per output,
    with and without the min-dist override rows."""
    nh = 13
    kws = [_problem(nh, seed=10 + o) for o in range(3)]
    kws[1]["prior_var"] = kws[1]["prior_var"] * 0.5
    if overrides:
        rng = np.random.default_rng(5)
        for kw in kws:
            kw["close"] = torch.tensor(
                (rng.uniform(size=(NS, HT)) < 0.2).astype(np.float64))
            kw["ynear"] = torch.tensor(rng.normal(size=(NS, HT)) * 1e-3)
    stacked = {k: torch.stack([kw[k] for kw in kws]) for k in kws[0]}
    got = gp_hall.sample_hall(nh, **stacked, **SCAL, ty=TY)
    assert got.shape == (3, NS, HT)
    for o, kw in enumerate(kws):
        assert torch.equal(got[o],
                           gp_hall.sample_hall_one(nh, **kw, **SCAL, ty=TY))


def _earlier_factor_smem(Ht, nh):
    """Shared memory of the earlier factor CTA (S, W and the covariance as
    padded squares)."""
    return 4 * (nh * (nh + 1) + (Ht + 1) * (nh + 1) + Ht * (Ht + 1)
                + 2 * Ht + 2 * max(nh, Ht))


@pytest.mark.parametrize("Ht", [1, 12, 51, 60, 120, 200, 235])
def test_hall_check_supported_no_tighter(Ht):
    """Every fill the earlier factor CTA took is still taken, with its
    tiles in shared memory (the lower tiles of the bordered matrix take
    less than three padded squares); every other fill up to the capacity
    is taken too, on the global-tile branch."""
    taken = 0
    for nh in range(0, 400):
        gp_hall.check_supported(Ht, 180, 400, nh, torch.float32)
        if _earlier_factor_smem(Ht, nh) <= build.SMEM_MAX:
            assert not gp_hall.factor_tiles_global(Ht, nh)
            taken += 1
    assert taken > 0
    # at the car's Ht = 60 the shared branch ends at nh = 224 (earlier
    # design's limit: 201); nh = 225 runs with its tiles in the workspace
    if Ht == 60:
        gp_hall.check_supported(60, 180, 240, 224, torch.float32)
        assert not gp_hall.factor_tiles_global(60, 224)
        gp_hall.check_supported(60, 180, 240, 225, torch.float32)
        assert gp_hall.factor_tiles_global(60, 225)
        tiles = gp_hall.factor_tile_floats(60, 225)
        assert (gp_hall.workspace_floats(20, 60, 180, 225)
                - gp_hall.workspace_floats(20, 60, 180, 224)) > 20 * tiles


@pytest.mark.parametrize("nU,m_h,m_s,resident", [
    (17, 7174, 70, True),        # pendulum (ns=70, H=17)
    (30, 60, 2480, True),        # car
    (20, 52000, 512, False),     # pendulum width at ns=512
    (64, 4000, 400, True),       # the chip checks' wide Schur matrices
    (64, 30000, 1000, False),
    (128, 1500, 200, True),
    (128, 20000, 1000, False),
    (128, 100000, 5000, False),  # the widest Schur matrix
    (128, 1, 1, True),
    (1, 1, 1, True),
    (30, 2460, 0, True),         # hard-only: params_pendulum
    (1, 2002, 0, True),          # params_pendulum_samples
    (100, 800, 0, True),         # params_car_residual: 108,632 B
    (20, 52000, 0, False),
])
def test_ipm_loop_layout(nU, m_h, m_s, resident):
    """The closed loops' QPs keep their G slices and state rows in shared
    memory on the 16-CTA cluster; a wide QP streams them; every layout fits
    one CTA's shared memory."""
    lay = ipm.loop_layout(nU, m_h, m_s)
    assert lay.resident == resident
    assert lay.smem <= build.SMEM_MAX
    if not resident:
        assert lay.chunk >= 16


@pytest.mark.parametrize("nh", [0, 120, 240, 360])
def test_hall_branch_at_the_pendulum_shape(nh):
    """The 2D pendulum's stage (Ht = 120, Rr = 180, Rh = 360): nh = 0 and
    120 keep the tiles in shared memory (153,504 B at 120), the fills the
    earlier design refused (240: 330,912 B; 360) run with their tiles in
    the workspace (574,464 B a sample at nh = 360)."""
    gp_hall.check_supported(120, 180, 360, nh, torch.float32)
    glob = gp_hall.factor_tiles_global(120, nh)
    assert glob == (nh >= 240)
    assert glob == (gp_hall.factor_smem_bytes(120, nh) > build.SMEM_MAX)
    if nh == 360:
        assert 4 * gp_hall.factor_tile_floats(120, nh) == 574464
