"""The IPM prepare stage alone: the port's plain version against the TPU
kernel, and the prepare kernel's layout.

* ``ops/ipm.prepare_plain`` against ``pallas_ipm._prepare_kernel`` run in
  interpret mode, built as ``pallas_ipm.run_full`` builds it, on the same
  float32 inputs made with numpy: every output field (the scaled and
  transposed G, the d_h and soft rows, qscale, the row scales, the start
  h0/s0 with the TPU padding dropped) and the warm/cold choice, cold and
  warm, with an accepted warm start, one rejected by the staleness test
  (rq >= 1e-2), one flagged invalid, and the committed car QP
  ``tests/goldens/qp_car_h100.npz``;
* ``ops/ipm.prepare_layout``: the cluster's row slices tile the rows, both
  closed loops' QPs keep their slices in shared memory, the wide seeded
  QPs stream them, and every shape the TPU gate takes gets a layout within
  one CTA's shared memory.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sampling_gpmpc_tpu.ocp import qp as jqp
from sampling_gpmpc_tpu.ops import pallas_ipm
from sampling_gpmpc_torch.ops import build, ipm

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "qp_car_h100.npz")
# Elementwise fields are the same float32 operations on both sides; the
# warm start also goes through tau = rq (a max over a matvec, summed in
# another order by XLA's dot and torch's matmul: ~1e-7 relative), so every
# field is held to 1e-6 of its largest magnitude.
RTOL = 1e-6


def _rand_soft(seed, nU=6, mh=10, ms=5):
    """The problem family of tests/test_pallas_ipm.py (float64 numpy)."""
    rng = np.random.default_rng(seed)
    Hh = rng.normal(size=(nU, nU))
    return (Hh @ Hh.T + np.eye(nU), rng.normal(size=nU) * 3,
            rng.normal(size=(mh, nU)), rng.uniform(0.1, 1.5, size=mh),
            rng.normal(size=(ms, nU)), rng.uniform(-0.5, -0.1, size=ms),
            rng.uniform(0.05, 2.0, size=ms), np.full(ms, 3.0),
            np.full(ms, 2.0), np.full(ms, 5.0), np.full(ms, 4.0))


def _pallas_prepare(args, ws, ws_valid, ws_band=jqp.WS_BAND):
    """pallas_ipm._prepare_kernel on padded inputs, as pallas_ipm.run_full
    builds the call; returns its outputs with the padding dropped, as numpy:
    (Gth, Gts, dh, sd, h0, s0, qscale, sch, scs)."""
    f32 = jnp.float32
    H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu = [
        jnp.asarray(a, f32) for a in args]
    nU, m_h, m_s = g.shape[0], d_h.shape[0], lo_s.shape[0]
    L = pallas_ipm.LANES
    nU_p = max(8, -(-nU // 8) * 8)
    m_hp, m_sp = -(-m_h // L) * L, -(-m_s // L) * L

    def padr(rows, m, m_p):
        return jnp.pad(jnp.stack([jnp.asarray(r, f32) for r in rows]),
                       ((0, 0), (0, m_p - m)))

    Hp = jnp.zeros((nU_p, nU_p), f32).at[:nU, :nU].set(H)
    Hp = Hp + jnp.diag(jnp.arange(nU_p) >= nU).astype(f32)
    gpr = padr([g], nU, nU_p)
    Gthr = jnp.pad(G_h.T, ((0, nU_p - nU), (0, m_hp - m_h)))
    dhr = padr([d_h], m_h, m_hp)
    mh = jnp.zeros((1, m_hp), f32).at[0, :m_h].set(1.0)
    Gtsr = jnp.pad(G_s.T, ((0, nU_p - nU), (0, m_sp - m_s)))
    sr = padr([lo_s, hi_s, zl, zu, Zl, Zu, jnp.ones((m_s,), f32)], m_s, m_sp)
    if ws is None:
        uw, lhw = jnp.zeros((1, nU_p), f32), jnp.zeros((1, m_hp), f32)
        sw, flv = jnp.zeros((6, m_sp), f32), jnp.zeros((), f32)
    else:
        (u_w, sl_w, su_w, _, lh_w, _, lU_w, _, lL_w, nl_w, nu_w) = ws
        uw, lhw = padr([u_w], nU, nU_p), padr([lh_w], m_h, m_hp)
        sw = padr([sl_w, su_w, lU_w, lL_w, nl_w, nu_w], m_s, m_sp)
        flv = jnp.asarray(ws_valid).astype(f32)
    vspec = lambda: pl.BlockSpec(memory_space=pltpu.VMEM)
    sspec = lambda: pl.BlockSpec(memory_space=pltpu.SMEM)
    prep = pl.pallas_call(
        functools.partial(pallas_ipm._prepare_kernel, m_total=m_h + 4 * m_s,
                          ws_floor=float(ws_band[0]),
                          ws_cap=float(ws_band[1])),
        in_specs=[vspec()] * 10 + [sspec()],
        out_specs=[vspec()] * 7 + [sspec()] + [vspec()] * 2,
        out_shape=[jax.ShapeDtypeStruct((nU_p, m_hp), f32),
                   jax.ShapeDtypeStruct((nU_p, m_sp), f32),
                   jax.ShapeDtypeStruct((2, m_hp), f32),
                   jax.ShapeDtypeStruct((8, m_sp), f32),
                   jax.ShapeDtypeStruct((1, nU_p), f32),
                   jax.ShapeDtypeStruct((2, m_hp), f32),
                   jax.ShapeDtypeStruct((8, m_sp), f32),
                   jax.ShapeDtypeStruct((1,), f32),
                   jax.ShapeDtypeStruct((1, m_hp), f32),
                   jax.ShapeDtypeStruct((1, m_sp), f32)],
        interpret=pallas_ipm._INTERPRET)
    Gth, Gts, dh, sd, _, h0, s0, qs, sch, scs = [
        np.asarray(o) for o in prep(Hp, gpr, Gthr, dhr, mh, Gtsr, sr, uw, lhw,
                                    sw, flv.reshape(1, 1))]
    return (Gth[:nU, :m_h], Gts[:nU, :m_s], dh[:, :m_h], sd[:, :m_s],
            h0[:, :m_h], s0[:, :m_s], qs[0], sch[0, :m_h], scs[0, :m_s])


def _compare(args, ws=None, ws_valid=None):
    """prepare_plain (float32, CPU) against the Pallas kernel, every field
    within RTOL of its largest magnitude and the same start; returns the
    plain version's choice."""
    t32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)
    tws = None if ws is None else tuple(t32(a) for a in ws)
    tvalid = None if ws is None else torch.tensor(bool(ws_valid))
    p = ipm.prepare_plain(*[t32(a) for a in args], tws, tvalid, jqp.WS_BAND)
    (Gth, Gts, dh, sd, h0, s0, qs, sch, scs) = _pallas_prepare(
        args, ws, ws_valid)
    s = p.st0
    inv = lambda x: 1.0 / (1.0 + torch.abs(x))
    fields = [("G_h", p.G_h.T, Gth), ("G_s", p.G_s.T, Gts),
              ("d_h", p.d_h, dh[0]), ("1/(1+|d_h|)", inv(p.d_h), dh[1]),
              ("qscale", p.qscale, qs), ("scale_h", p.scale_h, sch),
              ("scale_s", p.scale_s, scs),
              ("th", s[3], h0[0]), ("lh", s[4], h0[1])]
    soft = (p.lo_s, p.hi_s, p.zl, p.zu, p.Zl, p.Zu, inv(p.hi_s),
            inv(p.lo_s))
    fields += [(f"sd[{k}]", v, sd[k]) for k, v in enumerate(soft)]
    # s0 rows: tU tL sl su lU lL nl nu; the 11-tuple: u sl su th lh tU lU tL
    # lL nl nu
    fields += [(f"s0[{k}]", s[i], s0[k])
               for k, i in enumerate((5, 7, 1, 2, 6, 8, 9, 10))]
    for name, got, ref in fields:
        ref = np.asarray(ref, np.float64)
        err = np.max(np.abs(got.numpy().astype(np.float64) - ref))
        assert err <= RTOL * max(np.max(np.abs(ref)), 1e-30), (name, err)
    # the Pallas kernel's choice: its start differs from its cold start
    cold = _pallas_prepare(args, None, None)
    warm_j = not (np.array_equal(h0, cold[4]) and np.array_equal(s0, cold[5]))
    warm_p = p.warm is not None and bool(p.warm)
    assert warm_p == warm_j
    return warm_p


def _staleness(args, ws):
    """rq of a carried pair, in float64: the stationarity of (u_w, lam_w)
    under the data, over qscale (the row scaling cancels in G' lam)."""
    H, g, G_h, _, G_s, *_ = args
    u, lh, lU, lL = ws[0], ws[4], ws[6], ws[8]
    scs = np.maximum(np.max(np.abs(G_s), axis=1), 1e-10)
    qscale = 1.0 + np.max(np.abs(g)) + max(np.max(args[7] * scs), 0.0)
    r = H @ u + g + G_h.T @ lh + G_s.T @ (lU - lL)
    return np.max(np.abs(r)) / qscale


def _solved(args, dg):
    """The float32 JAX solve's state of a QP, and the QP with g moved."""
    sol = jqp.solve_qp_soft(*[jnp.asarray(a, jnp.float32) for a in args])
    assert int(sol.status) == 0
    moved = list(args)
    moved[1] = np.asarray(args[1]) + dg
    return moved, [np.asarray(a, np.float64) for a in sol.state]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_ipm, "_INTERPRET", True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepare_plain_matches_pallas_cold(seed, interpret):
    assert not _compare(_rand_soft(seed))


@pytest.mark.parametrize("seed", [3, 4])
def test_prepare_plain_matches_pallas_warm_accepted(seed, interpret):
    moved, ws = _solved(_rand_soft(seed), 1e-3)
    assert _staleness(moved, ws) < 1e-2
    assert _compare(moved, ws, True)


def test_prepare_plain_matches_pallas_stale_warm_start(interpret):
    """g moved by 5: the carried pair's staleness rq >= 1e-2 rejects it."""
    moved, ws = _solved(_rand_soft(4), 5.0)
    assert _staleness(moved, ws) >= 1e-2
    assert not _compare(moved, ws, True)


def test_prepare_plain_matches_pallas_invalid_warm_start(interpret):
    """A fresh carried pair flagged invalid: the cold start."""
    moved, ws = _solved(_rand_soft(4), 1e-3)
    assert not _compare(moved, ws, False)


def test_prepare_plain_matches_pallas_car_golden(interpret):
    """The committed car QP (nU=200, 400 hard and 5010 soft rows), cold,
    then warm from its reference solution's state carried to g + 1e-3."""
    d = np.load(GOLDEN)
    args = [d[k] for k in ("H", "g", "Gh", "dh", "Gs", "lo", "hi", "zl",
                           "zu", "Zl", "Zu")]
    assert not _compare(args)
    # a carried pair from a float64 solve (the float32 one does not
    # converge on this hard instance)
    sol = jqp.solve_qp_soft(*[jnp.asarray(a, jnp.float64) for a in args])
    assert int(sol.status) == 0
    moved = list(args)
    moved[1] = args[1] + 1e-3
    ws = [np.asarray(a) for a in sol.state]
    _compare(moved, ws, True)


@pytest.mark.parametrize("m", [1, 5, 15, 16, 17, 60, 70, 2480, 7174, 52000])
def test_row_slices_tile_the_rows(m):
    """Contiguous slices in rank order covering [0, m) once, each of at
    most ceil(m / 16) rows (the layouts' bound), sizes within one of each
    other; for m < 16, 16 - m ranks hold no row."""
    # csrc/ipm.cu row_slice: rank r owns [m r / 16, m (r + 1) / 16)
    sl = [(m * r // ipm.CLUSTER, m * (r + 1) // ipm.CLUSTER)
          for r in range(ipm.CLUSTER)]
    assert len(sl) == ipm.CLUSTER
    assert sl[0][0] == 0 and sl[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    sizes = [b - a for a, b in sl]
    assert max(sizes) <= -(-m // ipm.CLUSTER)
    assert max(sizes) - min(sizes) <= 1
    assert sizes.count(0) == max(0, ipm.CLUSTER - m)


@pytest.mark.parametrize("nU,m_h,m_s,resident", [
    (17, 7174, 70, True),       # pendulum loop
    (30, 60, 2480, True),       # car loop
    (64, 4000, 400, True),      # chip_smoke's wide Schur QPs
    (20, 52000, 512, False),    # chip_smoke.WIDE_QP
    (128, 20000, 1000, False),
])
def test_prepare_layout_branches(nU, m_h, m_s, resident):
    """Both closed loops' QPs keep the prepare kernel's slices in shared
    memory; the wide seeded QPs stream them, as the loop kernel does."""
    lay = ipm.prepare_layout(nU, m_h, m_s)
    assert lay.resident == resident
    assert lay.resident == ipm.loop_layout(nU, m_h, m_s).resident
    assert lay.smem <= build.SMEM_MAX
    if resident:   # one chunk is the larger slice
        assert lay.chunk == max(-(-m_h // 16), -(-m_s // 16))
    else:
        assert 32 <= lay.chunk <= 1024


def test_prepare_layout_takes_every_gated_shape(monkeypatch):
    """Every float32 shape pallas_ipm.fused_ok takes (with m_h >= 1, as
    check_supported asks) gets a layout within one CTA's shared memory."""
    monkeypatch.setattr(pallas_ipm, "_INTERPRET", True)
    n = 0
    for nU in (1, 2, 7, 17, 20, 30, 33, 64, 100, 127, 128):
        for m_h in (1, 5, 15, 16, 17, 60, 1000, 7174, 52000, 150000, 400000):
            for m_s in (1, 3, 15, 70, 512, 2480, 20000, 100000):
                if not pallas_ipm.fused_ok(nU, m_h, m_s, jnp.float32):
                    continue
                ipm.check_supported(nU, m_h, m_s, torch.float32)
                lay = ipm.prepare_layout(nU, m_h, m_s)
                assert lay.smem <= build.SMEM_MAX, (nU, m_h, m_s, lay)
                assert lay.chunk >= 1
                n += 1
    assert n > 400
