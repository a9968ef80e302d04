"""Structured soft QP and condensing of the PyTorch port vs the JAX package.

* the plain ``solve_qp_soft`` agrees with JAX's in float64 on random
  problems (same algorithm, same exit: 1e-8 on the solution), and with JAX
  and the native C++ solver on the committed hard car instance
  ``tests/goldens/qp_car_h100.npz`` (nU=200, 400 hard and 5010 soft rows);
* the plain IPM (``ops/ipm.run_full`` on CPU tensors) agrees with the Pallas
  ``pallas_ipm.run_full`` in interpret mode at the tests/test_pallas_ipm.py
  shape, cold and warm started, in float32;
* both condensing forms agree with each other and with JAX.
"""

import jax.numpy as jnp
import numpy as np
import os
import pytest
import torch

from sampling_gpmpc_tpu.ocp import condense as jcondense
from sampling_gpmpc_tpu.ocp import qp as jqp
from sampling_gpmpc_tpu.ops import pallas_ipm
from sampling_gpmpc_torch import convert
from sampling_gpmpc_torch.ocp import condense as tcondense
from sampling_gpmpc_torch.ocp import qp as tqp
from sampling_gpmpc_torch.ops import ipm

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "qp_car_h100.npz")


def _rand_soft(seed, nU=6, mh=10, ms=5, tight=True):
    """The problem family of tests/test_pallas_ipm.py."""
    rng = np.random.default_rng(seed)
    Hh = rng.normal(size=(nU, nU))
    H = Hh @ Hh.T + np.eye(nU)
    g = rng.normal(size=nU) * 3
    G_h = rng.normal(size=(mh, nU))
    d_h = rng.uniform(0.1, 1.5, size=mh)
    G_s = rng.normal(size=(ms, nU))
    lo = rng.uniform(-0.5, -0.1, size=ms)
    hi = rng.uniform(0.05, 0.3 if tight else 2.0, size=ms)
    zl, zu = np.full(ms, 3.0), np.full(ms, 2.0)
    Zl, Zu = np.full(ms, 5.0), np.full(ms, 4.0)
    return (H, g, G_h, d_h, G_s, lo, hi, zl, zu, Zl, Zu)


def _jax(args, dtype):
    return [jnp.asarray(a, dtype) for a in args]


def _torch(args, dtype):
    return [torch.as_tensor(np.array(a), dtype=dtype) for a in args]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_qp_matches_jax_f64(seed):
    args = _rand_soft(seed, nU=8, mh=14, ms=6)
    ref = jqp.solve_qp_soft(*_jax(args, jnp.float64))
    got = tqp.solve_qp_soft(*_torch(args, torch.float64))
    assert int(ref.status) == int(got.status) == 0
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), atol=1e-8)
    assert abs(int(got.iters) - int(ref.iters)) <= 1
    # warm start from the previous solution on a perturbed problem
    args2 = list(args)
    args2[1] = args[1] + 1e-3
    ref_w = jqp.solve_qp_soft(*_jax(args2, jnp.float64), ws=ref.state,
                              ws_valid=jnp.asarray(True))
    got_w = tqp.solve_qp_soft(*_torch(args2, torch.float64),
                              ws=convert.qp_warm_start(
                                  [np.asarray(a) for a in ref.state], "cpu",
                                  torch.float64),
                              ws_valid=torch.tensor(True))
    assert int(got_w.status) == 0
    np.testing.assert_allclose(got_w.z.numpy(), np.asarray(ref_w.z),
                               atol=1e-8)
    assert abs(int(got_w.iters) - int(ref_w.iters)) <= 1


def test_plain_qp_on_hard_car_instance():
    """The hard long-horizon car QP: the port, JAX's XLA path and the
    native C++ solver all solve it; solutions agree to the instance's
    stored reference tolerance (test_qp.py: 1e-5 * scale)."""
    from sampling_gpmpc_tpu.native import solve_qp_soft_native
    d = np.load(GOLDEN)
    keys = ("H", "g", "Gh", "dh", "Gs", "lo", "hi", "zl", "zu", "Zl", "Zu")
    args = [d[k] for k in keys]
    got = tqp.solve_qp_soft(*_torch(args, torch.float64))
    assert int(got.status) == 0, (float(got.gap), int(got.iters))
    scale = max(1.0, float(np.abs(d["u_ref"]).max()))
    np.testing.assert_allclose(got.z.numpy(), d["u_ref"], atol=1e-5 * scale)
    ref = jqp.solve_qp_soft(*_jax(args, jnp.float64))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z),
                               atol=1e-5 * scale)
    u_n, _, _, status = solve_qp_soft_native(*args)
    assert status == 0
    np.testing.assert_allclose(got.z.numpy(), u_n, atol=1e-5 * scale)


def _run_full_both(args, monkeypatch, ws=None):
    """pallas_ipm.run_full (interpret) and ops/ipm.run_full (plain, CPU) on
    the same float32 problem; the JAX qp module's constants on both."""
    kw = dict(tol=3e-5, reg=1e-7, max_iter=150,
              stall_iters=jqp.STALL_ITERS, stall_rtol=jqp.STALL_RTOL,
              mu_grind=jqp.MU_GRIND, ws_band=jqp.WS_BAND)
    monkeypatch.setattr(pallas_ipm, "_INTERPRET", True)
    jws = None if ws is None else [jnp.asarray(a, jnp.float32) for a in ws]
    ref = pallas_ipm.run_full(*_jax(args, jnp.float32), jws,
                              None if ws is None else jnp.asarray(True), **kw)
    tws = None if ws is None else tuple(_torch(ws, torch.float32))
    got = ipm.run_full(*_torch(args, torch.float32), tws,
                       None if ws is None else torch.tensor(True), **kw)
    return ref, got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_ipm_matches_pallas_interpret(seed, monkeypatch):
    args = _rand_soft(seed)
    (jb, jres, jit, jsh, jss), (tb, tres, tit, tsh, tss) = _run_full_both(
        args, monkeypatch)
    # identical equilibration (elementwise ops)
    np.testing.assert_allclose(tsh.numpy(), np.asarray(jsh), rtol=1e-6)
    np.testing.assert_allclose(tss.numpy(), np.asarray(jss), rtol=1e-6)
    # same algorithm in f32: same iteration count up to rounding, both
    # converged, u within the f32 solution noise test_pallas_ipm allows
    assert float(jres) <= 3e-5 and float(tres) <= 3e-5
    assert abs(int(tit) - int(jit)) <= 2
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb[0]), atol=2e-3)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-2,
                                   rtol=5e-2)


def test_plain_ipm_warm_start_matches_pallas_interpret(monkeypatch):
    args = _rand_soft(4)
    sol0 = jqp.solve_qp_soft(*_jax(args, jnp.float32))
    args2 = list(args)
    args2[1] = np.asarray(args[1]) + 1e-3
    ws = [np.asarray(a) for a in sol0.state]
    (jb, jres, jit, _, _), (tb, tres, tit, _, _) = _run_full_both(
        args2, monkeypatch, ws=ws)
    assert float(jres) <= 3e-5 and float(tres) <= 3e-5
    assert abs(int(tit) - int(jit)) <= 2
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb[0]), atol=2e-4)


def test_ipm_gate(monkeypatch):
    """The kernels' limits raise, naming the limit: float64, no hard rows
    (the Pallas path cannot take m_h = 0 either) and nU > 256; the
    flagship QP is inside them, and so are the hard-only QPs (m_s = 0) of
    the pendulum configs and the residual car, which pallas_ipm.fused_ok
    leaves to the XLA body and the kernels take in their hard-only
    build, and the wide QPs (128 < nU <= 256: params_car_samples' nU =
    200, the drone's optimistic nU = 240), which the wide builds take."""
    for args, limit in (((6, 10, 5, torch.float64), "float32"),
                        ((6, 10, 0, torch.float64), "float32"),
                        ((6, 0, 5, torch.float32), "m_h"),
                        ((6, 0, 0, torch.float32), "m_h"),
                        ((257, 10, 5, torch.float32), "nU"),
                        ((257, 10, 0, torch.float32), "nU")):
        with pytest.raises(ValueError, match=limit):
            ipm.check_supported(*args)
    ipm.check_supported(17, 7174, 70, torch.float32)
    for nU, m_s in ((129, 0), (200, 5010), (240, 0), (256, 5)):
        ipm.check_supported(nU, 400, m_s, torch.float32)
    monkeypatch.setattr(pallas_ipm, "_INTERPRET", True)   # the gate's shapes
    assert pallas_ipm.fused_ok(17, 7174, 70, jnp.float32)
    for nU, m_h in ((30, 2460), (1, 2002), (1, 202), (100, 800)):
        ipm.check_supported(nU, m_h, 0, torch.float32)
        assert not pallas_ipm.fused_ok(nU, m_h, 0, jnp.float32)


def test_condense_forms_match_each_other_and_jax():
    rng = np.random.default_rng(11)
    ns, H, nx, nu = 3, 7, 4, 2
    A = rng.normal(size=(ns, H, nx, nx)) * 0.4
    B = rng.normal(size=(ns, H, nx, nu))
    r = rng.normal(size=(ns, H, nx))
    dx0 = rng.normal(size=(ns, nx))
    T1, G1 = tcondense.condense(*_torch((A, B, r, dx0), torch.float64))
    T2, G2 = tcondense.condense_parallel(*_torch((A, B, r, dx0),
                                                 torch.float64))
    Tj, Gj = jcondense.condense_parallel(*_jax((A, B, r, dx0), jnp.float64))
    for got in (T1, T2):
        np.testing.assert_allclose(got.numpy(), np.asarray(Tj), rtol=1e-10,
                                   atol=1e-12)
    for got in (G1, G2):
        np.testing.assert_allclose(got.numpy(), np.asarray(Gj), rtol=1e-10,
                                   atol=1e-12)
