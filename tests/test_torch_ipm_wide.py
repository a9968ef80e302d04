"""The wide QPs (128 < nU <= 256) of the IPM kernels' wide builds, on the
CPU: the plain IPM (``ops/ipm.run_full_plain``, the kernels' plain
version, shape-generic) against the XLA body of the JAX package's
``ocp/qp.py::solve_qp_soft`` (which takes every wide QP: its Pallas gate
refuses nU > 128), and the wide layouts, limits and routing of
``ops/ipm.py``.  The kernels themselves run on the GPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu.ocp import qp as jqp
from sampling_gpmpc_tpu.ops import pallas_ipm
from sampling_gpmpc_torch.ocp import qp as tqp
from sampling_gpmpc_torch.ops import build, ipm

F64 = torch.float64
QP_TOL = 1e-8


def _both(qp_args, ws):
    """The port's plain solver and JAX's XLA body on the same QP."""
    wv = None if ws is None else torch.tensor(True)
    got = tqp.solve_qp_soft(*qp_args, ws=ws, ws_valid=wv)
    j = lambda a: jnp.asarray(a.numpy())
    ref = jqp.solve_qp_soft(*map(j, qp_args),
                            ws=None if ws is None else tuple(map(j, ws)),
                            ws_valid=None if ws is None else jnp.asarray(True))
    return got, ref


@pytest.mark.parametrize("nU,m_h,m_s", [
    (129, 600, 300),     # the narrowest wide QP
    (200, 400, 5010),    # params_car_samples' row counts
    (240, 840, 0),       # the drone's optimistic planner (hard-only)
    (256, 1000, 400),    # the widest
])
def test_plain_ipm_wide_matches_jax_xla(nU, m_h, m_s):
    """Seeded QPs of the kernels' family in float64, cold, then warm from
    the solution carried to g moved by 1e-3: the same status, iterations,
    iterate (1e-8 of each field's scale) and residual."""
    qp_args = ipm.seeded_qp(nU, m_h, m_s, 4, "cpu", F64)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got, ref = _both(qp_args, None)
        moved = list(qp_args)
        moved[1] = qp_args[1] + 1e-3
        got_w, ref_w = _both(moved, got.state)
    finally:
        torch.set_num_threads(old)
    for g, r in ((got, ref), (got_w, ref_w)):
        assert int(g.status) == int(r.status) == 0
        assert int(g.iters) == int(r.iters)
        for a, b in zip(g.state, r.state):
            b = np.asarray(b)
            scale = 1.0 + np.abs(b).max(initial=0.0)
            np.testing.assert_allclose(a.numpy(), b, atol=QP_TOL * scale,
                                       rtol=0)
        assert abs(float(g.gap) - float(r.gap)) <= QP_TOL
    assert int(got_w.iters) < int(got.iters)     # the warm start took


@pytest.mark.parametrize("nU", range(129, 257))
def test_wide_layout_fits(nU):
    """Every wide nU: the loop kernel's tiles, staging area and chunk in
    one CTA's shared memory, at least one tile a group and at most
    GROUP_MAX; the slices streamed whatever the row counts; the prepare
    kernel's layout fits at row counts from 1 to 52,000 (hard-only: m_s =
    0)."""
    t = -(-nU // 32)
    lay = ipm.wide_layout(nU)
    assert lay.smem <= build.SMEM_MAX
    assert 1 <= lay.group <= min(ipm.GROUP_MAX, t * (t + 1) // 2)
    assert not lay.resident and lay.chunk == ipm.WIDE_CHUNK
    # the staging area takes what is left, so one more tile does not fit
    if lay.group < min(ipm.GROUP_MAX, t * (t + 1) // 2):
        assert lay.smem + 4 * ipm.TILE_FLOATS > build.SMEM_MAX
    for m_h in (1, 15, 16, 17, 400, 840, 5010, 52000):
        for m_s in (0, 1, 17, 124, 5010, 52000):
            assert ipm.loop_layout(nU, m_h, m_s) == lay
            play = ipm.prepare_layout(nU, m_h, m_s)
            assert play.smem <= build.SMEM_MAX, (nU, m_h, m_s, play)
            assert play.chunk >= 1


def test_check_supported_takes_the_gated_shapes_and_nu_up_to_256():
    """check_supported takes every float32 shape pallas_ipm.fused_ok takes
    (m_h >= 1) and every nU up to 256, soft or hard-only, and raises at
    257, naming the limit, and for float64."""
    pallas_ipm._INTERPRET = True
    try:
        for nU in (1, 17, 128):
            for m_h in (1, 60, 7174):
                for m_s in (1, 70, 2480):
                    if pallas_ipm.fused_ok(nU, m_h, m_s, jnp.float32):
                        ipm.check_supported(nU, m_h, m_s, torch.float32)
    finally:
        pallas_ipm._INTERPRET = False
    for nU in (129, 200, 240, 256):
        for m_s in (0, 5010):
            ipm.check_supported(nU, 400, m_s, torch.float32)
    with pytest.raises(ValueError, match="nU <= 256"):
        ipm.check_supported(257, 400, 10, torch.float32)
    with pytest.raises(ValueError, match="float32 only"):
        ipm.check_supported(200, 400, 10, torch.float64)


@pytest.mark.parametrize("nU,m_s,lib", [
    (1, 1, "ipm"), (128, 5, "ipm"), (128, 0, "ipm_hard"),
    (129, 5, "ipm_wide"), (256, 5, "ipm_wide"), (129, 0, "ipm_hard_wide"),
    (240, 0, "ipm_hard_wide")])
def test_wide_routing(nU, m_s, lib):
    """nU <= 128 keeps the narrow builds (their layouts as before); the
    wide QPs take the libraries built with IPM_WIDE=1."""
    assert ipm._library(m_s, nU) == lib
    src, flags = build._source(lib)
    assert src.endswith("ipm.cu") and lib in build.SOURCES
    assert ("-DIPM_WIDE=1" in flags) == lib.endswith("_wide")
    assert ("-DIPM_SOFT=0" in flags) == (m_s == 0)
    if nU <= ipm.NU_NARROW:
        assert ipm.loop_layout(nU, 400, m_s).group == 0
