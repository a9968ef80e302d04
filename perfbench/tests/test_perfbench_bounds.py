"""The copied bound arithmetic reproduces the bench-shape bounds that
PERF.md records (params_pendulum1D_samples at H = 20, QP nU = 20, and
params_car_samples' GP stages)."""

import pytest

from perfbench import bounds

MS = 1e3


@pytest.mark.parametrize("ns, m_h, m_s, nbytes, flops, ms", [
    (64, 7720, 64, 1_470_792, 1.557e6, 0.00044),
    (512, 61480, 512, 11_701_320, 1.240e7, 0.00349)])
def test_prepare_at_the_bench_shapes(ns, m_h, m_s, nbytes, flops, ms):
    b, f = bounds.prepare_bound(20, m_h, m_s)
    assert b == nbytes and f == pytest.approx(flops, rel=1e-3)
    assert MS * bounds.bound_s(b, f) == pytest.approx(ms, rel=0.01)


@pytest.mark.parametrize("m_h, m_s, iters, nbytes, flops, ms", [
    (7720, 64, 23, 815_916, 1.505e8, 0.00225),
    (61480, 512, 26, 6_485_804, 1.354e9, 0.02021)])
def test_mehrotra_at_the_bench_shapes(m_h, m_s, iters, nbytes, flops, ms):
    b, f = bounds.mehrotra_bound(20, m_h, m_s, iters)
    assert b == nbytes and f == pytest.approx(flops, rel=1e-3)
    assert MS * bounds.bound_s(b, f) == pytest.approx(ms, rel=0.01)


@pytest.mark.parametrize("ns, Ht, R, nbytes, ms", [
    (64, 60, 108, 2_658_528, 0.00180),
    (512, 60, 108, 20_936_928, 0.01439)])
def test_gp_sample_at_the_bench_shapes(ns, Ht, R, nbytes, ms):
    b, f = bounds.gp_sample_bound(ns, Ht, R)
    assert b == nbytes
    assert MS * bounds.bound_s(b, f) == pytest.approx(ms, rel=0.01)


@pytest.mark.parametrize("nh, ms", [(400, 0.34943), (800, 0.76396),
                                    (1200, 1.41477)])
def test_gp_hall_at_car_samples(nh, ms):
    b, f = bounds.gp_hall_bound(10, 400, 448, nh)
    assert MS * bounds.bound_s(3 * b, 3 * f) == pytest.approx(ms, rel=1e-3)


def test_step_bounds_sum_the_stages():
    sizes = dict(ns=10, H=100, Ty=4, g_ny=3, R=448, nU=200, m_h=400,
                 m_s=5010)
    gp = bounds.gp_step_s(sizes, 4) * MS
    assert gp == pytest.approx(0.11385 + 0.34943 + 0.76396 + 1.41477,
                               rel=1e-3)
    one = bounds.qp_step_s(sizes, 1, 8)
    assert bounds.qp_step_s(sizes, 4, 32) == pytest.approx(4 * one)
    assert bounds.qp_step_s(sizes, 0, 0) == 0.0
