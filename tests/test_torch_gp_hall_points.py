"""The hall stage from the points (``gp_hall.sample_hall_points``) against
the stage from the blocks the agent builds over the whole capacity
(``agent.hall_stage_inputs_all`` + ``gp_hall.sample_hall_plain_stacked``),
on the CPU in float64, where the entry runs its plain version
(``gp_hall.sample_hall_points_plain``: the blocks of the first nh hall
columns by ``gp_hall.hall_blocks_plain``, then the plain factor).

* the draws of every hall stage of one MPC step are the same, bit for bit
  or to 1e-12: ``params_car`` as published at fills 60 / 120 / 180,
  ``params_pendulum1D_samples`` (D = 2, forced to three iterations),
  ``params_car_residual_fs`` (no derivatives: Ty = 1) and
  ``params_pendulum`` (Rh = 360, fills 120 / 240);
* with hall rows that the min-dist filter emptied (NaN), and with the
  min-dist override rows;
* the blocks ``hall_blocks_plain`` returns are the first nh hall columns
  of the agent's, laid out as ``block_views`` reads the kernel's buffer;
* the agent's hall stage on the kernel route takes the entry from the
  points under its spans; inside ``routes.plain_route()`` the entry runs
  its plain version on every device; the entry refuses what its kernel
  cannot take.
"""

import pytest
import torch

from sampling_gpmpc_torch import agent, obs
from sampling_gpmpc_torch.ops import gp_hall, routes
from sampling_gpmpc_torch.parallel.worker import hall_inputs

f64 = torch.float64


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(spec, hyp, gp, Xt, eps, md=None):
    """(from the points, from the agent's blocks) draws of one stage."""
    got = gp_hall.sample_hall_points(
        **agent.hall_point_inputs(spec, hyp, gp, Xt, eps, md))
    ref = gp_hall.sample_hall_plain_stacked(
        **agent.hall_stage_inputs_all(spec, hyp, gp, Xt, eps, md))
    return got, ref


def _same(got, ref):
    assert got.shape == ref.shape
    assert bool(torch.isfinite(ref).all())
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("config,ns,its,fills", [
    ("params_car", 4, 4, [60, 120, 180]),
    ("params_pendulum1D_samples", 4, 3, [51, 102]),
    ("params_car_residual_fs", 3, 3, [1, 2]),
    ("params_pendulum", 2, 3, [120, 240]),
])
def test_points_entry_matches_the_agents_blocks(one_thread, config, ns, its,
                                                fills):
    stages = hall_inputs(config, ns, its, "cpu", f64)
    assert [gp.hall_n * spec.Ty for spec, _, gp, _, _ in stages] == fills
    for spec, hyp, gp, Xt, eps in stages:
        _same(*_both(spec, hyp, gp, Xt, eps))


def test_points_entry_with_filtered_rows(one_thread):
    """Rows the min-dist filter emptied (NaN observations at points that
    stay in the buffer) get zero couplings on both routes, and change the
    draws."""
    spec, hyp, gp, Xt, eps = hall_inputs("params_car", 4, 3, "cpu", f64)[1]
    Y = gp.hall_Y.clone()
    Y[1, 2, 17] = float("nan")
    Y[0, 0, 3] = float("nan")
    Y[3, 1, 29] = float("nan")            # the last filled row
    cut = gp._replace(hall_Y=Y)
    got, ref = _both(spec, hyp, cut, Xt, eps)
    _same(got, ref)
    full, _ = _both(spec, hyp, gp, Xt, eps)
    assert float((full[2, 1] - got[2, 1]).abs().max()) > 1e-9


def test_points_entry_with_min_dist_rows(one_thread):
    """The min-dist override rows pass through in output-major order: they
    move the draws at the rows they mark, and only there."""
    spec, hyp, gp, Xt, eps = hall_inputs("params_car", 4, 3, "cpu", f64)[1]
    g = torch.Generator().manual_seed(5)
    sh = (spec.ns, spec.g_ny, spec.H * spec.Ty)
    md = ((torch.rand(sh, generator=g) < 0.2).to(f64),
          0.01 * torch.randn(sh, generator=g, dtype=f64))
    got, ref = _both(spec, hyp, gp, Xt, eps, md)
    _same(got, ref)
    free, _ = _both(spec, hyp, gp, Xt, eps)
    close = md[0].transpose(0, 1).bool()
    assert bool((got[~close] == free[~close]).all())
    assert not bool((got[close] == free[close]).all())


def test_points_blocks_are_the_filled_columns(one_thread):
    """``hall_blocks_plain`` holds the first nh hall columns of the agent's
    blocks, the eps rows and prior_var, in ``block_views``' layout."""
    spec, hyp, gp, Xt, eps = hall_inputs("params_car", 3, 3, "cpu", f64)[1]
    nh = gp.hall_n * spec.Ty
    assert 0 < nh < gp.hall_Z.shape[2] * spec.Ty
    kw = agent.hall_point_inputs(spec, hyp, gp, Xt, eps)
    got = gp_hall.hall_blocks_plain(
        nh, *(kw[k] for k in ("real_Z", "m_r", "hall_Z", "hall_Y", "Xt",
                              "eps", "lengthscale", "outputscale",
                              "noise_diag")), spec.Ty)
    ref = agent.hall_stage_inputs_all(spec, hyp, gp, Xt, eps)
    cut = dict(Kxr=ref["Kxr"], Kxh=ref["Kxh"][..., :nh], Ktt=ref["Ktt"],
               Arh=ref["Arh"][..., :nh], Ahh=ref["Ahh"][..., :nh, :nh],
               yh=ref["yh"][..., :nh], eps=ref["eps"],
               prior_var=ref["prior_var"])
    assert list(got) == list(cut)
    for k, v in cut.items():
        assert torch.equal(got[k], v), k
    # the kernel's buffer holds them one region after the other
    no, ns, Ht, Rr = got["Kxr"].shape
    n = gp_hall.blocks_floats(no, ns, Ht, Rr, nh)
    assert n == sum(v.numel() for v in got.values())
    buf = torch.cat([v.reshape(-1) for v in got.values()])
    views = gp_hall.block_views(buf, no, ns, Ht, Rr, nh)
    for k, v in views.items():
        assert v.is_contiguous() and torch.equal(v, got[k]), k


def test_agent_hall_stage_takes_the_points_entry(one_thread, monkeypatch):
    """On the kernel route the agent's hall stage is one call of the entry
    from the points, under ``gp.hall.inputs`` / ``gp.hall.kernel``, and its
    draws are the plain route's."""
    spec, hyp, gp, Xt, eps = hall_inputs("params_car", 3, 3, "cpu", f64)[1]
    seen = []
    orig = gp_hall.sample_hall_points
    monkeypatch.setattr(agent, "uses_gp_kernels", lambda spec, device: True)
    monkeypatch.setattr(gp_hall, "sample_hall_points",
                        lambda **kw: seen.append(kw["nh"]) or orig(**kw))
    with obs.recording():
        dg, gp2 = agent.sample_dynamics(spec, None, hyp, gp, Xt, eps)
        names = [s.name for s in obs.spans()]
    assert seen == [gp.hall_n * spec.Ty]
    assert names[:2] == ["gp.hall.inputs", "gp.hall.kernel"]
    assert gp2.hall_n == gp.hall_n + spec.H
    ref = gp_hall.sample_hall_plain_stacked(
        **agent.hall_stage_inputs_all(spec, hyp, gp, Xt, eps))
    _same(dg.reshape(spec.ns, spec.g_ny, -1).transpose(0, 1), ref)


@pytest.mark.parametrize("gp_plain", [True, False])
def test_plain_route_swaps_the_points_entry(gp_plain, monkeypatch):
    """Off the CPU the entry launches (on meta points: refused, naming the
    device); inside plain_route(gp=True) it runs its plain version, and
    gp=False leaves the launch; on exit the launch is back."""
    ran = []
    monkeypatch.setattr(gp_hall, "sample_hall_points_plain",
                        lambda *a, **k: ran.append(a[0]) or "plain")
    no, ns, N, Mh, H, D, ty = 3, 2, 5, 6, 4, 3, 4
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    pts = (meta(N, D), meta(no, N * ty), meta(ns, no, Mh, D),
           meta(ns, no, Mh, ty), meta(ns, H, D), meta(ns, no, H, ty),
           meta(no, D), meta(no), meta(ty), meta(no, N * ty, N * ty),
           meta(no, N * ty), 1e-6, 2.5, -1.0, 1e-5)
    with routes.plain_route(gp=gp_plain, qp=False, glue=False):
        if gp_plain:
            assert gp_hall.sample_hall_points(8, *pts, ty=ty) == "plain"
        else:
            with pytest.raises(ValueError, match="unsupported device"):
                gp_hall.sample_hall_points(8, *pts, ty=ty)
    with pytest.raises(ValueError, match="unsupported device"):
        gp_hall.sample_hall_points(8, *pts, ty=ty)
    assert ran == ([8] if gp_plain else [])


@pytest.mark.parametrize("N,Rr,D,ty,nh,Mh,what", [
    (5, 20, 3, 4, 8, 6, None),
    (5, 5, 3, 1, 0, 6, None),
    (5, 45, 8, 9, 18, 6, None),
    (5, 50, 9, 10, 10, 6, "D <= 8"),
    (5, 15, 3, 3, 6, 6, "ty in"),
    (5, 20, 3, 4, 6, 6, "multiple"),
    (5, 20, 3, 4, 28, 6, "multiple"),
    (5, 24, 3, 4, 8, 6, "Rr = N ty"),
])
def test_points_entry_refusals(N, Rr, D, ty, nh, Mh, what):
    if what is None:
        gp_hall.check_points_supported(N, Rr, D, ty, nh, Mh)
    else:
        with pytest.raises(ValueError, match=what):
            gp_hall.check_points_supported(N, Rr, D, ty, nh, Mh)
