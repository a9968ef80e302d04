"""The hall factor's global-tile branch on the CPU: what the card runs
there, held from the shapes and by the plain version.

* its panel steps (``gp_hall.hall_panels``, the ``gp_hall_panels``
  counter): none at the car's fills, which keep the factor's tiles in
  shared memory; at ``params_car_samples``' fills 400 / 800 / 1200 the
  hall columns' 13 / 25 / 38 tiles in panels of
  ``gp_hall.GLOBAL_PANEL_TILES``; the counter adds a stage's steps at once;
* the tiles' region of the workspace at ``params_car_samples``' largest
  fill stays under 200 MB;
* the plain blocked sweep at the kernels' panel width (and at a width that
  does not divide the hall columns) gives, in float64, the factor, mean,
  variance and draws of the column sweep (``bordered_factor``, panel 1) at
  a global-branch shape.
"""

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch.ops import gp_hall, routes

SCAL = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5)
# a stage whose factor keeps its tiles in the global workspace: the car's
# Ht = 60 at the full hall capacity of 240 rows
NS, HT, TY, RR, NH = 2, 60, 4, 24, 240


@pytest.mark.parametrize("Ht,nh,panels", [
    (60, 60, 0), (60, 120, 0), (60, 180, 0),          # params_car
    (400, 0, 0), (400, 400, 7), (400, 800, 13),       # params_car_samples
    (400, 1200, 19),
    (120, 120, 0), (120, 240, 4), (120, 360, 6)])     # params_pendulum
def test_hall_panel_steps_from_the_shapes(Ht, nh, panels):
    """Panels of two 32-column tiles over the hall columns on the global
    branch, none on the shared one."""
    assert gp_hall.GLOBAL_PANEL_TILES == 2
    assert gp_hall.hall_panels(Ht, nh) == panels
    assert (panels > 0) <= gp_hall.factor_tiles_global(Ht, nh)


@pytest.mark.parametrize("Ht,nh,panels", [(400, 1200, 19), (60, 180, 0)])
def test_the_panel_counter_adds_a_stage_at_once(Ht, nh, panels):
    """One launch set counts its branch once and its panel steps together,
    read through ``routes.launch_counts`` as the other keys."""
    routes.zero_launch_counts()
    gp_hall._count_stage(Ht, nh)
    gp_hall._count_stage(Ht, nh)
    n = routes.launch_counts()
    glob = int(gp_hall.factor_tiles_global(Ht, nh))
    assert (n["gp_hall"], n["gp_hall_global"], n["gp_hall_panels"]) == (
        2, 2 * glob, 2 * panels)
    routes.zero_launch_counts()
    assert routes.launch_counts()["gp_hall_panels"] == 0


def test_global_tiles_fit_under_200_mb():
    """params_car_samples at fill 1200: 3 outputs x 10 samples of 1,326
    tiles, 168 MB."""
    nbytes = 4 * 3 * 10 * gp_hall.factor_tile_floats(400, 1200)
    assert gp_hall.factor_tiles_global(400, 1200)
    assert 160e6 < nbytes < 200e6


def _stage(seed):
    """A float64 hall stage from random feature-space covariances, every
    hall row filled."""
    rng = np.random.default_rng(seed)
    F = 2 * (RR + NH + HT)
    P_r = rng.normal(size=(RR, F)) / np.sqrt(F)
    P_h = rng.normal(size=(NS, NH, F)) / np.sqrt(F)
    P_t = rng.normal(size=(NS, HT, F)) / np.sqrt(F)
    Linv = np.linalg.inv(np.linalg.cholesky(P_r @ P_r.T + 1e-3 * np.eye(RR)))
    kw = dict(
        Kxr=P_t @ P_r.T, Kxh=P_t @ np.swapaxes(P_h, 1, 2),
        Ktt=P_t @ np.swapaxes(P_t, 1, 2),
        Arh=np.einsum("rf,shf->srh", P_r, P_h),
        Ahh=P_h @ np.swapaxes(P_h, 1, 2) + 1e-3 * np.eye(NH),
        yh=rng.normal(size=(NS, NH)) * 0.3,
        eps=np.clip(rng.normal(size=(NS, HT)), -2.5, 2.5), Linv=Linv,
        w_r=Linv @ (rng.normal(size=RR) * 0.3), prior_var=np.full(HT, 1.0))
    return {k: torch.tensor(v) for k, v in kw.items()}


FACTOR = ("Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh", "Linv", "w_r",
          "prior_var")


@pytest.mark.parametrize("panel", [32 * gp_hall.GLOBAL_PANEL_TILES, 96])
def test_plain_sweep_at_the_global_panel_width(panel):
    """At a global-branch shape (Ht = 60, nh = 240; 96 does not divide the
    240 hall columns), the blocked sweep in panels of ``panel`` columns
    against the column sweep, float64: the covariance factor, mean and
    variance to 1e-10, the draws to 1e-10 of their scale, and the factor's
    rows the variances with their jitter."""
    assert gp_hall.factor_tiles_global(HT, NH)
    kw = _stage(seed=panel)
    args = {k: kw[k] for k in FACTOR}
    L, mean, var = gp_hall.bordered_factor(NH, **args, jitter=1e-6,
                                           panel=panel)
    L1, mean1, var1 = gp_hall.bordered_factor(NH, **args, jitter=1e-6,
                                              panel=1)
    for got, ref in ((L, L1), (mean, mean1), (var, var1)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-10)
    LLt = torch.diagonal(L @ L.transpose(1, 2), 0, 1, 2)
    np.testing.assert_allclose(LLt.numpy(), (var + 1e-6).numpy(), rtol=0,
                               atol=1e-10)
    y = gp_hall.sample_hall_plain(NH, **kw, **SCAL, ty=TY, panel=panel)
    y1 = gp_hall.sample_hall_plain(NH, **kw, **SCAL, ty=TY, panel=1)
    mean_y = gp_hall.sample_hall_plain(
        NH, **dict(kw, eps=torch.zeros_like(kw["eps"])), **SCAL, ty=TY,
        panel=panel)
    scale = float(y1.abs().max())
    np.testing.assert_allclose(y.numpy(), y1.numpy(), rtol=0,
                               atol=1e-10 * scale)
    assert bool(((y - mean_y).abs() > 1e-9).any())
