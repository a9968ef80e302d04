"""The port's examples (``sampling_gpmpc_torch.examples``).

* E7, iterative GP conditioning: on the same standard-normal draws, the
  port's draws at the conditioning points equal the JAX package's
  ``gp.exact`` pipeline (the calls of examples/gp_conditioning_demo.py)
  to 1e-10, float64.  The re-sampled functions on the 120-point grid draw
  through the Cholesky factor of a near-singular posterior covariance
  (jitter 1e-8), whose float64 rounding they amplify: the JAX pipeline's
  own draws move 4.9e-9 when its inputs move by 1e-15 relative (measured
  here), so they are held at GRID_TOL, ten times that floor.  Each
  re-sampled realization passes through its own points;
* E10, the LQR sanity check: the reference's two assertions hold (the
  Lyapunov value decays below 1e-2 of its start over 400 steps and
  decreases at every step), and the gain is JAX's
  ``tools.terminal_set.synthesize``'s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu.gp import exact as jexact
from sampling_gpmpc_torch.examples import gp_conditioning_demo as e7
from sampling_gpmpc_torch.examples import lqr_sanity as e10

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_TOL = 5e-8


def _jax_e7(eps_points, eps_grid, rel=0.0):
    """examples/gp_conditioning_demo.py's computation on given draws (the
    real inputs moved by ``rel`` relative), compiled once."""
    out = _jax_e7_jit(jnp.asarray(eps_points), jnp.asarray(eps_grid),
                      jnp.asarray(e7.REAL_Z * (1.0 + rel)),
                      jnp.asarray(e7.truth(e7.REAL_Z)))
    return tuple(np.asarray(a) for a in out)


@jax.jit
def _jax_e7_jit(eps_points, eps_grid, Zr, Yr):
    ls, os_, noise = np.array(e7.LS), e7.OS, jnp.asarray(e7.NOISE)
    rf = jexact.factor_real(Zr, Yr, ls, os_,
                            noise, e7.JITTER, False)
    empty_Z, empty_Y = jnp.full((1, 1), 1e5), jnp.full((1, 1), jnp.nan)
    pts, grid = jnp.asarray(e7.COND_PTS), jnp.asarray(e7.GRID)
    uf0 = jexact.condition_update(rf, Zr, empty_Z, empty_Y, ls, os_, noise,
                                  e7.JITTER, False)
    mp, cp = jexact.predict_update(pts, Zr, empty_Z, rf, uf0, ls, os_,
                                   e7.JITTER, False)
    samples = [jexact.posterior_sample(mp, cp, eps_points[i], e7.JITTER)
               for i in range(eps_points.shape[0])]
    draws = []
    for i, s in enumerate(samples):
        ufi = jexact.condition_update(rf, Zr, pts, s[:, None], ls, os_,
                                      noise, e7.JITTER, False)
        mg, cg = jexact.predict_update(grid, Zr, pts, rf, ufi, ls, os_,
                                       e7.JITTER, False)
        draws.append(jexact.posterior_sample(mg, cg, eps_grid[i],
                                             e7.DRAW_JITTER))
    return jnp.stack(samples), jnp.stack(draws)


def test_e7_draws_match_jax_on_the_same_eps():
    eps_points, eps_grid = e7.draws(torch.Generator().manual_seed(5))
    res = e7.run(eps_points, eps_grid, "cpu")
    samples, draws = _jax_e7(eps_points, eps_grid)
    np.testing.assert_allclose(res["samples"], samples, atol=1e-10, rtol=0)
    np.testing.assert_allclose(res["draws"], draws, atol=GRID_TOL, rtol=0)
    # the floor: JAX against itself on inputs moved by 1e-15 relative
    floor = np.abs(_jax_e7(eps_points, eps_grid, 1e-15)[1] - draws).max()
    assert 1e-10 < floor < GRID_TOL / 5
    assert e7.pinning_error(res) < 1e-2
    assert res["draws"].shape == (e7.N_REALIZATIONS, e7.GRID.shape[0])


def test_e7_cli_without_plot(capsys, tmp_path):
    out = tmp_path / "demo.png"
    e7.main(["--device", "cpu", "--out", str(out)])
    assert "re-sampled functions within" in capsys.readouterr().out
    assert not out.exists()                       # drawn with --plot only


def test_e10_lyapunov_decay_and_jax_gain():
    from sampling_gpmpc_tpu.config import load_problem as jload
    from sampling_gpmpc_tpu.envs import make_env as jmake_env
    from sampling_gpmpc_tpu.tools.terminal_set import synthesize as jsynth
    ts, V = e10.run("cpu")
    e10.check(V)
    assert V[-1] < 1e-2 * V[0] and np.all(np.diff(V) < 1e-9)
    params, spec, data = jload(os.path.join(
        ROOT, "params", "params_pendulum1D_samples.yaml"))
    jts = jsynth(jmake_env(spec, params), data.goal, np.zeros(spec.nu),
                 np.asarray(data.Qx), np.asarray(data.Qu), data.x_min,
                 data.x_max, data.u_min, data.u_max)
    np.testing.assert_allclose(ts.K, np.asarray(jts.K), rtol=1e-10)
    np.testing.assert_allclose(ts.P, np.asarray(jts.P), rtol=1e-10)
    # a broken gain fails the reference's assertion
    with pytest.raises(AssertionError, match="Lyapunov"):
        e10.check(np.full(10, V[0]))
