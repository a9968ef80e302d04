"""The glue layer's bound (``perfbench/glue_bounds.py``, read by the
benchmark's ``glue_roofline``) against the counts the chip smoke test
gives each glue launch (``chip_smoke.py::glue_bound`` and
``advance_bound``), at the six published shapes of
``chip_smoke.GLUE_CONFIGS``; and the hall factor's branch rule
(``ops/gp_hall.py::factor_tiles_global``), which the ``gp_hall_global``
and ``gp_hall_panels`` launch counters follow, at the car's fills and at ``params_car_samples``'.
"""

import dataclasses
import os

import pytest

import chip_smoke
from perfbench import bounds, glue_bounds
from sampling_gpmpc_torch.config import load_problem
from sampling_gpmpc_torch.ocp.assemble import row_counts
from sampling_gpmpc_torch.ops import glue, gp_hall

PARAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "params")


def spec_of(config: str, ns: int):
    spec = load_problem(os.path.join(PARAMS, config + ".yaml"))[1]
    return dataclasses.replace(spec, ns=ns)


def sizes_of(spec) -> dict:
    m_h, m_s = row_counts(spec)
    return dict(ns=spec.ns, H=spec.H, nx=spec.nx, nu=spec.nu, m_h=m_h,
                m_s=m_s)


@pytest.mark.parametrize("config, ns", chip_smoke.GLUE_CONFIGS)
def test_iteration_bound_is_the_launches_bounds(config, ns):
    spec = spec_of(config, ns)
    sizes = sizes_of(spec)
    assert glue_bounds.ellipses(spec.ns, spec.H, spec.nx,
                                sizes["m_s"]) == spec.n_ellipses
    cb, cf = chip_smoke.glue_bound(spec)
    ab, af = chip_smoke.advance_bound(spec)
    assert glue_bounds.iteration_bound(sizes) == (cb + ab, cf + af)
    assert glue_bounds.step_s(sizes, 3) == pytest.approx(
        3 * bounds.bound_s(cb + ab, cf + af))


def test_the_flagships_glue_launch():
    """PERF.md's kernel table, row 8: 754,920 B and 5.5e5 operations."""
    spec = spec_of(*chip_smoke.GLUE_CONFIGS[0])
    nb, fl = glue_bounds.condense_bound(spec.ns, spec.H, spec.nx, spec.nu,
                                        *row_counts(spec), spec.n_ellipses)
    assert nb == 754_920 and fl == pytest.approx(5.5e5, rel=0.01)


@pytest.mark.parametrize("config, ns", chip_smoke.GLUE_CONFIGS)
def test_both_branches_write_what_the_bound_counts(config, ns):
    """The narrow branch and the Gram branch of one shape write the same
    outputs (their workspaces aside), so the bound, which counts the
    outputs and not the branch, is the same work for both."""
    spec = spec_of(config, ns)
    rows = row_counts(spec)
    written = []
    for gram in (False, True):
        try:
            shapes = glue.layout(spec, rows, gram)[2][:13]
        except ValueError:          # the narrow sums do not fit: not taken
            continue
        written.append(sum(glue._numel(s) for s in shapes))
    assert written and len(set(written)) == 1
    # the shape's own branch: the Gram launch exactly past GRAM_NU here
    assert glue.layout(spec, rows)[1] is (spec.H * spec.nu > glue.GRAM_NU)
    nb, _ = glue_bounds.condense_bound(spec.ns, spec.H, spec.nx, spec.nu,
                                       *rows, spec.n_ellipses)
    assert nb > 4 * written[0]


@pytest.mark.parametrize("Ht, nh, glob", [
    (60, 0, False), (60, 60, False), (60, 120, False), (60, 180, False),
    (400, 0, True), (400, 400, True), (400, 800, True), (400, 1200, True)])
def test_hall_factor_branch_by_shape(Ht, nh, glob):
    """The car (Ht = 60: fills 60 / 120 / 180) keeps the factor's tiles in
    shared memory; params_car_samples (Ht = 400: fills 400 / 800 / 1200)
    takes the global-tile branch at every fill, the empty buffer's too."""
    assert gp_hall.factor_tiles_global(Ht, nh) is glob
    assert (gp_hall.factor_smem_bytes(Ht, nh) >
            gp_hall.build.SMEM_MAX) is glob


def test_the_branch_counter_is_a_launch_count():
    from sampling_gpmpc_torch.ops import routes
    for key in ("gp_hall_global", "gp_hall_panels"):
        assert key in routes.launch_counts()
    routes.zero_launch_counts()
    assert routes.launch_counts()["gp_hall_global"] == 0
    assert routes.launch_counts()["gp_hall_panels"] == 0
