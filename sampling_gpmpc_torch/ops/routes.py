"""The route the main path's kernel wrappers take, and their launch counts.

``plain_route`` swaps the wrappers that ``agent.sample_dynamics``,
``sqp._assemble`` and ``qp.solve_qp_soft`` call for their plain torch
versions (same arguments, same results), so that a reference solve runs
on the same device through the same code; ``launch_counts`` reads the
counters each wrapper adds one to where it launches its kernel.
``chip_smoke.py`` and ``bench.py`` share them.
"""

from __future__ import annotations

import contextlib

from sampling_gpmpc_torch.ops import glue as _glue
from sampling_gpmpc_torch.ops import gp_hall, gp_sample, ipm


@contextlib.contextmanager
def plain_route(gp: bool = True, qp: bool = True, glue: bool = True):
    """Within the block, the GP stages (``gp``: ``gp_sample.sample_empty``,
    ``gp_hall.sample_hall`` and ``gp_hall.sample_hall_points``), the QP
    (``qp``: ``ipm.run_full``) and the condensing and assembly (``glue``:
    ``glue.assemble``) take their plain versions; restored on exit."""
    saved = (gp_sample.sample_empty, gp_hall.sample_hall,
             gp_hall.sample_hall_points, ipm.run_full, _glue.assemble)
    if gp:
        gp_sample.sample_empty = gp_sample.sample_empty_plain_stacked
        gp_hall.sample_hall = gp_hall.sample_hall_plain_stacked
        gp_hall.sample_hall_points = gp_hall.sample_hall_points_plain
    if qp:
        ipm.run_full = ipm.run_full_plain
    if glue:
        _glue.assemble = _glue.assemble_plain
    try:
        yield
    finally:
        (gp_sample.sample_empty, gp_hall.sample_hall,
         gp_hall.sample_hall_points, ipm.run_full, _glue.assemble) = saved


def launch_counts() -> dict:
    """Launches of each loop kernel since the counters were last zeroed."""
    return {**gp_sample.LAUNCHES, **gp_hall.LAUNCHES, **ipm.LAUNCHES,
            **_glue.LAUNCHES}


def wide_launch_counts() -> dict:
    """The IPM launches of :func:`launch_counts` that went to the wide
    builds (128 < nU <= 256)."""
    return dict(ipm.LAUNCHES_WIDE)


def zero_launch_counts() -> None:
    for table in (gp_sample.LAUNCHES, gp_hall.LAUNCHES, ipm.LAUNCHES,
                  ipm.LAUNCHES_WIDE, _glue.LAUNCHES):
        for name in table:
            table[name] = 0
