"""The route the main path's kernel wrappers take, and their launch counts.

``plain_route`` holds stages to their plain torch twins (same arguments,
same results) for a block, so that a reference solve runs on the same
device through the same code: it sets the flags that
``build.kernel_route`` reads, the one rule every wrapper asks.
``launch_counts`` reads the counters each wrapper adds one to where it
launches its kernel.  ``chip_smoke.py`` and ``bench.py`` share them.
"""

from __future__ import annotations

import contextlib

from sampling_gpmpc_torch.ops import build
from sampling_gpmpc_torch.ops import glue as _glue
from sampling_gpmpc_torch.ops import gp_hall, gp_sample, ipm


@contextlib.contextmanager
def plain_route(gp: bool = True, qp: bool = True, glue: bool = True):
    """Within the block, the GP stages (``gp``: ``gp_sample`` and
    ``gp_hall``'s entries), the QP (``qp``: ``ipm.run_full``) and the
    condensing and assembly (``glue``: ``ocp/assemble.py::condensed_qp``)
    take their plain versions on every device; a stage an enclosing block
    holds plain stays so.  The flags are restored on exit."""
    saved = dict(build.PLAIN)
    build.PLAIN.update((stage, True) for stage, on in
                       (("gp", gp), ("qp", qp), ("glue", glue)) if on)
    try:
        yield
    finally:
        build.PLAIN.update(saved)


def _ipm_launches(builds) -> dict:
    return {k: sum(ipm.LAUNCHES[k, b] for b in builds) for k in ipm.KERNELS}


def launch_counts() -> dict:
    """Launches of each loop kernel since the counters were last zeroed."""
    return {**gp_sample.LAUNCHES, **gp_hall.LAUNCHES,
            **_ipm_launches(ipm.BUILDS), **_glue.LAUNCHES}


def wide_launch_counts() -> dict:
    """The IPM launches of :func:`launch_counts` that went to the wide
    builds (128 < nU <= 256)."""
    return _ipm_launches([b for b in ipm.BUILDS if b.endswith("_wide")])


def zero_launch_counts() -> None:
    for table in (gp_sample.LAUNCHES, gp_hall.LAUNCHES, ipm.LAUNCHES,
                  _glue.LAUNCHES):
        table.update(dict.fromkeys(table, 0))
