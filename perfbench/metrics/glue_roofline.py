"""The glue layer's share of its roofline: the bound of the traced steps'
glue work (each SQP iteration's condensing, QP assembly and step, from the
configuration's sizes: perfbench/glue_bounds.py) over the device time of
the ops whose names start with a prefix of PREFIXES (``glue_condense_kernel``,
``glue_gram_kernel``, ``glue_advance_kernel``)."""

from perfbench import glue_bounds

LAYER = ("Glue (agent.dyn_linearization, ocp/condense.py, ocp/assemble.py, "
         "the SQP driver's torch ops)")
MOVES = "step_ms"
PREFIXES = ("glue_",)


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.traced:
        return None
    t_us = s.device_us(PREFIXES)
    if not t_us:
        return None
    b = sum(glue_bounds.step_s(ctx.sizes, it) for it, _ in ctx.traced)
    return 100.0 * b * 1e6 / t_us
