"""The GP stage's share of its roofline: the bound of the traced steps'
GP stages (the empty-buffer stage at iteration 0, the hall stage at each
later iteration's fill, every output; perfbench/bounds.py) over the
device time of the ops whose names start with a prefix of PREFIXES."""

from perfbench import bounds

LAYER = "GP stage (agent.py, gp/, ops/gp_sample.py, ops/gp_hall.py)"
MOVES = "step_ms"
PREFIXES = ("gp_", "hall_")


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.traced:
        return None
    t_us = s.device_us(PREFIXES)
    if not t_us:
        return None
    b = sum(bounds.gp_step_s(ctx.sizes, it) for it, _ in ctx.traced)
    return 100.0 * b * 1e6 / t_us
