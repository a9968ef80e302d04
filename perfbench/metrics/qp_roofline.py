"""The QP layer's share of its roofline: the bound of the traced steps'
QPs (prepare and Mehrotra at each QP's shape and iteration count,
perfbench/bounds.py) over the device time of the ops whose names start
with a prefix of PREFIXES."""

from perfbench import bounds

LAYER = "QP (ocp/qp.py, ops/ipm.py)"
MOVES = "step_ms"
PREFIXES = ("ipm_",)


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.traced:
        return None
    t_us = s.device_us(PREFIXES)
    if not t_us:
        return None
    b = sum(bounds.qp_step_s(ctx.sizes, it, q) for it, q in ctx.traced)
    return 100.0 * b * 1e6 / t_us
