"""The forward-sampling rollout's share of its roofline: the bound of the
traced rollouts' work, counted from the sizes (perfbench/fs_bounds.py),
over the device's busy time in the traced window (the union of every
kernel, copy and fill: the rollout runs no kernel of its own, so all of
the card's work is this layer's)."""

from perfbench import fs_bounds

LAYER = "Forward sampling (reachability.py, gp/exact.py, agent.py)"
MOVES = "step_ms"


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.traced or not s.busy_us:
        return None
    b = len(ctx.traced) * fs_bounds.rollout_s(ctx.sizes)
    return 100.0 * b * 1e6 / s.busy_us
