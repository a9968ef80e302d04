"""Nearest-rank 95th percentile of the window's step latencies, each on
the host clock from before the solve to after the device sync."""

import math

LAYER = "Closed loop (the harness's episodes over sqp.solve)"
MOVES = "step_ms_p95"


def read(ctx):
    if not ctx.step_ms:
        return None
    s = sorted(ctx.step_ms)
    return s[max(math.ceil(0.95 * len(s)), 1) - 1]
