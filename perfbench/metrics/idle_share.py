"""Share of the untraced step in which the card does no work: 1 - (union
of device kernel, copy and fill intervals over the traced steps) / (their
count x the measured window's mean step)."""

LAYER = "Device (csrc/*.cu on the card)"
MOVES = "step_ms"


def read(ctx):
    s = ctx.summary
    if s is None or s.steps == 0 or not ctx.mean_step_ms:
        return None
    return 100.0 * (1.0 - s.busy_us / 1e3 / (s.steps * ctx.mean_step_ms))
