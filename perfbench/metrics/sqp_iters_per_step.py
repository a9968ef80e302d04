"""SQP iterations per MPC step over the measured window (mean of
SolveState.it)."""

LAYER = "SQP (ocp/sqp.py)"
MOVES = "step_ms"


def read(ctx):
    if not ctx.window:
        return None
    return sum(it for it, _ in ctx.window) / len(ctx.window)
