"""Mehrotra iterations per MPC step over the measured window (the sum of
SolveState.qp_iters over its successful steps, over their count)."""

LAYER = "QP (ocp/qp.py, ops/ipm.py)"
MOVES = "step_ms"


def read(ctx):
    if not ctx.window:
        return None
    return sum(q for _, q in ctx.window) / len(ctx.window)
