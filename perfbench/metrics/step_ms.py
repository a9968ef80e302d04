"""The measured window's wall time over the MPC steps attempted in it
(episode restarts inside the window), host clock."""

LAYER = "Closed loop (the harness's episodes over sqp.solve)"
MOVES = "step_ms"


def read(ctx):
    return ctx.mean_step_ms if ctx.step_ms else None
