"""Kernels, copies and fills on the card per traced step: the host's
launch load."""

LAYER = ("Glue (agent.dyn_linearization, ocp/condense.py, ocp/assemble.py, "
         "the SQP driver's torch ops)")
MOVES = "step_ms"


def read(ctx):
    s = ctx.summary
    if s is None or s.steps == 0 or s.n_ops == 0:
        return None
    return s.n_ops / s.steps
