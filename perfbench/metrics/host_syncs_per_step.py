"""The host's waits for the card a traced step (reads of a device value,
copies from pageable host memory): the count that
``sampling_gpmpc_torch/obs.py``'s ``SYNCS`` gained over the traced run's
stretch of spans (``obs.syncs``), over the traced steps."""

import sys

LAYER = ("Glue (agent.dyn_linearization, ocp/condense.py, ocp/assemble.py, "
         "the SQP driver's torch ops)")
MOVES = "step_ms"


def read(ctx):
    obs = sys.modules.get("sampling_gpmpc_torch.obs")
    if obs is None or ctx.summary is None or not ctx.summary.steps:
        return None
    if not obs.spans():
        return None
    return sum(obs.syncs().values()) / ctx.summary.steps
