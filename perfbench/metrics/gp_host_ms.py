"""Host ms a traced step in the GP stage's program spans: the
instants when a ``gp.*`` span of ``sampling_gpmpc_torch/obs.py`` is the
innermost open one (``obs.host_ms_by_layer`` over the traced run's
stretch), over the traced steps.  The profiler slows the host, so this
compares runs with runs, not with ``step_ms``."""

import sys

LAYER = "GP stage (agent.py, gp/, ops/gp_sample.py, ops/gp_hall.py)"
MOVES = "step_ms"


def read(ctx):
    obs = sys.modules.get("sampling_gpmpc_torch.obs")
    if obs is None or ctx.summary is None or not ctx.summary.steps:
        return None
    by_step = obs.host_ms_by_layer(obs.spans())
    if not by_step:
        return None
    return sum(v.get(LAYER, 0.0) for v in by_step.values()) / ctx.summary.steps
