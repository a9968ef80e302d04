"""Host ms a traced step in the hall-conditioned GP stage's program spans:
the instants when a ``gp.hall.*`` span of ``sampling_gpmpc_torch/obs.py``
is the innermost open one (``obs.host_ms_in`` over the traced run's
stretch), over the traced steps.  None where the program has no such span
(no hall stage ran, or a program without these spans).  The profiler slows
the host, so this compares runs with runs, not with ``step_ms``."""

import sys

LAYER = "GP stage (agent.py, gp/, ops/gp_sample.py, ops/gp_hall.py)"
MOVES = "step_ms"
PREFIX = "gp.hall."


def read(ctx):
    obs = sys.modules.get("sampling_gpmpc_torch.obs")
    host_ms_in = getattr(obs, "host_ms_in", None)
    if host_ms_in is None or ctx.summary is None or not ctx.summary.steps:
        return None
    ms = host_ms_in(obs.spans(), PREFIX)
    return None if ms is None else ms / ctx.summary.steps
