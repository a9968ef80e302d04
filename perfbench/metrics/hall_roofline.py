"""The hall-conditioned GP stage's share of its roofline: the bound of the
traced steps' hall stages, each at the fill that
``sampling_gpmpc_torch/obs.py``'s ``HALL_ROWS`` counted over the traced
run's stretch (``obs.hall_rows``), for every output (perfbench/bounds.py
``gp_hall_bound``), over the device time of the ops whose names start with
a prefix of PREFIXES (``hall_gemm_kernel``, ``gp_hall_factor_kernel``).
None where no hall stage was counted or no such op ran."""

import sys

from perfbench import bounds

LAYER = "GP stage (agent.py, gp/, ops/gp_sample.py, ops/gp_hall.py)"
MOVES = "step_ms"
PREFIXES = ("hall_", "gp_hall_")


def read(ctx):
    obs = sys.modules.get("sampling_gpmpc_torch.obs")
    hall_rows = getattr(obs, "hall_rows", None)
    s = ctx.summary
    if hall_rows is None or s is None:
        return None
    fills = hall_rows()
    t_us = s.device_us(PREFIXES)
    if not fills or not t_us:
        return None
    z = ctx.sizes
    ns, g_ny, Ht, R = z["ns"], z["g_ny"], z["H"] * z["Ty"], z["R"]
    b = 0.0
    for nh, n in fills.items():
        nb, fl = bounds.gp_hall_bound(ns, Ht, R, nh)
        b += n * bounds.bound_s(g_ny * nb, g_ny * fl)
    return 100.0 * b * 1e6 / t_us
