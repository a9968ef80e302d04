"""``ocp/assemble.py``'s chain of one SQP iteration after the
linearization rows (``assemble_iteration``: ``dyn_linearization``, the
condensing, the cost and the rows), the plain twin of the glue kernel
(``ops/glue.py``), against the SQP solve's CPU route."""

import pytest
import torch

from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.assemble import assemble_iteration
from sampling_gpmpc_torch.parallel.worker import glue_inputs

CPU = torch.device("cpu")

CASES = [("params_pendulum1D_samples", 5),   # feedback rows, terminal ellipse
         ("params_pendulum", 3),             # hard rows only
         ("params_car", 3),                  # ellipses: soft state box
         ("params_car_residual", 1)]         # feedback with nu = 2


@pytest.mark.parametrize("config,ns", CASES)
def test_plain_twin_is_the_chain_before_the_kernel(config, ns):
    """assemble_iteration returns bit for bit what the SQP solve's CPU
    route (``sqp.assemble_qp``, the chain the JAX-parity tests hold)
    returns."""
    args, (env, hyp, gp, eps0) = glue_inputs(config, ns, CPU, torch.float64)
    spec, ocp, _, X, U, st = args
    got_qp, got_T, got_G = assemble_iteration(*args)
    want_qp, want_T, want_G, _ = sqp.assemble_qp(spec, env, hyp, ocp, st, X,
                                                 U, gp, eps0, hall_empty=True)
    assert len(got_qp) == len(want_qp) == 11
    for name, a, b in zip(sqp.QP_KEYS + ("T", "Gamma"),
                          tuple(got_qp) + (got_T, got_G),
                          tuple(want_qp) + (want_T, want_G)):
        assert torch.equal(a, b), name
