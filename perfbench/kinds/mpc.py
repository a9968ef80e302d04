"""The MPC step: one ``ocp.sqp.solve`` of the program, the plant step and
the shift (``systems.Program``), on the draws of ``traffic.Draws``, kept as
``harness.Record`` and judged by ``check.compare`` against
``perfbench/reference/mpc.py``; the faults of ``faults.py``."""

import torch

from perfbench import check, faults, harness, systems, traffic

Program = systems.Program
Draws = traffic.Draws
FAULTS = faults.FAULTS


def control(config_path: str, device):
    """The control of the check: the reference in the program's place in
    float32 (``control.py`` allows TF32 products around it), the nearest
    precision below the configuration's float32 with TF32 off."""
    return systems.Reference(config_path, device, torch.float32)


def record(loop, c, eps, out):
    """The step's inputs and outputs and its episode's step before."""
    return harness.Record(loop.prev is None, c.x, c.X, c.U, eps, out,
                          loop.prev)


def counts(out):
    """(SQP iterations, summed QP iterations): tensors or ints."""
    return out.it, out.qp_iters


def compare(c, records, device, seed):
    return check.compare(c.config_path, records, device)
