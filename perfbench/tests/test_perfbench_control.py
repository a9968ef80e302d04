"""The control of the correctness check comes out not correct: the
reference in the program's place in float32 with TF32 products on (the
nearest precision below the configurations' float32 with TF32 off), at
the cell's own size and load.  Needs the card."""

import pytest

from conftest import fs_root
from perfbench import cell, control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pendulum1d_samples.episodes",
                                      "pendulum1d_samples.cold_solves"])
def test_control_is_not_correct(cuda, workload, tmp_path):
    c = cell.load(workload)
    rows = control.readings(c, "control", [2 ** 31 + 77], 6.0, "cuda",
                            str(tmp_path))
    assert rows and not any(r["correct"] for r in rows)


@pytest.mark.cuda
def test_program_is_correct_beside_it(cuda, tmp_path):
    c = cell.load("pendulum1d_samples.cold_solves")
    rows = control.readings(c, "program", [2 ** 31 + 78], 3.0, "cuda",
                            str(tmp_path))
    assert rows and all(r["correct"] for r in rows)


@pytest.mark.cuda
def test_rollout_control_is_not_correct(cuda, tmp_path):
    """The rollout's control, the program's own float32 path, at the
    cell's own size (the program runs in float64, the configuration's)."""
    c = cell.load("car_residual_fs.rollouts", fs_root(tmp_path))
    rows = control.readings(c, "control", [2 ** 31 + 79], 3.0, "cuda",
                            str(tmp_path))
    assert rows and not any(r["correct"] for r in rows)
