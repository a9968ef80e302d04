"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have (perfbench/faults.py; no cell exchanges
data between chips); the same run with the path sound comes out correct.
On the CPU, the program's plain route: the pendulum cells at their own
size in float32; the car's plan, whose hall-conditioned GP stages the
``hall_*`` faults break, at a reduced horizon in float64."""

import pytest
import torch

from conftest import car_root, run_cell, tiny_config
from perfbench import cell, faults, systems

EPISODES = dict(pool_episodes=2, warmup_episodes=0, compare_steps=3,
                compare_first_steps=1)
PLANS = dict(pool_episodes=2, warmup_episodes=0, compare_steps=2)


def make(fault):
    """A system factory that plants ``fault`` (None: sound) for the run."""
    def factory(path, device, dtype):
        system = systems.Program(path, device, dtype)
        if fault is not None:
            factory.undo = faults.FAULTS[fault](system)
        return system
    factory.undo = lambda: None
    return factory


def run_with(fault, *a, **kw):
    factory = make(fault)
    try:
        return run_cell(*a, make_system=factory, **kw)
    finally:
        factory.undo()


FAULTS = ["unchanged", "half_batch", "answer", "next_state", "qp_stop"]
HALL = ["hall_mean", "hall_shrink", "hall_flip", "hall_unconditioned"]


@pytest.mark.parametrize("workload", ["pendulum1d_samples.episodes",
                                      "pendulum1d_samples.cold_solves"])
@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_pendulum(workload, fault, tmp_path):
    res = run_with(fault, workload, 2.0, mix=EPISODES, out_dir=str(tmp_path))
    assert res["attempted"] >= 2
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("fault", [None] + FAULTS + HALL)
def test_plans(fault, tmp_path):
    """The car's plan (no cell of BENCHMARK.json) in float64 against
    float64 limits (conftest.car_root)."""
    res = run_with(fault, "car_samples.plans", 1.0,
                   config=tiny_config(tmp_path, "car_samples", 4, 10),
                   mix=PLANS, dtype=torch.float64, out_dir=str(tmp_path),
                   root=car_root(tmp_path))
    assert res["correct"] is (fault is None), res["checks"]


def test_faults_are_undone():
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.ocp import sqp
    before = (agent.sample_dynamics, sqp.solve_qp_soft)
    system = systems.Program(cell.load("pendulum1d_samples.episodes")
                             .config_path, "cpu", torch.float32)
    solve = system.solve
    for name in faults.FAULTS:
        with faults.planted(name, system):
            pass
    assert (agent.sample_dynamics, sqp.solve_qp_soft) == before
    assert "step" not in vars(system) and system.solve is solve
