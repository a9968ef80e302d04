"""The benchmark's car cell (``car.episodes`` of BENCHMARK.json) on the
CPU, against the cell's own limits file: a run with the timed path broken
underneath comes out not correct, once for each fault of
``perfbench/faults.py`` (the four that break the hall-conditioned GP
stages included); the same run with the path sound comes out correct.

``params_car`` at ns = 4, H = 8 (four SQP iterations a step, hall fills
32 / 64 / 96), three-step episodes, float64 on the program's plain route
against the float64 reference, as the CPU tests of the pendulum cells run
them at their own size (``perfbench/tests/test_perfbench_faults.py``).

``qp_stop`` is not among them: the QP the check judges is the last SQP
iteration's, which starts warm from the iteration before and ends within
the fault's four Mehrotra iterations, so its answer is the sound one to
the QP's tolerance (``qp_gap_first`` 6e-9 under the fault against 1.7e-8
sound, one seed here in float64).
"""

import dataclasses
import json
import os
import time

import pytest
import torch

from perfbench import cell, faults, session, systems

WORKLOAD = "car.episodes"
MIX = dict(episode_steps=3, pool_episodes=2, warmup_episodes=0,
           compare_steps=3, compare_first_steps=1)
FAULTS = ["unchanged", "half_batch", "answer", "next_state", "hall_mean",
          "hall_shrink", "hall_flip", "hall_unconditioned"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_car(tmp_path, ns=4, H=8) -> str:
    """The cell's configuration file at ns samples and horizon H."""
    c = cell.load(WORKLOAD)
    with open(c.config_path) as f:
        params = json.load(f)
    params["agent"]["num_dyn_samples"] = ns
    params["optimizer"]["H"] = H
    path = os.path.join(tmp_path, f"car_ns{ns}_H{H}.json")
    with open(path, "w") as f:
        json.dump(params, f)
    return path


def run_car(tmp_path, fault=None, seconds=3.0, seed=2 ** 33 + 7):
    """One run of the cell on the CPU, float64, with ``fault`` planted
    (None: sound); the result line as a dict.  The window ends with the
    first step that ends past ``seconds``: a step takes ~0.3 s alone and
    ~0.9 s with three busy processes a core, so 3 s leaves room for the
    two steps the test asks for on a loaded host."""
    c = cell.load(WORKLOAD)
    c.config_path = tiny_car(tmp_path)
    c.mix = dataclasses.replace(c.mix, **MIX)
    undo = []

    def make(path, device, dtype):
        system = systems.Program(path, device, dtype)
        if fault is not None:
            undo.append(faults.FAULTS[fault](system))
        return system
    try:
        return session.run(c, seed, seconds, False, "cpu",
                           time.perf_counter(), str(tmp_path),
                           lambda msg: None, make_system=make,
                           dtype=torch.float64)
    finally:
        for u in undo:
            u()


def test_the_cell_and_its_limits_load():
    c = cell.load(WORKLOAD)
    assert c.chips == 1 and c.mix.episode_steps == 130
    assert c.limits["chain"] == 0
    assert {"gp_gap", "hall_var_gap", "hall_corr_gap", "plan_gap",
            "qp_gap_first", "plant_gap"} <= set(c.limits)
    per_layer = {m["name"] for m in c.per_layer}
    assert {"hall_roofline", "hall_host_ms"} <= per_layer
    assert {m["name"] for m in c.end_to_end} == {"step_ms", "setup_s"}


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_car_cell_faults(fault, tmp_path, one_thread):
    res = run_car(tmp_path, fault)
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert res["correct"] is (fault is None), res["checks"]
