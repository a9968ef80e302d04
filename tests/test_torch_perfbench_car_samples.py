"""The benchmark's long car plan (``car_samples.plans`` of BENCHMARK.json)
on the CPU, against the cell's own limits file: a run with the timed path
broken underneath comes out not correct, once for each fault of
``perfbench/faults.py`` that the small size can show; the same run with the
path sound comes out correct.

``params_car_samples`` at ns = 3, H = 8 (four SQP iterations a plan, hall
fills 32 / 64 / 96), one-step episodes as the cell's ``plans`` mix has
them, float64 on the program's plain route against the float64 reference,
as the car cell's CPU test runs it (``tests/test_torch_perfbench_car.py``).

``qp_stop`` is not among them: at H = 8 the last SQP iteration's QP starts
warm from the iteration before and on some draws ends within the fault's
four Mehrotra iterations, so whether the fault shows depends on the plans
the check samples (``qp_gap`` 0.02-0.66 under the fault on three seeds here
in float64, against the limit's 0.3).  At the published H = 100 the fault
reads ``qp_gap`` 1.75-8 on the card (PERF.md, the plan's limits).
"""

import dataclasses
import json
import os
import time

import pytest
import torch

from perfbench import cell, faults, session, systems

WORKLOAD = "car_samples.plans"
MIX = dict(pool_episodes=2, warmup_episodes=0, compare_steps=2)
FAULTS = ["unchanged", "half_batch", "answer", "next_state", "hall_mean",
          "hall_shrink", "hall_flip", "hall_unconditioned"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_plan(tmp_path, ns=3, H=8) -> str:
    """The cell's configuration file at ns samples and horizon H."""
    c = cell.load(WORKLOAD)
    with open(c.config_path) as f:
        params = json.load(f)
    params["agent"]["num_dyn_samples"] = ns
    params["optimizer"]["H"] = H
    path = os.path.join(tmp_path, f"car_samples_ns{ns}_H{H}.json")
    with open(path, "w") as f:
        json.dump(params, f)
    return path


def run_plans(tmp_path, fault=None, seconds=1.0, seed=2 ** 33 + 11):
    """One run of the cell on the CPU, float64, with ``fault`` planted
    (None: sound); the result line as a dict.  The window ends with the
    first plan that ends past ``seconds``."""
    c = cell.load(WORKLOAD)
    c.config_path = tiny_plan(tmp_path)
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


def test_the_cell_and_its_files_load():
    c = cell.load(WORKLOAD)
    assert c.chips == 1
    assert c.mix.episode_steps == 1 and c.mix.pool_episodes == 128
    with open(c.config_path) as f:
        params = json.load(f)
    assert params["optimizer"]["H"] == 100
    assert params["agent"]["num_dyn_samples"] == 10
    assert c.limits["chain"] == 0
    assert {"gp_gap", "hall_var_gap", "hall_corr_gap", "plan_gap",
            "qp_gap", "plant_gap"} <= set(c.limits)
    names = {m["name"] for m in c.end_to_end + c.per_layer}
    assert set(c.readers) == names
    assert {m["name"] for m in c.end_to_end} == {"step_ms", "setup_s"}
    assert {"sqp_iters_per_step", "glue_roofline", "qp_roofline",
            "gp_roofline", "idle_share"} <= names
    assert not {"hall_roofline", "hall_host_ms"} & names
    for m in c.per_layer:
        reader = c.readers[m["name"]]
        assert callable(reader.read) and reader.MOVES == m["moves"] == \
            "step_ms" and reader.LAYER == m["layer"]


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_plans_cell_faults(fault, tmp_path, one_thread):
    res = run_plans(tmp_path, fault)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["compared"]["value"] >= 1
    assert res["correct"] is (fault is None), res["checks"]
