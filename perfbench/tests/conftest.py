"""Shared helpers of the benchmark's CPU tests.

Run from the repository root: ``python -m pytest perfbench/tests``.  The
tests drive the harness on the CPU (the program's plain route); those
that need an NVIDIA GPU are marked ``cuda`` and skip elsewhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_config(tmp_path, name: str, ns: int, H: int) -> str:
    """A copy of a benchmark configuration at ns samples and horizon H."""
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        params = json.load(f)
    params["agent"]["num_dyn_samples"] = ns
    params["optimizer"]["H"] = H
    path = os.path.join(tmp_path, f"{name}_ns{ns}_H{H}.json")
    with open(path, "w") as f:
        json.dump(params, f)
    return path


# The car's plan is no cell of BENCHMARK.json (its float32 answers do not
# separate from the planted faults, PERF.md); its configuration, mix and
# SQP reader stay, and these tests drive it in float64, where the program
# reads as the reference to rounding, against float64 limits.
CAR_CONFIG = {"name": "car_samples", "source": "params_car_samples.yaml",
              "file": "perfbench/configs/car_samples.json", "reduced": [],
              "why": "H=100 plan with hall-conditioned GP stages"}
CAR_CELL = {"name": "car_samples.plans", "config": "car_samples",
            "traffic": "plans", "chips": 1, "why": "one 4-iteration plan"}
CAR_LIMITS_F64 = {"chain": 0, "gp_gap": 1e-6, "hall_out": 1e-6,
                  "hall_var_gap": 1e-6, "hall_corr_gap": 1e-6,
                  "plan_gap": 1e-9, "qp_gap": 1e-3, "plant_gap": 1e-9}


def car_root(tmp_path) -> str:
    """A copy of the benchmark with the car's plan added as entries and
    files only, with float64 limits."""
    root = os.path.join(tmp_path, "car_root")
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(CAR_CONFIG)
    bench["workloads"].append(CAR_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "perfbench", "limits",
                           "car_samples.plans.json"), "w") as f:
        json.dump(CAR_LIMITS_F64, f)
    return root


# The forward-sampling rollout is no cell of BENCHMARK.json: its step_ms
# spreads from run to run with the host's CPU speed, past half of the 0.25
# bound (PERF.md).  Its configuration, mix, limits, kind, reader and
# bounds stay, and these entries are what enters it.
FS_CONFIG = {
    "name": "car_residual_fs",
    "source": "https://github.com/manish-pra/sampling-gpmpc "
              "params/params_car_residual_fs.yaml + "
              "benchmarking/simulate_forward_sampling_car.py "
              "(arXiv:2505.07594); float64 as src/agent.py:15",
    "file": "perfbench/configs/car_residual_fs.json", "reduced": [],
    "why": "forward-sampling reachability: 4000 value-only GP realizations "
           "of the residual car (B_d(x) = v I, beta = 30), 50 steps under a "
           "replayed plan with feedback"}
FS_CELL = {
    "name": "car_residual_fs.rollouts", "config": "car_residual_fs",
    "traffic": "rollouts", "chips": 1,
    "why": "whole rollouts back to back, closed loop: 4000 realizations x 50 "
           "steps, fresh draws from 16 sets; each step appends a row to every "
           "factor: the O(t^2) append, the host's launches"}
FS_ROOFLINE = {
    "name": "fs_roofline", "unit": "%", "better": "higher",
    "source": "device_trace",
    "layer": "Forward sampling (reachability.py, gp/exact.py, agent.py)",
    "moves": "step_ms", "workloads": ["car_residual_fs.rollouts"]}

FS_NOT_READ = ("ipm_iters_per_step", "qp_roofline", "gp_roofline",
               "glue_roofline")


def fs_root(tmp_path) -> str:
    """A root with the benchmark's own files (a link) and a BENCHMARK.json
    that adds the forward-sampling rollout's entries and keeps the
    per-layer metrics it cannot read to the cells there are."""
    root = os.path.join(tmp_path, "fs_root")
    os.makedirs(root, exist_ok=True)
    link = os.path.join(root, "perfbench")
    if not os.path.exists(link):
        os.symlink(os.path.join(ROOT, "perfbench"), link)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    mpc_cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:     # a rollout has no IPM, glue or gp_ op
        if m["name"] in FS_NOT_READ:
            m["workloads"] = m.get("workloads", mpc_cells)
    bench["configs"].append(FS_CONFIG)
    bench["workloads"].append(FS_CELL)
    bench["per_layer"].append(FS_ROOFLINE)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_cell(workload: str, seconds: float, make_system=None, config=None,
             mix=None, dtype=None, seed: int = 2 ** 33 + 5, out_dir=None,
             traced: bool = False, root: str = ROOT):
    """One run of a cell of ``root``'s benchmark on the CPU; returns the
    result line as a dict."""
    import torch

    from perfbench import cell, session
    c = cell.load(workload, root)
    if config is not None:
        c.config_path = config
    if mix is not None:
        c.mix = dataclasses.replace(c.mix, **mix)
    return session.run(c, seed, seconds, traced, "cpu", time.perf_counter(),
                       out_dir or os.path.join(ROOT, "perfbench_out", "tests"),
                       lambda msg: None, make_system=make_system,
                       dtype=dtype or torch.float32)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread per test process: the suite's parallel workers
    would otherwise oversubscribe the cores with intra-op threads."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """Skip unless an NVIDIA GPU is present (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
