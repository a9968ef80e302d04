"""The rollout kind of step and what the harness gained for it.

* the forward-sampling cell (``car_residual_fs.rollouts``) on the CPU in
  float64 at ns = 16, T = 6 comes out correct when sound and not correct
  under each fault of its kind, against the cell's own limits file;
* an MPC cell's draws, kept records and check numbers at a fixed seed and
  a fixed number of steps read what they read before the harness took
  kinds of step (pinned below);
* a kind of step added only as files, in a copy of the benchmark, runs;
* ``fs_bounds`` against a count by hand at a tiny size.
"""

import dataclasses
import json
import os
import shutil
import time

import pytest
import torch

from conftest import ROOT, fs_root
from perfbench import bounds, cell, check, fs_bounds, harness, session, \
    systems, traffic
from perfbench.reference import fs

WORKLOAD = "car_residual_fs.rollouts"
FAULTS = ["unchanged", "half_batch", "next_state", "mean", "shrink", "flip",
          "unconditioned"]


def tiny_fs(tmp_path, ns=16, T=6) -> str:
    """The cell's configuration file at ns realizations and T steps."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "car_residual_fs.json")) as f:
        params = json.load(f)
    params["agent"]["num_dyn_samples"] = ns
    params["common"]["num_MPC_itrs"] = T
    path = os.path.join(tmp_path, f"fs_ns{ns}_T{T}.json")
    with open(path, "w") as f:
        json.dump(params, f)
    return path


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_rollout_cell(fault, tmp_path):
    c = cell.load(WORKLOAD, fs_root(tmp_path))
    assert c.precision == "float64" and c.kind.MIX_KEYS
    c.config_path = tiny_fs(tmp_path)
    c.mix = dataclasses.replace(c.mix, pool_episodes=3, warmup_episodes=0,
                                extra={"compare_realizations": 8})
    undo = []

    def make(path, device, dtype):
        system = c.kind.Program(path, device, dtype)
        if fault is not None:
            undo.append(c.kind.FAULTS[fault](system))
        return system
    try:
        res = session.run(c, 2 ** 33 + 21, 0.3, False, "cpu",
                          time.perf_counter(), str(tmp_path),
                          lambda msg: None, make_system=make,
                          dtype=torch.float64)
    finally:
        for u in undo:
            u()
    assert res["checks"]["compared"]["value"] >= 1
    assert res["correct"] is (fault is None), res["checks"]
    with open(os.path.join(tmp_path, f"seed{2 ** 33 + 21}_trace0.json")) as f:
        logged = json.load(f)
    assert set(logged["setup_parts"]) >= {"problem", "build_load", "draws",
                                          "warm_up"}
    if fault is None:
        r = logged["readings"]
        assert r["fs_env_gap"] < 1e-9 and r["fs_excluded"] == 0


def test_the_control_is_not_correct(tmp_path):
    """The program's own float32 path, the rollout's control, fails the
    float64 limits at the tiny size too."""
    c = cell.load(WORKLOAD, fs_root(tmp_path))
    c.config_path = tiny_fs(tmp_path)
    c.mix = dataclasses.replace(c.mix, pool_episodes=3, warmup_episodes=0,
                                extra={"compare_realizations": 8})
    res = session.run(c, 2 ** 33 + 22, 0.3, False, "cpu",
                      time.perf_counter(), str(tmp_path), lambda msg: None,
                      make_system=lambda p, d, t: c.kind.control(p, d),
                      dtype=torch.float64)
    assert res["checks"]["compared"]["value"] >= 1
    assert not res["correct"], res["checks"]


def test_the_reference_in_the_programs_place_reads_as_the_program(tmp_path):
    """The free-running float64 reference and the program give the same
    rollout to rounding."""
    c = cell.load(WORKLOAD, fs_root(tmp_path))
    path = tiny_fs(tmp_path, ns=6, T=5)
    prog = c.kind.Program(path, "cpu", torch.float64)
    mix = dataclasses.replace(c.mix, pool_episodes=1)
    eps = c.kind.Draws(mix, prog.sizes, 7, "cpu", torch.float64).episode(0)[0]
    _, a = prog.step(prog.episode_start(), eps)
    X, _, Y = fs.rollout(fs.Model.from_file(path, "cpu", torch.float64), eps)
    assert bool(a.ok)
    assert torch.allclose(a.X, X, rtol=0, atol=1e-9)
    assert torch.allclose(a.hall_Y, Y[..., None], rtol=0, atol=1e-11)
    assert torch.equal(prog.fingerprint(), prog.fp0)


# an MPC cell before kinds of step: pendulum1d_samples.episodes in float64
# on the CPU, 3-step episodes, 2 draw sets, 8 steps, seed 2**33 + 11: the
# pool's sum and sum of squares, and each kept record's (first, sums of x,
# X, U, eps, the plan X and U, hall_Y, x_next, SQP and QP iterations)
PIN_DRAWS = (98.63833522195725, 19671.400939078434)
PIN_RECORDS = [
    [True, 4.449999999999999, 9.912499999999998, 5606.999999999998,
     12489.75, 0.0, 0.0, -38.31393243171502, 3150.8105851880673,
     5247.548480244712, 11298.88391181853, -68.86210074924284,
     323.7571905247594, 45.19405240819891, 0.7121007909714938,
     4.3971850343106285, 9.668015311062227, 1, 22],
    [False, 4.3943907521163865, 9.656175122950453, 5524.164033124014,
     12357.059633408982, -2.8033508395945272, 194.65935396500132,
     43.17947957367123, 3271.440831821195, 5592.006183301018,
     12638.435263050498, 6.167535043496025, 69.50030241070478,
     -3.6945903925126493, 3.9407669190787544, 4.395211212887421,
     9.664502800567512, 1, 17],
    [False, 4.374897969451425, 9.571695192892264, 5495.420626644614,
     12263.882596458412, -1.271448203211337, 212.8254636908292,
     60.19708348301022, 3288.002108914113, 5575.709782353333,
     12582.419289710802, 7.884349976817079, 107.88457670819959,
     0.20204302221538842, 4.038919102698829, 4.421265689771031,
     9.776902320312233, 1, 15],
    [False, 4.397185034294306, 9.668015310989997, 5258.704686852659,
     11357.118304621861, -56.01352009535236, 238.24601619471244,
     -17.924925121621687, 3354.09065126214, 5523.317708227592,
     12321.336257952884, -6.912627201549131, 205.85916449684376,
     -25.043846609516784, 3.598643436869528, 4.3943907521163865,
     9.656175122950453, 1, 28]]
PIN_READINGS = {"compared": 4, "chain": 0.0, "gp_gap": 0.0, "hall_gap": 0.0,
                "hall_out": 0.0, "hall_var_gap": 0.0, "hall_corr_gap": 0.0,
                "plan_gap": 1.4771514403989341e-16,
                "qp_gap": 0.0002139327155839128,
                "qp_gap_scaled": 1.5083957355330067e-08,
                "qp_gap_first": 1.5083957355330067e-08, "qp_viol": 0.0,
                "u_gap": 0.02104304546276875, "plant_gap": 0.0}


def _sums(t):
    t = torch.as_tensor(t, dtype=torch.float64)
    return [float(torch.nansum(t)), float(torch.nansum(t * t))]


def test_an_mpc_cell_reads_as_before():
    c = cell.load("pendulum1d_samples.episodes")
    assert c.kind.Program is systems.Program and c.precision == "float32"
    mix = dataclasses.replace(c.mix, episode_steps=3, pool_episodes=2,
                              warmup_episodes=0, compare_steps=3,
                              compare_first_steps=1)
    seed = 2 ** 33 + 11
    system = c.kind.Program(c.config_path, "cpu", torch.float64)
    draws = c.kind.Draws(mix, system.sizes, seed, "cpu", torch.float64)
    assert draws.pool.shape == (2, 3, 1, 70, 1, 17, 3)
    assert _sums(draws.pool) == pytest.approx(PIN_DRAWS, rel=1e-12)
    loop = harness.Loop(system, mix, draws, seed, c.kind)
    loop.keep = True
    assert all(loop.step()[0] for _ in range(8))
    records = loop.records()
    got = [[r.first, *_sums(r.x), *_sums(r.X), *_sums(r.U), *_sums(r.eps),
            *_sums(r.out.X), *_sums(r.out.U), *_sums(r.out.hall_Y),
            *_sums(r.out.x_next), int(r.out.it), int(r.out.qp_iters)]
           for r in records]
    assert len(got) == len(PIN_RECORDS)
    for g, want in zip(got, PIN_RECORDS):
        assert g[0] is want[0] and g[-2:] == want[-2:]
        assert g[1:-2] == pytest.approx(want[1:-2], rel=1e-7, abs=1e-9)
    readings = c.kind.compare(c, records, "cpu", seed)
    assert readings == pytest.approx(PIN_READINGS, rel=1e-5, abs=1e-9)


COUNT_KIND = '''"""A trivial kind of step: a counter that adds its draw."""
from typing import NamedTuple

import torch

from perfbench import traffic

MIX_KEYS = ("start",)


class Out(NamedTuple):
    value: torch.Tensor
    ok: bool


class Draws(traffic.Draws):
    @staticmethod
    def shape(mix, sizes):
        return (mix.pool_episodes, mix.episode_steps)


class Program:
    def __init__(self, config_path, device, dtype):
        self.device, self.libraries = torch.device(device), []
        self.sizes = {"beta": 2.0}

    def build(self):
        pass

    def episode_start(self):
        return torch.zeros(())

    def step(self, c, eps):
        v = c + 1 + 0 * eps
        return v, Out(v, True)

    def launch_counts(self):
        return {}


FAULTS = {}


def control(config_path, device):
    return Program(config_path, device, torch.float32)


def record(loop, c, eps, out):
    return (loop.mix.extra["start"], float(c), float(out.value))


def counts(out):
    return (1,)


def compare(c, records, device, seed):
    return {"compared": len(records),
            "chain": max(abs(v - (a + 1)) for _, a, v in records)}
'''


def test_a_kind_added_only_as_files_runs(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append({"name": "pendulum1d_samples.counts",
                           "config": "pendulum1d_samples",
                           "traffic": "counts", "chips": 1,
                           "why": "a counter"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "perfbench" / "kinds" / "count.py").write_text(COUNT_KIND)
    (root / "perfbench" / "traffic" / "counts.json").write_text(json.dumps(
        {"kind": "count", "episode_steps": 4, "pool_episodes": 2,
         "warmup_episodes": 1, "trace_steps": 1, "compare_steps": 3,
         "compare_first_steps": 0, "start": 5}))
    (root / "perfbench" / "limits" / "pendulum1d_samples.counts.json"
     ).write_text(json.dumps({"chain": 0}))
    c = cell.load("pendulum1d_samples.counts", str(root))
    assert c.kind.MIX_KEYS == ("start",) and c.mix.extra == {"start": 5}
    res = session.run(c, 3, 0.05, False, "cpu", time.perf_counter(),
                      str(tmp_path), lambda msg: None)
    assert res["correct"] and res["attempted"] >= 1
    assert res["checks"]["compared"]["value"] == 3
    # the benchmark's own files are as they were
    for sub in ("kinds", "traffic", "limits"):
        assert sorted(os.listdir(os.path.join(ROOT, "perfbench", sub))) == \
            sorted(n for n in os.listdir(root / "perfbench" / sub)
                   if "count" not in n)


def test_mix_with_an_unknown_kind_is_refused(tmp_path):
    (tmp_path / "perfbench" / "traffic").mkdir(parents=True)
    p = tmp_path / "perfbench" / "traffic" / "x.json"
    p.write_text(json.dumps({"kind": "nosuch"}))
    with pytest.raises(KeyError, match="no kind"):
        cell.kind_module(traffic.kind_of(str(p)), str(tmp_path))


def test_fs_bounds_against_a_hand_count():
    # ns = 2, g_ny = 1, R = 3, t = 2, D = 2, nx = 4, float64:
    # shared: L 6 + w 3 + inputs 6 = 15; own reads: C 6 + L_s 3 + w 2 +
    # inputs 4 + draw 1 = 16; own writes: row 3 + 2 + 2 = 7, value 1,
    # input 2 = 10; states 2 x 4 = 8 a realization
    nbytes, flops = fs_bounds.step_bound(2, 1, 3, 2, 2, 4, 8)
    assert nbytes == 8 * (15 + 2 * (16 + 10 + 8))
    # a realization: 3*9 + 3*4 + 6*6 + 5*8 + 8*5 = 155
    assert flops == 2 * 155
    sizes = dict(ns=2, g_ny=1, R=3, T=3, D=2, nx=4, word=8)
    assert fs_bounds.rollout_s(sizes) == pytest.approx(sum(
        bounds.bound_s(*fs_bounds.step_bound(2, 1, 3, t, 2, 4, 8))
        for t in range(3)))
    # the card's full-size rollout is bound by its bytes, about 2 ms
    full = dict(ns=4000, g_ny=3, R=45, T=50, D=2, nx=4, word=8)
    assert 1e-3 < fs_bounds.rollout_s(full) < 4e-3
    b, f = fs_bounds.step_bound(4000, 3, 45, 25, 2, 4, 8)
    assert b / bounds.HBM_BYTES_PER_S > f / bounds.F32_FLOP_PER_S


def test_the_rollout_check_names_its_numbers(tmp_path):
    c = cell.load(WORKLOAD, fs_root(tmp_path))
    assert set(c.limits) <= set(c.kind.NUMBERS)
    assert c.limits["chain"] == 0
    assert {m["name"] for m in c.per_layer} == {"idle_share",
                                                "device_ops_per_step",
                                                "fs_roofline"}
    assert {m["name"] for m in c.end_to_end} == {"step_ms", "setup_s"}
    assert check.verdict({"compared": 1, **{k: 0.0 for k in c.limits}},
                         c.limits)[0]
