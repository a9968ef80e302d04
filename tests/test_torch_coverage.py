"""The port's reachable-set coverage (``sampling_gpmpc_torch.
reachable_set_coverage``) against ``benchmarking/reachable_set_coverage.py``.

* its five functions (``hull_volume``, ``_interval_coverage``,
  ``coverage_fraction``, ``coverage_table``, ``load_mc_stages``) return
  exactly what the JAX-side script's do, on the cases of
  tests/test_coverage_metrics.py, and those cases' own checks hold;
* the evaluation chain closes in the port: ``sampling_gpmpc_torch.main``
  writes data.pkl, the port's Monte-Carlo ground truth replays its step-0
  plan, and the port's coverage CLI scores that plan into coverage.json,
  the same rows as the JAX-side functions give on the same pickles.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch import reachable_set_coverage as rc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarking"))
import reachable_set_coverage as jrc  # noqa: E402


def _disc(rng, n, center, r):
    th = rng.uniform(0, 2 * np.pi, n)
    rad = r * np.sqrt(rng.uniform(0, 1, n))
    return np.stack([center[0] + rad * np.cos(th),
                     center[1] + rad * np.sin(th)], axis=1)


def _pad3(pts2):
    return np.concatenate([pts2, np.zeros((pts2.shape[0], 1))], axis=1)


def _cases():
    rng = np.random.default_rng(0)
    contain = (_disc(rng, 400, (0, 0), 1.5), _disc(rng, 400, (0, 0), 1.0))
    rng = np.random.default_rng(1)
    truth = _disc(rng, 400, (0, 0), 1.0)
    shifted = (_disc(rng, 400, (2.5, 0), 1.0), truth)
    line = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]])
    outside = np.array([[3.0, 3.0], [0.5, 0.5]])
    return {"containing": contain, "shifted": shifted,
            "degenerate": (line, line), "degenerate_outside": (line, outside)}


@pytest.mark.parametrize("case", sorted(_cases()))
def test_point_functions_equal_reference(case):
    pred, true = _cases()[case]
    assert rc.hull_volume(pred) == jrc.hull_volume(pred)
    assert rc.hull_volume(true) == jrc.hull_volume(true)
    assert rc._interval_coverage(pred, true) == jrc._interval_coverage(
        pred, true)
    assert rc.coverage_fraction(pred, true) == jrc.coverage_fraction(
        pred, true)


def test_reference_cases_hold_on_the_port():
    pred, truth = _cases()["containing"]
    assert rc.coverage_fraction(pred, truth) == 1.0
    assert rc.hull_volume(pred) > rc.hull_volume(truth)
    pred, truth = _cases()["shifted"]
    assert 0.8 < rc.hull_volume(pred) / rc.hull_volume(truth) < 1.25
    assert rc.coverage_fraction(pred, truth) < 0.05
    line, outside = _cases()["degenerate_outside"]
    assert rc.hull_volume(line) == 0.0
    assert rc.coverage_fraction(line, line) == 1.0
    assert rc.coverage_fraction(line, outside) == 0.5


@pytest.mark.parametrize("which", ["degenerate", "stages"])
def test_coverage_table_equals_reference(which):
    if which == "degenerate":
        line = _cases()["degenerate"][0]
        pred = true = np.tile(line[None], (2, 1, 1))
    else:
        rng = np.random.default_rng(2)
        T, npred, ntrue = 5, 200, 300
        true = np.stack([_pad3(_disc(rng, ntrue, (k * 0.1, 0),
                                     0.2 + 0.1 * k)) for k in range(T)])
        pred = np.stack([_pad3(_disc(rng, npred, (k * 0.1, 0),
                                     1.3 * (0.2 + 0.1 * k)))
                         for k in range(T)])
    rows = rc.coverage_table(pred, true, dims=(0, 1))
    assert rows == jrc.coverage_table(pred, true, dims=(0, 1))
    if which == "degenerate":
        assert rows[0]["vol_ratio"] is None and rows[0]["coverage"] == 1.0
    else:
        assert [r["stage"] for r in rows] == [1, 2, 3, 4]
        assert all(r["coverage"] > 0.97 and r["vol_ratio"] > 1.2
                   for r in rows)


def test_load_mc_stages_equals_reference(tmp_path):
    import pickle
    rng = np.random.default_rng(4)
    with open(tmp_path / "X_traj_list_0.pkl", "wb") as f:
        pickle.dump(rng.normal(size=(3, 5, 6, 2)), f)
    with open(tmp_path / "X_traj_list_1.pkl", "wb") as f:
        pickle.dump(rng.normal(size=(2, 5, 6, 2)), f)
    with open(tmp_path / "data_X_traj_0_0.pkl", "wb") as f:
        pickle.dump({"X_traj": rng.normal(size=(5, 6, 2))}, f)
    got = rc.load_mc_stages(str(tmp_path))
    assert got.shape == (5, 36, 2)
    np.testing.assert_array_equal(got, jrc.load_mc_stages(str(tmp_path)))
    np.testing.assert_array_equal(rc.load_mc_stages(str(tmp_path), 1),
                                  jrc.load_mc_stages(str(tmp_path), 1))
    with pytest.raises(FileNotFoundError):
        rc.load_mc_stages(str(tmp_path / "none"))


def test_chain_main_ground_truth_coverage(tmp_path, capsys):
    import pickle

    from sampling_gpmpc_torch import main as tmain
    from sampling_gpmpc_torch import simulate_true_reachable_set as gt
    from sampling_gpmpc_torch.config import load_problem
    config = "params_pendulum1D_samples"
    params, spec, _ = load_problem(os.path.join(ROOT, "params",
                                                config + ".yaml"))
    i = 980000 + os.getpid() % 10000
    run_dir = os.path.join(ROOT, "experiments", params["experiment"]["folder"],
                           "env_0", config, str(i))
    data = str(tmp_path / "data.pkl")
    mc = tmp_path / "mc"
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmain.main(["-param", config, "--device", "cpu", "-q", "-i", str(i)])
        shutil.copy(os.path.join(run_dir, "data.pkl"), data)
        gt.main(["--device", "cpu", "--repeats", "3", "--batch", "3",
                 "--data", data, "--out", str(mc)])
        rc.main(["-param", config, "--data", data, "--mc-dir", str(mc)])
    finally:
        torch.set_num_threads(old)
        shutil.rmtree(run_dir, ignore_errors=True)
    out = capsys.readouterr().out
    assert f"stages 1..{spec.H}: coverage min=" in out
    with open(mc / "coverage.json") as f:
        rows = json.load(f)
    assert [r["stage"] for r in rows] == list(range(1, spec.H + 1))
    assert not (mc / "coverage.png").exists()       # --plot only
    # the JAX-side functions give the same rows on the same files
    with open(data, "rb") as f:
        Xp = np.asarray(pickle.load(f)["state_traj"][0])
    pred = Xp.reshape(Xp.shape[0], -1, spec.nx)
    true = jrc.load_mc_stages(str(mc))
    assert true.shape == (spec.H + 1, 3 * spec.ns, spec.nx)
    assert rows == json.loads(json.dumps(jrc.coverage_table(pred, true)))
