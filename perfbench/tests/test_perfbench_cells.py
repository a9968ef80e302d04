"""Cells, traffic mixes, limits and metrics are found by name, including
one added only as files and entries in a copy of the benchmark."""

import json
import os
import shutil

import pytest

from perfbench import cell

ROOT = cell.ROOT


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_loads_with_its_files(workload):
    c = cell.load(workload)
    assert os.path.exists(c.config_path)
    names = {m["name"] for m in c.end_to_end + c.per_layer}
    assert set(c.readers) == names
    assert "setup_s" in names and "step_ms" in names
    for m in c.readers.values():
        assert callable(m.read) and m.MOVES and m.LAYER
    assert c.limits["chain"] == 0 and c.chips == 1


def test_metric_layers_and_moves_agree_with_the_readers():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        mod = cell.metric_module(m["name"])
        if m in b["per_layer"]:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_cell_added_only_as_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "pendulum1d_samples.pairs",
                           "config": "pendulum1d_samples", "traffic": "pairs",
                           "chips": 1, "why": "two-step episodes"})
    b["per_layer"].append({"name": "steps.seen", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "Closed loop", "moves": "step_ms",
                           "workloads": ["pendulum1d_samples.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "perfbench" / "traffic" / "pairs.json").write_text(json.dumps(
        {"episode_steps": 2, "pool_episodes": 4, "warmup_episodes": 0,
         "trace_steps": 2, "compare_steps": 1, "compare_first_steps": 1}))
    (root / "perfbench" / "limits" / "pendulum1d_samples.pairs.json"
     ).write_text(json.dumps({"chain": 0, "gp_gap": 1.0}))
    (root / "perfbench" / "metrics" / "steps_seen.py").write_text(
        "LAYER = 'Closed loop'\nMOVES = 'step_ms'\n\n\n"
        "def read(ctx):\n    return len(ctx.step_ms) or None\n")
    c = cell.load("pendulum1d_samples.pairs", str(root))
    assert c.mix.episode_steps == 2 and c.limits == {"chain": 0.0,
                                                     "gp_gap": 1.0}
    assert c.readers["steps.seen"].read(
        type("Ctx", (), {"step_ms": [1.0, 2.0]})()) == 2
    assert "steps.seen" not in cell.load("pendulum1d_samples.episodes",
                                         str(root)).readers


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        cell.load("no_such.cell")


def test_benchmark_json_keeps_to_its_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
