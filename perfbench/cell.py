"""A cell of ``BENCHMARK.json`` and the files the harness finds by name.

* the configuration: the ``file`` of its entry under ``configs``;
* the traffic mix: ``perfbench/traffic/<traffic>.json`` (traffic.Mix);
* the correctness limits: ``perfbench/limits/<workload>.json``;
* each metric, end to end or per layer:
  ``perfbench/metrics/<name, dots as underscores>.py``, a module whose
  ``read(ctx)`` (session.Context) returns a number or None.

The cell's end-to-end metrics are those of ``end_to_end`` without a
``workloads`` key or whose ``workloads`` list it; likewise its per-layer
metrics.  A later cell, mix or metric is added as files and entries; no
file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

from perfbench import traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _for_cell(entries, workload):
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def metric_module(name: str, root: str = ROOT):
    """The reader module of a metric, by its name: the file
    ``perfbench/metrics/<name, dots as underscores>.py`` under ``root``."""
    mod = name.replace(".", "_")
    path = os.path.join(root, "perfbench", "metrics", f"{mod}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{mod}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config_path: str        # absolute path of its configuration file
    mix: traffic.Mix
    chips: int
    end_to_end: list        # metric entries of this cell
    per_layer: list
    limits: dict            # number name -> limit
    readers: dict           # metric name -> its reader module


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload`` of ``root``/BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "perfbench")
    with open(os.path.join(here, "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    return Cell(
        name=workload, config_path=os.path.join(root, cfg["file"]),
        mix=traffic.Mix.load(os.path.join(here, "traffic",
                                          f"{w['traffic']}.json")),
        chips=int(w["chips"]),
        end_to_end=_for_cell(bench["end_to_end"], workload),
        per_layer=_for_cell(bench["per_layer"], workload),
        limits={k: float(v) for k, v in limits.items()},
        readers={m["name"]: metric_module(m["name"], root)
                 for m in _for_cell(bench["end_to_end"] + bench["per_layer"],
                                    workload)})
