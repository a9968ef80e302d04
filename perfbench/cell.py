"""A cell of ``BENCHMARK.json`` and the files the harness finds by name.

* the configuration: the ``file`` of its entry under ``configs``, whose
  ``precision`` key, where it has one, gives the precision the program
  runs in (float32 where it has none);
* the traffic mix: ``perfbench/traffic/<traffic>.json`` (traffic.Mix);
* the kind of step the mix names: ``perfbench/kinds/<kind>.py``
  (perfbench/kinds/__init__.py says what a kind supplies);
* the correctness limits: ``perfbench/limits/<workload>.json``;
* each metric, end to end or per layer:
  ``perfbench/metrics/<name, dots as underscores>.py``, a module whose
  ``read(ctx)`` (session.Context) returns a number or None.

The cell's end-to-end metrics are those of ``end_to_end`` without a
``workloads`` key or whose ``workloads`` list it; likewise its per-layer
metrics.  A later cell, mix or metric is added as files and entries; no
file here names one, and a later kind of step is added as its file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

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


def kind_module(name: str, root: str = ROOT):
    """The module of a kind of step, by its name: the file
    ``perfbench/kinds/<name>.py`` under ``root``, registered in
    ``sys.modules`` while it runs (its dataclasses look their module up
    there)."""
    path = os.path.join(root, "perfbench", "kinds", f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no kind of step {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_kind_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
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
    kind: object            # the kind module of its traffic mix
    precision: str          # the configuration's (a torch dtype name)


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
    with open(os.path.join(root, cfg["file"])) as f:
        precision = json.load(f).get("precision", "float32")
    mix_path = os.path.join(here, "traffic", f"{w['traffic']}.json")
    kind = kind_module(traffic.kind_of(mix_path), root)
    return Cell(
        name=workload, config_path=os.path.join(root, cfg["file"]),
        mix=traffic.Mix.load(mix_path, getattr(kind, "MIX_KEYS", ())),
        chips=int(w["chips"]),
        end_to_end=_for_cell(bench["end_to_end"], workload),
        per_layer=_for_cell(bench["per_layer"], workload),
        limits={k: float(v) for k, v in limits.items()},
        readers={m["name"]: metric_module(m["name"], root)
                 for m in _for_cell(bench["end_to_end"] + bench["per_layer"],
                                    workload)},
        kind=kind, precision=precision)
