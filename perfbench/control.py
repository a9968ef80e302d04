"""Readings behind the correctness limits, for one cell, in one process.

    python -m perfbench.control --workload <name> --seconds <s>
        --program-seeds <a,b,...> --control-seeds <c,d,...>
        [--faults <name,...> --fault-seeds <e,f,...>]

On the card, at the cell's own sizes and load: first the program's check
numbers on each program seed (set up once, a window of ``--seconds``
each, in the configuration's precision), then the control's (the kind's
``control``: for the MPC step the reference, ``perfbench/reference``, put
in the program's place in float32, here with TF32 matrix products on, the
nearest precision below the configuration's float32 with TF32 off); then
the program with each fault of the cell's kind (``FAULTS`` of
``perfbench/kinds/<kind>.py``; the MPC step's are ``perfbench/faults.py``)
planted, on each fault seed.  Prints one JSON line per seed (``side``,
``seed``, ``correct``, the readings) and writes them to
``perfbench_out/<workload>/control.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from perfbench import cell as cells
from perfbench import faults, session
from perfbench.run import ROOT, log


def readings(c, side: str, seeds, seconds: float, device, out_dir: str):
    """The check numbers of ``side`` ("program", "control" or
    "fault:<name>") on each seed, one set-up for all."""
    dtype = getattr(torch, c.precision)
    if side == "control":
        system = c.kind.control(c.config_path, device)
    else:
        system = c.kind.Program(c.config_path, device, dtype)
    if side.startswith("fault:"):
        with faults.planted(side.split(":", 1)[1], system, c.kind.FAULTS):
            return _rows(c, side, system, seeds, seconds, device, out_dir,
                         dtype)
    return _rows(c, side, system, seeds, seconds, device, out_dir, dtype)


def _rows(c, side, system, seeds, seconds, device, out_dir, dtype):
    rows = []
    for seed in seeds:
        tf32 = side == "control"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            res = session.run(c, seed, seconds, False, device,
                              time.perf_counter(), out_dir, log,
                              make_system=lambda *a: system, dtype=dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        with open(os.path.join(out_dir, f"seed{seed}_trace0.json")) as f:
            logged = json.load(f)["readings"]
        row = {"side": side, "seed": seed, "correct": res["correct"],
               "attempted": res["attempted"], "failed": res["failed"],
               **logged}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    c = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available():
        log("needs CUDA; no readings")
        return 2
    out_dir = os.path.join(ROOT, "perfbench_out", c.name)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    sides = [("program", args.program_seeds), ("control", args.control_seeds)]
    sides += [(f"fault:{f}", args.fault_seeds)
              for f in args.faults.split(",") if f]
    rows = []
    for side, side_seeds in sides:
        if seeds(side_seeds):
            rows += readings(c, side, seeds(side_seeds), args.seconds,
                             "cuda", out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "control.json"), "w") as f:
        json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
