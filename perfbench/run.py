"""Run one cell of the benchmark and print its result line.

    python -m perfbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout on a machine with the NVIDIA GPUs the cell
asks for.  Set-up (imports, CUDA context, the configuration's problem,
the CUDA libraries, the draws, the warm-up episodes) counts from the start
of this module to the first timed step; the run's record gets each part.
Then the window runs for ``--seconds``; with ``--trace 1`` the cell's
``trace_steps`` follow under ``torch.profiler``.  Then the kept steps are
compared with the float64 reference (the kind's check; the MPC step's is
check.py).  Progress, the card, the host and each step's latency against
the configuration's ``dt`` go to standard error and to
``perfbench_out/<workload>/`` in the checkout; the last line of standard
output is one JSON object.  Exits non-zero, with no result, without CUDA
or enough GPUs, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sampling_gpmpc_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_state() -> dict:
    """The card's name, power limit, SM clock, temperature and power draw
    as nvidia-smi reads them ({} where it cannot)."""
    q = "name,power.limit,clocks.sm,temperature.gpu,power.draw"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.strip().splitlines()[:1]
    return dict(zip(q.split(","), (v.strip() for v in first[0].split(","))))\
        if first else {}


def host_state() -> dict:
    """The host's load, CPUs, clock and CPU time counters, and this
    process's CPU time: read before and after the window, so that a
    window's spread can be traced to the host."""
    import torch
    st = {"loadavg_1m": os.getloadavg()[0], "cpus": os.cpu_count(),
          "affinity": len(os.sched_getaffinity(0)),
          "torch_threads": torch.get_num_threads(),
          "process_cpu_s": time.process_time(), "wall_s": time.perf_counter()}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()[1:]
        # user nice system idle iowait irq softirq steal (clock ticks)
        st["proc_stat_cpu"] = [int(v) for v in cpu[:8]]
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        st["cpu_mhz_mean"] = sum(mhz) / len(mhz) if mhz else None
        with open("/proc/self/stat") as f:
            st["last_cpu"] = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        pass
    return st


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # caches at fixed paths inside the checkout (the CUDA libraries build
    # into its build/ by the program's own rule)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    from perfbench import cell as cells
    c = cells.load(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        log(f"needs {c.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; no result")
        return 2
    from perfbench import session
    t_imports = time.perf_counter()
    torch.cuda.synchronize()          # creates the CUDA context
    parts = {"imports": t_imports - T0,
             "cuda_context": time.perf_counter() - t_imports}
    try:
        res = session.run(c, args.seed, args.seconds, bool(args.trace),
                          "cuda", T0, os.path.join(ROOT, "perfbench_out",
                                                   c.name), log,
                          dtype=getattr(torch, c.precision),
                          card_state=card_state, host_state=host_state,
                          setup_parts=parts)
    except session.NothingToRead as e:
        log(f"{e}; no result")
        return 4
    found = forbidden_modules()
    if found:
        log(f"loaded modules of JAX or the JAX package: {found}; no result")
        return 3
    for k, v in res["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
