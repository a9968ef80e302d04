"""Multi-process start-up and the seed-axis share of a sweep.

Counterpart of ``sampling_gpmpc_tpu/parallel/distributed.py``:

* :func:`init_multihost` — ``torch.distributed.init_process_group`` from
  explicit arguments, torchrun's variables or SLURM's; inert (returns
  False) when none is set.  NCCL for CUDA, gloo for the CPU, or the
  backend asked for; on CUDA each rank takes ``LOCAL_RANK % device_count``
  (several gloo ranks may share one card).  The group gets a timeout, so a
  rank that falls out of lockstep fails the run instead of hanging it.
* :func:`host_seed_blocks` — the round-robin share of a seed sweep by rank
  (every block without a group), for embarrassingly parallel repeats.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import List

import torch
import torch.distributed as dist

DEFAULT_PORT = 29500
TIMEOUT_S = 300.0


def _int_env(name: str, default=None):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _first_host(nodelist: str) -> str:
    """The first host of a SLURM node list ("gpu[03-05,07],cpu1" ->
    "gpu03")."""
    head = re.match(r"[^,\[]+(\[[^\]]*\])?", nodelist).group(0)
    if "[" not in head:
        return head
    prefix, rng = head[:-1].split("[")
    return prefix + re.split(r"[,-]", rng)[0]


def init_multihost(coordinator: str = None, num_processes: int = None,
                   process_id: int = None, backend: str = None,
                   timeout: float = TIMEOUT_S) -> bool:
    """Initialise the default process group where a multi-process run is
    configured; returns True if it was.

    Reads, in order: the arguments (``coordinator`` "host:port"), torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, then SLURM
    (``SLURM_PROCID``, ``SLURM_NTASKS`` > 1, the first host of
    ``SLURM_JOB_NODELIST`` or ``MASTER_ADDR``; ``MASTER_PORT`` or 29500).
    """
    env = os.environ
    if coordinator is not None or num_processes is not None:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("init_multihost: give coordinator, "
                             "num_processes and process_id together")
        host, port = coordinator.rsplit(":", 1)
        addr, world, rank = f"tcp://{host}:{port}", num_processes, process_id
    elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                "WORLD_SIZE")):
        addr = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif "SLURM_PROCID" in env and _int_env("SLURM_NTASKS", 1) > 1:
        host = env.get("MASTER_ADDR") or _first_host(
            env["SLURM_JOB_NODELIST"])
        addr = f"tcp://{host}:{_int_env('MASTER_PORT', DEFAULT_PORT)}"
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
    else:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        local = _int_env("LOCAL_RANK", _int_env("SLURM_LOCALID", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=addr,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def host_seed_blocks(total_blocks: int) -> List[int]:
    """This process's share of a seed sweep (round-robin over ranks)."""
    if not (dist.is_available() and dist.is_initialized()):
        return list(range(total_blocks))
    pid, n = dist.get_rank(), dist.get_world_size()
    return [b for b in range(total_blocks) if b % n == pid]
