"""Multi-process start-up of the port (``parallel/distributed.py``) and a
real 4-process gloo run of ``python -m sampling_gpmpc_torch.parallel.
worker`` against the in-process blocked solve.

* ``host_seed_blocks``: one process gets every block; the shares are
  disjoint, exhaustive and balanced for (2, 10), (3, 8), (5, 4) ranks and
  blocks;
* ``init_multihost`` stays inert without the cluster variables, and
  parses a SLURM node list's first host;
* four worker processes (gloo, CPU, float64, one torch thread each) run
  the ORDERED sharded solve of params_pendulum1D_samples at ns = 16 over 3
  forced SQP iterations: their gathered U, X and hall_Y are bit-identical
  to ``make_blocked_solve``'s in this process (the same per-block program,
  the same rank-order sums), every rank's QPs took the group route, and
  no IPM kernel ran.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sampling_gpmpc_torch.parallel import distributed
from sampling_gpmpc_torch.parallel.sharded import make_blocked_solve
from sampling_gpmpc_torch.parallel.worker import COUNTERS, problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS",
                "SLURM_JOB_NODELIST", "SLURM_JOB_ID")


def test_single_process_gets_all_blocks():
    assert distributed.host_seed_blocks(7) == list(range(7))


@pytest.mark.parametrize("n_proc,total", [(2, 10), (3, 8), (5, 4)])
def test_blocks_partition_disjoint_and_exhaustive(monkeypatch, n_proc,
                                                  total):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: n_proc)
    shares = []
    for pid in range(n_proc):
        monkeypatch.setattr(dist, "get_rank", lambda p=pid: p)
        shares.append(distributed.host_seed_blocks(total))
    flat = [b for s in shares for b in s]
    assert sorted(flat) == list(range(total))        # exhaustive, disjoint
    sizes = [len(s) for s in shares]
    assert max(sizes) - min(sizes) <= 1              # round-robin balance


def test_init_multihost_inert_without_cluster_env(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_multihost() is False
    assert not dist.is_initialized()


def test_init_multihost_inert_for_a_one_task_slurm_job(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert distributed.init_multihost() is False


@pytest.mark.parametrize("nodelist,host", [
    ("gpu[03-05,07],cpu1", "gpu03"), ("node7,node8", "node7"),
    ("solo", "solo")])
def test_slurm_first_host(nodelist, host):
    assert distributed._first_host(nodelist) == host


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_gloo_processes_match_blocked_bitwise(tmp_path):
    out_npz = str(tmp_path / "shard.npz")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_VARS}
    env.update(PYTHONPATH=ROOT, SGPMPC_DTYPE="float64")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sampling_gpmpc_torch.parallel.worker",
         "--rank", str(r), "--world", "4", "--port", str(port), "--out",
         out_npz, "--device", "cpu", "--backend", "gloo", "--ns", "16",
         "--max-sqp", "3", "--ordered"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"WORKER_OK rank={r} world=4 it=3 status=0" in out

    got = np.load(out_npz)
    assert int(got["status"]) == 0 and int(got["it"]) == 3
    launches = dict(zip(COUNTERS, got["launches"].T))
    assert (launches["qp_group"] == 3).all()          # every rank, every QP
    for k in ("ipm_prepare", "ipm_mehrotra", "qp_run_full"):
        assert (launches[k] == 0).all(), k

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spec, env_, hyp, ocp, gp, X, U, st, eps = problem(
            "params_pendulum1D_samples", 16, 3, torch.device("cpu"),
            torch.float64)
        ref = make_blocked_solve(spec, env_, hyp, ocp, 4)(st, X, U, gp, eps)
    finally:
        torch.set_num_threads(old)
    assert ref.it == 3
    assert int(ref.gp.hall_n) == int(got["hall_n"]) == 3 * spec.H
    for k, r in (("U", ref.U), ("X", ref.X), ("hall_Y", ref.gp.hall_Y)):
        assert np.array_equal(got[k], r.numpy(), equal_nan=True), k
