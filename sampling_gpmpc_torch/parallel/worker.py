"""One rank of a multi-process sample-sharded SQP solve.

Counterpart of the JAX package's ``tests/distributed_worker.py``.  Every
rank starts through ``parallel.distributed.init_multihost``, builds the
same problem on the same seeded draws, runs ``make_sharded_solve`` on its
shard and takes part in gathering the global state; rank 0 writes ``X``,
``U``, ``hall_Y``, ``status``, ``it``, every rank's kernel launches and QP
routes, and the ms of each solve to an ``.npz``.

Four ranks sharing one card (gloo, its collectives staged through host
memory):

    for r in 0 1 2 3; do
      python -m sampling_gpmpc_torch.parallel.worker --rank $r --world 4 \\
          --port 29533 --out /tmp/shard.npz --backend gloo --ordered &
    done; wait

One rank per card under torchrun (NCCL): ``torchrun --nproc-per-node 4 -m
sampling_gpmpc_torch.parallel.worker --out /tmp/shard.npz`` (rank, world
and port then come from torchrun's variables).  ``--device cpu`` runs on
the CPU in float64 with one torch thread per rank, the single-thread
program an in-process ``make_blocked_solve`` runs too.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from sampling_gpmpc_torch import agent, setup
from sampling_gpmpc_torch.config import load_problem
from sampling_gpmpc_torch.envs import make_env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.ocp import qp as qp_mod
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.spec import make_ocp_data
from sampling_gpmpc_torch.ops import routes
from sampling_gpmpc_torch.parallel import distributed
from sampling_gpmpc_torch.parallel.collectives import all_gather
from sampling_gpmpc_torch.parallel.mesh import sample_mesh
from sampling_gpmpc_torch.parallel.sharded import (gather_state,
                                                   make_sharded_solve)

PARAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "params")
# per-rank counters the worker reports, in this order
COUNTERS = ("gp_sample", "gp_hall", "ipm_prepare", "ipm_mehrotra",
            "qp_group", "qp_run_full", "glue_condense", "glue_gram",
            "gp_hall_blocks")


def problem(config: str, ns: int, max_sqp: int, device, dtype,
            **spec_over):
    """One MPC step's solve inputs of a config at ``ns`` samples, with
    ``max_sqp`` forced SQP iterations (``tol_nlp = 0`` where > 1) on the
    port's seeded draws, ``spec_over`` replacing further fields of the
    spec: (spec, env, hyp, ocp, gp, X0, U0, st, eps)."""
    params, spec, data = load_problem(os.path.join(PARAMS, config + ".yaml"))
    over = dict(ns=ns, num_mpc_iter=1, max_sqp_iter=max_sqp, **spec_over)
    if max_sqp > 1:
        over["tol_nlp"] = 0.0
    spec = dataclasses.replace(spec, **over)
    params["agent"]["num_dyn_samples"] = ns
    env = make_env(spec, params)
    ocp = make_ocp_data(spec, data, device, dtype)
    hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)
    gp = agent.init_gp_state(spec, env, device, dtype, hyp=hyp)
    X0, U0 = sqp.init_iterate(spec, device, dtype, data.start)
    eps = agent.make_epistemic(spec, None, device, dtype)[0]
    st = torch.as_tensor(data.start, dtype=dtype, device=device)
    return spec, env, hyp, ocp, gp, X0, U0, st, eps


def glue_inputs(config: str, ns: int, device, dtype, **spec_over):
    """One SQP iteration's inputs to ``ocp/assemble.py::condensed_qp`` at
    ``ns`` samples, from a seeded perturbation of :func:`problem`'s start
    iterate and state (so T and every row is nonzero): ((spec, ocp,
    combined, X, U, st), (env, hyp, gp, eps0)), ``combined`` the rows of
    ``Env.assemble_val_jac`` at the iterate."""
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        config, ns, 1, device, dtype, **spec_over)
    g = torch.Generator().manual_seed(ns)
    X = X0 + (0.05 * torch.randn(X0.shape, generator=g, dtype=dtype)).to(
        device)
    U = U0 + (0.3 * torch.randn(U0.shape, generator=g, dtype=dtype)).to(
        device)
    st = st + 0.01
    xu = sqp._linearization_inputs(spec, ocp, X, U)
    dg, _ = agent.sample_dynamics(spec, env, hyp, gp,
                                  xu[..., list(spec.g_idx_inputs)], eps[0],
                                  hall_empty=True)
    combined = env.assemble_val_jac(xu, dg.transpose(1, 2))
    return (spec, ocp, combined, X, U, st), (env, hyp, gp, eps[0])


def hall_inputs(config: str, ns: int, max_sqp: int, device, dtype,
                **spec_over):
    """The hall stages of one MPC step of ``max_sqp`` forced SQP
    iterations at ``ns`` samples, as ``agent.sample_dynamics`` meets them:
    for each iteration k >= 1 (fill k H), (spec, hyp, gp, Xt, eps_k).  The
    GP inputs are a seeded perturbation of :func:`problem`'s start iterate,
    a new one each iteration; each iteration draws its rows through
    ``agent.sample_dynamics`` on ``device`` and appends them."""
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        config, ns, max_sqp, device, dtype, **spec_over)
    g = torch.Generator().manual_seed(ns)
    xu = sqp._linearization_inputs(spec, ocp, X0, U0)[
        ..., list(spec.g_idx_inputs)]
    stages = []
    for it in range(max_sqp):
        Xt = xu + (0.05 * torch.randn(xu.shape, generator=g,
                                      dtype=dtype)).to(device)
        if it:
            stages.append((spec, hyp, gp, Xt, eps[it]))
        _, gp = agent.sample_dynamics(spec, env, hyp, gp, Xt, eps[it],
                                      hall_empty=(it == 0))
    return stages


def counters() -> dict:
    return {**routes.launch_counts(),
            "qp_group": qp_mod.ROUTES["group"],
            "qp_run_full": qp_mod.ROUTES["run_full"]}


def zero_counters() -> None:
    routes.zero_launch_counts()
    qp_mod.ROUTES.update(dict.fromkeys(qp_mod.ROUTES, 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on CUDA)")
    ap.add_argument("--config", default="params_pendulum1D_samples")
    ap.add_argument("--ns", type=int, default=16)
    ap.add_argument("--max-sqp", type=int, default=3,
                    help="SQP iterations, all run (tol_nlp = 0) where > 1")
    ap.add_argument("--ordered", action="store_true",
                    help="order-defined sums (parallel/collectives.py)")
    ap.add_argument("--repeats", type=int, default=1)
    a = ap.parse_args(argv)
    dev = setup.resolve_device(a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    coord = None if a.port is None else f"127.0.0.1:{a.port}"
    if not distributed.init_multihost(coord, a.world, a.rank, a.backend):
        raise SystemExit("no multi-process run configured: give --rank, "
                         "--world and --port, or run under torchrun")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = sample_mesh()
        group = mesh.group
        dtype = setup.default_dtype(dev)
        spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
            a.config, a.ns, a.max_sqp, dev, dtype)
        solve = make_sharded_solve(spec, env, hyp, ocp, group,
                                   ordered=a.ordered)
        ms = []
        for _ in range(a.repeats):
            zero_counters()
            dist.barrier(group)
            t0 = time.perf_counter()
            out = solve(st, X0, U0, gp, eps)
            int(out.status)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        mine = counters()
        full = gather_state(out, group)
        per_rank = torch.stack(all_gather(
            torch.tensor([mine[k] for k in COUNTERS], dtype=torch.int64,
                         device=dev), group)).cpu().numpy()
        if mesh.rank == 0:
            host = lambda t: t.detach().cpu().numpy()  # noqa: E731
            np.savez(a.out, X=host(full.X), U=host(full.U),
                     hall_Y=host(full.gp.hall_Y), status=int(full.status),
                     it=int(full.it), hall_n=int(full.gp.hall_n),
                     launches=per_rank, counters=np.array(COUNTERS),
                     ms=np.array(ms), world=mesh.world,
                     backend=dist.get_backend())
        print(f"WORKER_OK rank={mesh.rank} world={mesh.world} it={out.it} "
              f"status={int(out.status)} ms={[round(v, 3) for v in ms]}",
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
