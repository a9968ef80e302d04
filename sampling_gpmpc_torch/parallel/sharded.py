"""Sample-axis-sharded SQP solve, closed loop and forward-sampling rollout.

Counterpart of ``sampling_gpmpc_tpu/parallel/sharded.py``.  Each rank of a
group runs the port's ``ocp/sqp.py`` body on ``ns // world`` local samples;
per SQP iteration the cross-shard traffic is

  * one tuple-psum of the condensed (nU, nU) input Hessian and (nU,)
    gradient (``ocp/assemble.py::build_cost``),
  * the QP's per-iteration reductions: tuple-psums of the Schur complement
    and right-hand side, psums of the complementarity, pmin of the step
    ratios, pmax of the residuals (``ops/ipm.py`` plain body; the JAX
    package also leaves its Pallas IPM off under a sample axis, so the
    kernels 1-2 do not run here),
  * scalar psums for the convergence norms (``ocp/sqp.py::consume_step``).

The GP stages stay shard-local and go through the GP kernels on the local
sample count, as the JAX gates are taken on the local ``ns``.

Partitioning (that of the JAX specs): split on their sample axis are X,
X_prev, the hallucination buffers hall_Z/hall_Y, the epistemic draws, the
per-sample cost weights ``ocp.w_cost`` and the QP warm start's row slots
``qp_ws[1:]`` (each shard owns its samples' rows, the input box included,
so a global warm start is the shards' row blocks one after another);
replicated are U, U_prev, the real data and its factor, hall_n,
``qp_ws[0]`` (dU) and every scalar.

The callables take global-shape arrays and return this rank's shard;
:func:`gather_state` assembles the global state (a collective).
:func:`make_blocked_solve` runs the n-block ordered program in one process
(a :class:`~sampling_gpmpc_torch.parallel.collectives.BlockGroup`) and
returns global arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sampling_gpmpc_torch.agent import GPState
from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.dempc import shift_solution
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.parallel.collectives import (BlockGroup,
                                                       gather_cat,
                                                       group_rank,
                                                       group_size,
                                                       make_reducers, split)
from sampling_gpmpc_torch.reachability import forward_sample_rollout

# SolveState fields that every rank holds alike
REPLICATED = ("U", "U_prev", "it", "status", "done", "qp_valid", "qp_iters",
              "qp_gap", "best_step", "stall_count", "mono_count", "alpha")


def local_spec(spec: ProblemSpec, group) -> ProblemSpec:
    """The spec a rank runs: ``spec.ns // world`` samples."""
    n = group_size(group)
    assert spec.ns % n == 0, (
        f"num_dyn_samples={spec.ns} must divide over {n} devices")
    return dataclasses.replace(spec, ns=spec.ns // n)


def shard_ocp(ocp, group):
    return ocp._replace(w_cost=split(ocp.w_cost, group, 0))


def shard_gp(gp: GPState, group) -> GPState:
    return gp._replace(hall_Z=split(gp.hall_Z, group, 0),
                       hall_Y=split(gp.hall_Y, group, 0))


def shard_ws(ws, group):
    if ws is None:
        return None
    return (ws[0],) + tuple(split(w, group, 0) for w in ws[1:])


def make_sharded_solve(spec: ProblemSpec, env, hyp, ocp, group,
                       ordered: bool = False):
    """``sqp.solve`` over the sample axis of ``group``.

    Returns ``solve(st_curr, X0, U0, gp0, eps_iters, qp_ws=None,
    qp_valid=None) -> SolveState``: global-shape inputs (X0 (H+1, ns, nx),
    eps_iters (max_sqp_iter, ns, ...), the global warm start), this rank's
    shard of the result.  ``ordered``: the order-defined sums of
    parallel/collectives.py.
    """
    lspec = local_spec(spec, group)

    def solve(st_curr, X0, U0, gp0, eps_iters, qp_ws=None, qp_valid=None):
        return sqp.solve(lspec, env, hyp, shard_ocp(ocp, group), st_curr,
                         split(X0, group, 1), U0, shard_gp(gp0, group),
                         split(eps_iters, group, 1), shard_ws(qp_ws, group),
                         qp_valid, group=group, ordered=ordered)

    return solve


def merge_states(states):
    """The global SolveState from every rank's shard, in rank order."""
    s0 = states[0]
    cat = lambda get, dim: torch.cat([get(s) for s in states], dim)  # noqa
    return s0._replace(
        X=cat(lambda s: s.X, 1), X_prev=cat(lambda s: s.X_prev, 1),
        gp=s0.gp._replace(hall_Z=cat(lambda s: s.gp.hall_Z, 0),
                          hall_Y=cat(lambda s: s.gp.hall_Y, 0)),
        qp_ws=(s0.qp_ws[0],) + tuple(cat(lambda s: s.qp_ws[i], 0)
                                     for i in range(1, len(s0.qp_ws))))


def gather_state(state, group):
    """The global SolveState on every rank (a collective: all ranks call
    it)."""
    g = lambda a, dim: gather_cat(a, group, dim)  # noqa: E731
    return state._replace(
        X=g(state.X, 1), X_prev=g(state.X_prev, 1),
        gp=state.gp._replace(hall_Z=g(state.gp.hall_Z, 0),
                             hall_Y=g(state.gp.hall_Y, 0)),
        qp_ws=(state.qp_ws[0],) + tuple(g(w, 0) for w in state.qp_ws[1:]))


def _same(a, b) -> bool:
    """Bitwise equal values (NaN where the other has NaN)."""
    if isinstance(a, torch.Tensor) and not a.is_floating_point():
        return torch.equal(a, b)
    if isinstance(a, torch.Tensor):
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))
    return a == b


def assert_replicated(states) -> None:
    """Every rank's copy of the replicated fields is the same, bit for
    bit (the blocks saw the same ordered-collective results)."""
    for r, s in enumerate(states[1:], 1):
        for f in REPLICATED:
            if not _same(getattr(s, f), getattr(states[0], f)):
                raise AssertionError(f"block {r}: replicated field {f} "
                                     f"differs from block 0's")
        if not (_same(s.qp_ws[0], states[0].qp_ws[0])
                and s.gp.hall_n == states[0].gp.hall_n):
            raise AssertionError(f"block {r}: replicated dU warm start or "
                                 f"hall_n differs from block 0's")


def make_blocked_solve(spec: ProblemSpec, env, hyp, ocp, n_blocks: int):
    """The n-block ORDERED sharded solve in one process.

    One thread per block on a :class:`BlockGroup` (the blocks take turns
    between collectives) runs the per-block program
    of :func:`make_sharded_solve` with the same rank-order sequential sums,
    so it is the floating-point computation of ``n_blocks`` ranks with
    ``ordered=True``.  Takes and returns global-shape arrays; the
    replicated fields come from block 0, after checking bitwise that every
    block holds the same.  ``blocked.group.launches`` has each block's
    kernel launches and QP routes of the last call.
    """
    group = BlockGroup(n_blocks)
    solve = make_sharded_solve(spec, env, hyp, ocp, group, ordered=True)

    def blocked(*args, **kwargs):
        states = group.run(solve, *args, **kwargs)
        assert_replicated(states)
        return merge_states(states)

    blocked.group = group
    return blocked


def make_sharded_closed_loop(spec: ProblemSpec, env, hyp, ocp, group,
                             ordered: bool = False):
    """W receding-horizon MPC steps over the sample axis of ``group``.

    Per step: a sharded solve (hallucination reset at entry, the QP warm
    start carried across steps), the ancillary feedback on u0, the plant
    step from global sample 0's stage 0, and the warm-start shift
    (ref: src/DEMPC.py:39-80, src/solver.py:174-189).

    Returns ``loop(x0, X0, U0, gp0, eps_all) -> (x, X, U, gp)`` with
    ``eps_all`` (W, max_sqp_iter, ns, g_ny, H, Ty) global; X and gp come
    back as this rank's shard, x and U replicated.
    """
    lspec = local_spec(spec, group)
    psum = make_reducers(group, ordered)[0]

    def loop(x0, X0, U0, gp0, eps_all):
        ocp_l = shard_ocp(ocp, group)
        X, U, gp = split(X0, group, 1), U0, shard_gp(gp0, group)
        eps = split(eps_all, group, 2)
        ws = sqp.init_qp_ws(lspec, X.device, X.dtype)
        wv = torch.zeros((), dtype=torch.bool, device=X.device)
        x = x0
        for k in range(eps.shape[0]):
            st = sqp.solve(lspec, env, hyp, ocp_l, x, X, U, gp, eps[k], ws,
                           wv, group=group, ordered=ordered)
            X, U, gp, ws, wv = st.X, st.U, st.gp, st.qp_ws, st.qp_valid
            # global sample 0 lives on rank 0; a psum of zeros elsewhere
            # hands every rank its stage-0 state (x + 0 is exact)
            x_s = psum(X[0, 0] if group_rank(group) == 0
                       else torch.zeros_like(X[0, 0]))
            u0 = U[0]
            if lspec.use_feedback:
                u0 = u0 - (ocp_l.x_eq - x_s) @ ocp_l.K_fb.T
            x = env.discrete_dyn(x_s, u0).reshape(-1)
            if lspec.shift_soln:
                X, U = shift_solution(X, U)
        return x, X, U, gp

    return loop


def shard_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: independent streams per
    (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def make_sharded_rollout(spec: ProblemSpec, env, hyp, group,
                         use_feedback=None):
    """Forward-sampling reachability over the sample axis of ``group``.

    Realizations are independent, so there are no collectives: each rank
    rolls its ``ns // world`` with ``reachability.forward_sample_rollout``.
    Returns ``roll(gp0, x0, U, seed=None, eps=None) -> (X, gp)``, this
    rank's shard.  Draws come from a ``torch.Generator`` seeded from
    ``(seed, rank)`` (:func:`shard_seed`; ``spec.seed`` by default), or
    from injected global ``eps`` (T, ns, g_ny, 1, Ty) split on the sample
    axis, which makes the sharded rollout the one-device rollout's shards.
    """
    lspec = local_spec(spec, group)

    def roll(gp0, x0, U, seed=None, eps=None):
        x0 = torch.as_tensor(x0)
        if x0.dim() == 2:
            x0 = split(x0, group, 0)
        gen = None
        if eps is None:
            gen = torch.Generator().manual_seed(shard_seed(
                spec.seed if seed is None else seed, group_rank(group)))
        else:
            eps = split(torch.as_tensor(eps), group, 1)
        return forward_sample_rollout(lspec, env, hyp, shard_gp(gp0, group),
                                      x0, U, gen, use_feedback=use_feedback,
                                      eps=eps)

    return roll
