"""The port's sample-sharded solve (``sampling_gpmpc_torch/parallel/``)
against its one-device solve and against the JAX package's sharded solve.

* the reducers: identities without a group; the ordered sum is the
  block-order sequential sum bit for bit; a tuple's leaves reduce as
  separate calls would; pmin / pmax;
* params_pendulum1D_samples at ns = 16 over 4 blocks (the sizes of the JAX
  package's tests/test_sharded.py), float64 on the CPU: one SQP iteration
  against the one-device solve at JAX's bars (U rtol 1e-9 atol 1e-11, X
  rtol 1e-8 atol 1e-10, same status and iterations); 2 blocks against 4
  at rtol 1e-6 atol 1e-8; the ordered 4-block solve at 3 forced SQP
  iterations against JAX's ``make_sharded_solve(..., ordered=True)`` on a
  4-device CPU mesh on JAX's draws, within JAX's own 1e-5
  (``__graft_entry__.dryrun_multichip``'s tol3);
* a 3-step sharded closed loop against the one-device loop at 1e-5
  (JAX's tol_w);
* the sharded rollout against the one-device rollout on the same
  injected draws at 1e-12, and its shape, finiteness and determinism per
  seed (JAX's test_sharded_rollout);
* ``true_dyn_as_sample`` overrides global sample 0 only.

The blocks run as threads of one process (``BlockGroup``); the
multi-process route is tests/test_torch_distributed.py.  Torch runs on one
thread (the suite's workers oversubscribe the cores otherwise).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_torch import agent
from sampling_gpmpc_torch.dempc import shift_solution
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.parallel import sharded
from sampling_gpmpc_torch.parallel.collectives import (BlockGroup,
                                                       make_reducers,
                                                       ordered_sum, split)
from sampling_gpmpc_torch.parallel.mesh import sample_mesh
from sampling_gpmpc_torch.parallel.worker import problem

CONFIG = "params_pendulum1D_samples"
CPU, F64 = torch.device("cpu"), torch.float64


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


# ---------------------------------------------------------------- reducers

def test_reducers_without_group_are_identities():
    x = torch.arange(6.0)
    tup = (x, x[:2])
    for red in make_reducers(None):
        assert red(x) is x
        assert red(tup) is tup
    for red in make_reducers(None, ordered=True):
        assert red(x) is x


def _partials(n, shape=(5, 7)):
    """Per-block partials spanning 12 orders of magnitude, so the order
    of a sum shows in the last bits."""
    rng = np.random.default_rng(3)
    return [torch.as_tensor(rng.normal(size=shape)
                            * 10.0 ** rng.integers(-6, 7, size=shape))
            for _ in range(n)]


@pytest.mark.parametrize("n", [2, 4, 5])
def test_ordered_psum_is_block_order_sum(n):
    parts = _partials(n)
    g = BlockGroup(n)
    psum = make_reducers(g, ordered=True)[0]
    got = g.run(lambda: psum(parts[g.rank()]))
    ref = parts[0]
    for p in parts[1:]:
        ref = ref + p
    for r in range(n):
        assert torch.equal(got[r], ref), r
    assert torch.equal(ordered_sum(parts), ref)
    if n > 2:       # the check can see the order: reversed, it differs
        assert not torch.equal(ordered_sum(parts[::-1]), ref)


@pytest.mark.parametrize("ordered", [False, True])
def test_tuple_leaves_reduce_like_separate_calls(ordered):
    n = 4
    a, b, c = _partials(n, (3, 4)), _partials(n, (6,)), _partials(n, ())
    g = BlockGroup(n)
    reds = make_reducers(g, ordered)

    def body():
        r = g.rank()
        out = []
        for red in reds:
            fused = red((a[r], b[r], c[r]))
            each = (red(a[r]), red(b[r]), red(c[r]))
            out.append((fused, each))
        return out

    for per_block in g.run(body):
        for fused, each in per_block:
            assert len(fused) == 3
            for f, e in zip(fused, each):
                assert f.shape == e.shape and torch.equal(f, e)


def test_pmin_pmax_are_elementwise_over_blocks():
    n = 3
    parts = _partials(n, (4, 4))
    g = BlockGroup(n)
    _, pmin, pmax = make_reducers(g)
    got = g.run(lambda: (pmin(parts[g.rank()]), pmax(parts[g.rank()])))
    stack = torch.stack(parts)
    for lo, hi in got:
        assert torch.equal(lo, stack.amin(0))
        assert torch.equal(hi, stack.amax(0))


def test_block_group_failure_is_raised_not_hung():
    g = BlockGroup(3, timeout=30.0)
    psum = make_reducers(g)[0]

    def body():
        if g.rank() == 1:
            raise ValueError("block 1 fails before its collective")
        return psum(torch.ones(2))

    with pytest.raises(ValueError, match="block 1 fails"):
        g.run(body)


def test_block_out_of_lockstep_fails_at_the_timeout():
    """A block that issues one collective more than the others waits for
    a turn that never comes: LockstepError after the timeout, no hang."""
    from sampling_gpmpc_torch.parallel.collectives import LockstepError
    g = BlockGroup(2, timeout=1.0)
    psum = make_reducers(g)[0]

    def body():
        x = psum(torch.ones(1))
        if g.rank() == 1:
            x = psum(x)
        return x

    with pytest.raises(LockstepError, match="waited 1.0 s"):
        g.run(body)


def test_block_group_stress_with_short_switch_interval():
    """More blocks than cores, 200 collectives each and a 1 us switch
    interval: every block's every sum is the exact rank-order sum, and
    the launch counter, bumped from every block, loses no update."""
    import sys
    from sampling_gpmpc_torch import obs
    n, rounds = 12, 200
    g = BlockGroup(n, timeout=60.0)
    psum = make_reducers(g, ordered=True)[0]
    table = {"k": 0}

    def body():
        r, out = g.rank(), []
        for i in range(rounds):
            out.append(float(psum(torch.tensor([float(r * rounds + i)]))))
            obs.count(table, "k")
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = g.run(body)
    finally:
        sys.setswitchinterval(old)
    want = [float(sum(r * rounds + i for r in range(n)))
            for i in range(rounds)]
    assert all(o == want for o in got)
    assert table["k"] == n * rounds
    assert all(b == {"k": rounds} for b in g.launches)


def test_sample_mesh_layout():
    m = sample_mesh(4)
    assert m.world == 4 and m.local_ns(16) == 4
    assert m.group.run(lambda: m.offset(16)) == [0, 4, 8, 12]
    with pytest.raises(AssertionError, match="must divide over 4"):
        m.local_ns(10)
    assert sample_mesh().world == 1 and sample_mesh().group is None


# ------------------------------------------------------- the sharded solve

def _setup(max_sqp=1, ns=16):
    return problem(CONFIG, ns, max_sqp, CPU, F64)


def _sharded(spec, env, hyp, ocp, n, args, ordered=False):
    g = BlockGroup(n)
    solve = sharded.make_sharded_solve(spec, env, hyp, ocp, g, ordered)
    states = g.run(solve, *args)
    sharded.assert_replicated(states)
    return sharded.merge_states(states)


def test_sharded_matches_single_device():
    spec, env, hyp, ocp, gp, X, U, st, eps = _setup()
    ref = sqp.solve(spec, env, hyp, ocp, st, X, U, gp, eps)
    out = _sharded(spec, env, hyp, ocp, 4, (st, X, U, gp, eps))
    np.testing.assert_allclose(out.U.numpy(), ref.U.numpy(), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(out.X.numpy(), ref.X.numpy(), rtol=1e-8,
                               atol=1e-10)
    assert int(out.status) == int(ref.status) == 0
    assert out.it == ref.it == 1


def test_sharded_solve_recorded_matches_sharded_solve():
    """solve_recorded under a group runs the sharded solve's iterations
    bit for bit (3 forced SQP iterations, 2 blocks)."""
    spec, env, hyp, ocp, gp, X, U, st, eps = _setup(max_sqp=3)
    g = BlockGroup(2)
    lspec = sharded.local_spec(spec, g)

    def body(recorded):
        args = (lspec, env, hyp, sharded.shard_ocp(ocp, g), st,
                split(X, g, 1), U, sharded.shard_gp(gp, g),
                split(eps, g, 1))
        if recorded:
            s, recs = sqp.solve_recorded(*args, group=g, ordered=True)
            assert len(recs) == s.it
            return s
        return sqp.solve(*args, group=g, ordered=True)

    a = sharded.merge_states(g.run(body, False))
    b = sharded.merge_states(g.run(body, True))
    assert a.it == b.it == 3
    for k in ("X", "U", "X_prev", "U_prev", "status", "qp_iters"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_sharded_two_vs_four_blocks():
    spec, env, hyp, ocp, gp, X, U, st, eps = _setup()
    out2 = _sharded(spec, env, hyp, ocp, 2, (st, X, U, gp, eps))
    out4 = _sharded(spec, env, hyp, ocp, 4, (st, X, U, gp, eps))
    np.testing.assert_allclose(out2.U.numpy(), out4.U.numpy(), rtol=1e-6,
                               atol=1e-8)


def test_sharded_asserts_divisibility():
    spec, env, hyp, ocp, *_ = _setup()
    with pytest.raises(AssertionError,
                       match="num_dyn_samples=16 must divide over 3"):
        sharded.make_sharded_solve(spec, env, hyp, ocp, BlockGroup(3))


def _jax_problem(ns, max_sqp):
    from sampling_gpmpc_tpu import agent as jagent
    from sampling_gpmpc_tpu.config import load_problem
    from sampling_gpmpc_tpu.envs import make_env
    from sampling_gpmpc_tpu.gp.exact import GPHyperArrays
    from sampling_gpmpc_tpu.ocp import sqp as jsqp
    from sampling_gpmpc_tpu.ocp.spec import make_ocp_data
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, spec, data = load_problem(
        os.path.join(here, "params", CONFIG + ".yaml"))
    spec = dataclasses.replace(spec, ns=ns, num_mpc_iter=1,
                               max_sqp_iter=max_sqp, tol_nlp=0.0)
    params["agent"]["num_dyn_samples"] = ns
    env = make_env(spec, params)
    dt = jnp.float64
    ocp = make_ocp_data(spec, data, dt)
    hyp = GPHyperArrays.from_spec(spec.gp, dt)
    gp = jagent.init_gp_state(spec, env, dt)
    X, U = jsqp.init_iterate(spec, dt, data.start)
    eps = jagent.make_epistemic(jax.random.PRNGKey(spec.seed), spec, dt)[0]
    return spec, env, hyp, ocp, gp, X, U, jnp.asarray(data.start, dt), eps


def test_ordered_blocked_matches_jax_ordered_sharded():
    """3 forced SQP iterations, 4 blocks, ordered sums on both sides, the
    same inputs and JAX's draws: within JAX's own 1e-5 (the measured
    difference is printed)."""
    from sampling_gpmpc_tpu.parallel.mesh import sample_mesh as jmesh
    from sampling_gpmpc_tpu.parallel.sharded import (
        make_sharded_solve as jsharded)
    jspec, jenv, jhyp, jocp, jgp, jX, jU, jst, jeps = _jax_problem(16, 3)
    jout = jsharded(jspec, jenv, jhyp, jocp, jmesh(4), ordered=True)(
        jst, jX, jU, jgp, jeps)
    spec, env, hyp, ocp, gp, X, U, st, _ = _setup(max_sqp=3)
    eps = torch.from_numpy(np.array(jeps))
    out = sharded.make_blocked_solve(spec, env, hyp, ocp, 4)(
        st, X, U, gp, eps)
    assert out.it == int(jout.it) == 3
    assert int(out.status) == int(jout.status) == 0
    du = float(np.max(np.abs(out.U.numpy() - np.asarray(jout.U))))
    dx = float(np.max(np.abs(out.X.numpy() - np.asarray(jout.X))))
    dh = float(np.nanmax(np.abs(out.gp.hall_Y.numpy()
                                - np.asarray(jout.gp.hall_Y))))
    print(f"port ordered 4-block vs JAX ordered 4-device, 3 iterations: "
          f"max|dU| {du:.3e}, max|dX| {dx:.3e}, max|d hall_Y| {dh:.3e}")
    assert max(du, dx, dh) < 1e-5


# ------------------------------------------------ closed loop and rollout

def test_sharded_closed_loop_matches_one_device():
    """3 receding-horizon steps (QP warm start carried, hall reset at
    every solve, warm-start shift) over 4 blocks against the one-device
    loop: the plant state at JAX's tol_w = 1e-5.  The plans are not held
    at that bar, as JAX does not hold them: each float64 QP stops at a
    relative KKT residual of 1e-8, which leaves up to ~3e-4 in U along
    flat cost directions (measured at step 2, both routes at status 0)."""
    W = 3
    spec, env, hyp, ocp, gp, X, U, st, _ = _setup()
    spec = dataclasses.replace(spec, num_mpc_iter=W)
    eps_w = agent.make_epistemic(spec, None, CPU, F64)
    g = BlockGroup(4)
    loop = sharded.make_sharded_closed_loop(spec, env, hyp, ocp, g)
    outs = g.run(loop, st, X, U, gp, eps_w)
    x_w, U_w = outs[0][0], outs[0][2]
    for o in outs[1:]:
        assert torch.equal(o[0], x_w) and torch.equal(o[2], U_w)
    assert outs[0][3].hall_n == spec.H

    x, ws = st, sqp.init_qp_ws(spec, CPU, F64)
    wv = torch.zeros((), dtype=torch.bool)
    for k in range(W):
        s = sqp.solve(spec, env, hyp, ocp, x, X, U, gp, eps_w[k], ws, wv)
        X, U, gp, ws, wv = s.X, s.U, s.gp, s.qp_ws, s.qp_valid
        u0 = U[0]
        if spec.use_feedback:
            u0 = u0 - (ocp.x_eq - X[0, 0]) @ ocp.K_fb.T
        x = env.discrete_dyn(X[0, 0], u0).reshape(-1)
        if spec.shift_soln:
            X, U = shift_solution(X, U)
    assert bool(torch.isfinite(x_w).all())
    assert float((x_w - x).abs().max()) < 1e-5


def _rollout_setup():
    spec, env, hyp, _, _, _, _, x0, _ = _setup()
    T = 5
    gp = agent.init_gp_state(spec, env, CPU, F64, capacity=T, hyp=hyp)
    U = torch.full((T, spec.nu), 0.5, dtype=F64)
    return spec, env, hyp, gp, x0, U, T


def test_sharded_rollout_matches_one_device_on_injected_draws():
    from sampling_gpmpc_torch.reachability import forward_sample_rollout
    spec, env, hyp, gp, x0, U, T = _rollout_setup()
    eps = agent.truncated_normal((T, spec.ns, spec.g_ny, 1, spec.Ty),
                                 spec.gp.beta,
                                 torch.Generator().manual_seed(11), CPU, F64)
    ref, _ = forward_sample_rollout(spec, env, hyp, gp, x0, U, eps=eps)
    g = BlockGroup(4)
    roll = sharded.make_sharded_rollout(spec, env, hyp, g)
    outs = g.run(roll, gp, x0, U, None, eps)
    X = torch.cat([o[0] for o in outs], dim=1)
    np.testing.assert_allclose(X.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_sharded_rollout_shapes_and_determinism():
    spec, env, hyp, gp, x0, U, T = _rollout_setup()
    g = BlockGroup(4)
    roll = sharded.make_sharded_rollout(spec, env, hyp, g)
    runs = [g.run(roll, gp, x0, U, 5) for _ in range(2)]
    other = g.run(roll, gp, x0, U, 6)
    X1, X2, X3 = (torch.cat([o[0] for o in r], dim=1)
                  for r in runs + [other])
    assert X1.shape == (T + 1, spec.ns, spec.nx)
    assert bool(torch.isfinite(X1).all())
    assert torch.equal(X1, X2)                   # deterministic per seed
    assert not torch.equal(X1, X3)
    assert float(X1[-1].amax(0).sub(X1[-1].amin(0)).max()) > 1e-6
    # each rank draws its own stream: blocks are not copies of each other
    assert not torch.equal(X1[:, :4], X1[:, 4:8])
    assert all(o[1].hall_n == T for o in runs[0])


# ------------------------------------------------------ the global offset

def test_true_dyn_override_lands_on_global_sample_zero():
    spec, env, hyp, ocp, gp, X, U, st, eps = _setup(ns=8)
    spec = dataclasses.replace(spec, true_dyn_as_sample=True)
    xu = sqp._linearization_inputs(spec, ocp, X, U)
    Xt = xu[..., list(spec.g_idx_inputs)]
    Xt = Xt + 0.1 * torch.arange(8, dtype=F64)[:, None, None]
    ref, _ = agent.sample_dynamics(spec, env, hyp, gp, Xt, eps[0],
                                   hall_empty=True)
    g = BlockGroup(4)
    lspec = sharded.local_spec(spec, g)

    def body():
        r = g.rank()
        dg, _ = agent.sample_dynamics(
            lspec, env, hyp, sharded.shard_gp(gp, g), Xt[2 * r:2 * r + 2],
            eps[0][2 * r:2 * r + 2], hall_empty=True, group=g)
        return dg

    dg = torch.cat(g.run(body), dim=0)
    true0 = env.g_prior(Xt[0]).transpose(0, 1)[..., :spec.Ty]
    assert torch.equal(dg[0], true0)
    for i in (2, 4, 6):                          # local sample 0 of blocks 1-3
        true_i = env.g_prior(Xt[i]).transpose(0, 1)[..., :spec.Ty]
        assert not torch.allclose(dg[i], true_i)
    np.testing.assert_allclose(dg.numpy(), ref.numpy(), rtol=0, atol=1e-12)
