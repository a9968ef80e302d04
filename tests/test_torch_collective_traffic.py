"""Run-time collective traffic of the sample-sharded solve
(``sampling_gpmpc_torch.collective_traffic``, the counter of
``parallel/collectives.py``), float64 on the CPU, params_pendulum1D_samples
at ns = 16 over 3 forced SQP iterations:

* the blocked route (4 blocks of one process) and the multi-process route
  (4 gloo processes) count the same rounds and bytes, by reducer kind and
  scope, on every rank;
* the Mehrotra loop makes the reference's rounds: five sums, three mins
  and one max an iteration;
* against the JAX package's compiled sharded solve on a 4-device CPU mesh
  (``profiling/collective_traffic.py::collect``): the bytes of each
  reducer kind a Mehrotra iteration (loop depth 2) and a later SQP
  iteration's body (depth 1 less depth 2) are the port's, and the rounds
  are the port's where XLA's all-reduce combiner does not merge two
  independent ones;
* outside ``counting`` the reducers record nothing and the solve's result
  is the counted solve's, bit for bit.
"""

import functools

import torch

from sampling_gpmpc_torch import collective_traffic as ct
from sampling_gpmpc_torch.parallel import collectives
from sampling_gpmpc_torch.parallel.sharded import make_blocked_solve
from sampling_gpmpc_torch.parallel.worker import problem

NS, SQP = 16, ct.SQP_ITERS
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _blocked():
    """The blocked route's (summary, every block's table equal)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ct.blocked_traffic(NS, 4, CPU, torch.float64)
    finally:
        torch.set_num_threads(old)


def test_blocked_and_process_routes_count_alike():
    blocked, same_b = _blocked()
    procs, same_p = ct.process_traffic(NS, 4, "cpu", torch.float64,
                                       timeout=240)
    assert same_b and same_p
    assert blocked == procs
    assert blocked["sqp_iters"] == SQP and blocked["mehrotra_iters"] > SQP
    table = blocked["table"]
    assert set(s.split(" ", 1)[1] for s in table) == {"sqp", "qp prepare",
                                                      "mehrotra"}
    it = blocked["mehrotra_iters"]
    assert table["sum mehrotra"][0] == 5 * it
    assert table["min mehrotra"][0] == 3 * it
    assert table["max mehrotra"][0] == it
    # the Schur tuple-psum carries at least the (nU, nU) matrix a round
    nU = 17
    assert blocked["bytes_per_mehrotra_iter"] >= 8 * nU * nU


def test_no_counter_no_records_same_result():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spec, env, hyp, ocp, gp, X, U, st, eps = problem(
            "params_pendulum1D_samples", NS, SQP, CPU, torch.float64)
        plain = make_blocked_solve(spec, env, hyp, ocp, 4)(st, X, U, gp, eps)
        counter = collectives.TrafficCounter()
        with collectives.counting(counter):
            counted = make_blocked_solve(spec, env, hyp, ocp, 4)(st, X, U, gp,
                                                                 eps)
        seen = dict(counter.records)
        # the same counter, the context left: the solve adds nothing
        make_blocked_solve(spec, env, hyp, ocp, 4)(st, X, U, gp, eps)
    finally:
        torch.set_num_threads(old)
    assert seen and counter.records == seen
    assert not collectives._COUNTING
    for a, b in ((plain.U, counted.U), (plain.X, counted.X)):
        assert torch.equal(a, b)
    # one round of the flat 5-float32 payload, under the reducers' scope
    group = collectives.BlockGroup(1)
    again = collectives.TrafficCounter()
    with collectives.counting(again):
        psum, _, _ = collectives.make_reducers(group, True, scope="mehrotra")
    f32 = torch.float32
    out = group.run(lambda: psum((torch.ones(3, dtype=f32),
                                  torch.zeros(2, dtype=f32))))[0]
    assert [o.tolist() for o in out] == [[1.0] * 3, [0.0] * 2]
    assert again.table(0) == {("sum", "mehrotra"): (1, 5 * 4)}


def _jax_collectives(ns: int, n: int) -> list:
    """[(reducer kind, bytes, loop depth)] of the JAX package's sharded
    solve at the traffic shape, compiled on ``n`` CPU devices (the steps of
    ``profiling/collective_traffic.py``'s main; its ``collect`` reads the
    bytes and depths, the op name's last part the reducer)."""
    import dataclasses
    import os

    import jax
    import jax.numpy as jnp

    from profiling.collective_traffic import COLLECTIVE_RE, OP_NAME_RE, collect
    from sampling_gpmpc_tpu import agent as agent_mod
    from sampling_gpmpc_tpu.config import load_problem
    from sampling_gpmpc_tpu.envs import make_env
    from sampling_gpmpc_tpu.gp.exact import GPHyperArrays
    from sampling_gpmpc_tpu.ocp import sqp
    from sampling_gpmpc_tpu.ocp.spec import make_ocp_data
    from sampling_gpmpc_tpu.parallel.mesh import sample_mesh
    from sampling_gpmpc_tpu.parallel.sharded import make_sharded_solve
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, spec, data = load_problem(
        os.path.join(root, "params", ct.CONFIG + ".yaml"))
    spec = dataclasses.replace(spec, ns=ns, num_mpc_iter=1,
                               max_sqp_iter=SQP, tol_nlp=0.0)
    params["agent"]["num_dyn_samples"] = ns
    env = make_env(spec, params)
    f64 = jnp.float64
    ocp = make_ocp_data(spec, data, f64)
    hyp = GPHyperArrays.from_spec(spec.gp, f64)
    gp = agent_mod.init_gp_state(spec, env, f64)
    X, U = sqp.init_iterate(spec, f64, data.start)
    eps = agent_mod.make_epistemic(jax.random.PRNGKey(0), spec, f64)[0]
    st = jnp.asarray(data.start, f64)
    solve = make_sharded_solve(spec, env, hyp, ocp, sample_mesh(n))
    hlo = jax.jit(solve).lower(st, X, U, gp, eps).compile().as_text()
    names = [OP_NAME_RE.search(line).group(1).rsplit("/", 1)[-1]
             for line in hlo.splitlines() if COLLECTIVE_RE.search(line)]
    cols = collect(hlo)
    # unordered sums: every reducer call is an all-reduce
    assert {op for op, _, _ in cols} == {"all-reduce"}
    return [({"psum": "sum", "pmin": "min", "pmax": "max"}[nm], b, d)
            for nm, (_, b, d) in zip(names, cols)]


def test_rounds_and_bytes_match_the_jax_hlo():
    """The port's counted rounds and bytes, by reducer kind, against the
    collectives XLA compiled for the JAX package's sharded solve: a
    Mehrotra iteration is its loop depth 2; a later SQP iteration's body
    (with the QP's pre-loop) is depth 1 less depth 2, since depth 1 also
    holds the peeled first iteration's Mehrotra body."""
    port = _blocked()[0]
    cols = _jax_collectives(NS, 4)

    def level(d):
        return {k: [sum(1 for kk, _, dd in cols if (kk, dd) == (k, d)),
                    sum(b for kk, b, dd in cols if (kk, dd) == (k, d))]
                for k in ("sum", "min", "max")}
    meh, d1 = level(2), level(1)
    body = {k: [d1[k][0] - meh[k][0], d1[k][1] - meh[k][1]] for k in d1}
    table, it = port["table"], port["mehrotra_iters"]

    def port_level(scopes, k):
        rows = [v for key, v in table.items()
                if key.split(" ", 1)[0] == k
                and key.split(" ", 1)[1] in scopes]
        return sum(n for n, _ in rows), sum(b for _, b in rows)
    p_meh, p_body = {}, {}
    for k in ("sum", "min", "max"):
        n, b = port_level(("mehrotra",), k)
        p_meh[k] = [n / it, b / it]
        n, b = port_level(("sqp", "qp prepare"), k)
        p_body[k] = [n / SQP, b / SQP]
    for k in ("sum", "min", "max"):
        assert p_meh[k][1] == meh[k][1], (k, p_meh, meh)
        assert p_body[k][1] == body[k][1], (k, p_body, body)
    # the rounds, less those XLA's all-reduce combiner merges: in the
    # Mehrotra body the Schur psum and the affine direction's (independent
    # of it); in the SQP body two sums and two of the prepare's maxes
    merged_meh = {"sum": 1, "min": 0, "max": 0}
    merged_body = {"sum": 2, "min": 0, "max": 2}
    for k in ("sum", "min", "max"):
        assert p_meh[k][0] - merged_meh[k] == meh[k][0], (k, p_meh, meh)
        assert p_body[k][0] - merged_body[k] == body[k][0], (k, p_body,
                                                              body)
