"""The port's cross-check QP solvers against the JAX package's, float64 on
the CPU.

* ``ocp/qp.py::solve_qp`` (the generic IPM, slacks as variables) to 1e-8
  against JAX's ``solve_qp`` on tests/test_qp.py's seeded instances, and
  under a 4-block group (rows sharded) to 1e-10 against the one-device
  solve;
* ``ocp/assemble.py::assemble_canonical`` equals JAX's exactly on the
  rows of tests/goldens/qp_car_h100.npz (its 400 hard rows, its first 120
  soft rows), and ``solve_qp(*assemble_canonical(...))`` agrees with
  ``solve_qp_soft`` to 1e-5 * scale (tests/test_qp.py's bar for the car
  QP) on params_car's QP at ns = 1, of the car golden's draws (the
  canonical form of all of qp_car_h100.npz is a dense 20440 x 10220
  matrix, which phase xqp of chip_smoke.py solves on the card);
* ``sampling_gpmpc_torch.native`` returns the JAX package's binding's
  answer bit for bit (the same C++ source), built into build/.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu import native as jnative
from sampling_gpmpc_tpu.ocp import assemble as jassemble
from sampling_gpmpc_tpu.ocp import qp as jqp
from sampling_gpmpc_torch import native
from sampling_gpmpc_torch.ocp import assemble, qp
from sampling_gpmpc_torch.parallel.collectives import BlockGroup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAR_QP = os.path.join(ROOT, "tests", "goldens", "qp_car_h100.npz")
CAR_GOLDEN = os.path.join(ROOT, "tests", "goldens", "torch_oracle_car.npz")
CAR_STEP, CAR_TOL = 5, 1e-13
F64 = torch.float64
SOFT_ROWS = 120


def _instance(name):
    """tests/test_qp.py's seeded generic QPs: (P, q, C, d)."""
    if name == "unconstrained":
        rng = np.random.default_rng(1)
        n = 8
        Ph = rng.normal(size=(n, n))
        return (Ph @ Ph.T + np.eye(n), rng.normal(size=n), np.zeros((1, n)),
                np.array([1e8]))
    if name.startswith("oracle"):
        rng = np.random.default_rng(int(name[-1]))
        n, m = 10, 25
        Ph = rng.normal(size=(n, n))
        return (Ph @ Ph.T + 0.5 * np.eye(n), rng.normal(size=n) * 2,
                rng.normal(size=(m, n)), rng.uniform(0.05, 1.0, size=m))
    if name == "big_bounds":
        rng = np.random.default_rng(5)
        n = 6
        C = np.concatenate([np.eye(n), -np.eye(n)])
        return np.eye(n), rng.normal(size=n), C, np.full(2 * n, 1e8)
    C = np.concatenate([np.eye(2), -np.eye(2)])
    return np.eye(2), np.array([-10.0, 0.3]), C, np.ones(4)


NAMES = ["unconstrained", "oracle0", "oracle1", "oracle2", "oracle3",
         "big_bounds", "active_box"]


@pytest.mark.parametrize("name", NAMES)
def test_solve_qp_matches_jax(name):
    P, q, C, d = _instance(name)
    got = qp.solve_qp(*(torch.as_tensor(a, dtype=F64) for a in (P, q, C, d)))
    ref = jqp.solve_qp(*map(jnp.asarray, (P, q, C, d)))
    assert int(got.status) == int(ref.status) == 0
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), atol=1e-8,
                               rtol=0)
    assert abs(int(got.iters) - int(ref.iters)) <= 1


def test_solve_qp_under_a_group_matches_one_device():
    rng = np.random.default_rng(11)
    n, m = 10, 24
    Ph = rng.normal(size=(n, n))
    P, q = Ph @ Ph.T + 0.5 * np.eye(n), rng.normal(size=n) * 2
    C, d = rng.normal(size=(m, n)), rng.uniform(0.05, 1.0, size=m)
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    one = qp.solve_qp(t(P), t(q), t(C), t(d))
    group = BlockGroup(4, timeout=60.0)
    blocks = group.run(lambda: qp.solve_qp(
        t(P), t(q), t(C).chunk(4)[group.rank()],
        t(d).chunk(4)[group.rank()], group=group, ordered=True))
    for b in blocks:
        assert int(b.status) == 0 and int(b.iters) == int(one.iters)
        np.testing.assert_allclose(b.z.numpy(), one.z.numpy(), atol=1e-10,
                                   rtol=0)


def _car_rows():
    d = np.load(CAR_QP)
    nh = d["Gh"].shape[0] // 2
    k = slice(0, SOFT_ROWS)
    return (d["H"], d["g"], (d["Gh"][:nh], -d["dh"][nh:], d["dh"][:nh]),
            (d["Gs"][k], d["lo"][k], d["hi"][k]),
            tuple(d[n][k] for n in ("zl", "zu", "Zl", "Zu")))


def test_assemble_canonical_equals_jax():
    H, g, hard, soft, pen = _car_rows()
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    got = assemble.assemble_canonical(
        t(H), t(g), assemble.Rows(*map(t, hard)),
        assemble.Rows(*map(t, soft)), tuple(map(t, pen)))
    ref = jassemble.assemble_canonical(
        jnp.asarray(H), jnp.asarray(g),
        jassemble.Rows(*map(jnp.asarray, hard)),
        jassemble.Rows(*map(jnp.asarray, soft)), tuple(map(jnp.asarray, pen)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _car_qp_ns1():
    """params_car's QP at ns = 1: golden step CAR_STEP of
    tests/goldens/torch_oracle_car.npz, its teacher-forced iterate shifted
    and its draws of sample 0 (SQP iteration 0)."""
    import dataclasses

    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import shift_solution
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    g = np.load(CAR_GOLDEN)
    params, spec, data = load_problem(os.path.join(ROOT, "params",
                                                   "params_car.yaml"))
    spec = dataclasses.replace(spec, ns=1)
    params["agent"]["num_dyn_samples"] = 1
    env = make_env(spec, params)
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    hyp = GPHyperArrays.from_spec(spec.gp, "cpu", F64)
    gp = agent.init_gp_state(spec, env, "cpu", F64, hyp=hyp)
    X, U = shift_solution(t(g["tf_X_traj"][CAR_STEP - 1][:, :1]),
                          t(g["tf_U_traj"][CAR_STEP - 1]))
    qp_args, _, _, _ = sqp.assemble_qp(
        spec, env, hyp, make_ocp_data(spec, data, "cpu", F64),
        t(g["physical_state_traj"][CAR_STEP]), X, U, gp,
        t(g["eps"][CAR_STEP, 0, :1]), hall_empty=True)
    return qp_args


def test_canonical_solve_matches_soft_solver_on_car_qp():
    """Both exits at 1e-13: the 1e6 slack penalties leave the solutions
    loose along flat directions at the default 1e-8 relative KKT exit
    (the two solvers stop 0.08 apart there, both status 0)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        H, g, C_h, d_h, G_s, lo, hi, zl, zu, Zl, Zu = _car_qp_ns1()
        nh = C_h.shape[0] // 2
        assert torch.equal(C_h[:nh], -C_h[nh:])          # two-sided box rows
        canon = assemble.assemble_canonical(
            H, g, assemble.Rows(C_h[:nh], -d_h[nh:], d_h[:nh]),
            assemble.Rows(G_s, lo, hi), (zl, zu, Zl, Zu))
        gen = qp.solve_qp(*canon, tol=CAR_TOL, max_iter=100)
        ref = qp.solve_qp_soft(H, g, C_h, d_h, G_s, lo, hi, zl, zu, Zl, Zu,
                               tol=CAR_TOL)
    finally:
        torch.set_num_threads(old)
    assert G_s.shape[0] > 0
    assert int(gen.status) == int(ref.status) == 0, (float(gen.gap),
                                                    int(gen.iters))
    nU = g.shape[0]
    scale = max(1.0, float(ref.z.abs().max()))
    np.testing.assert_allclose(gen.z[:nU].numpy(), ref.z.numpy(),
                               atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_binding_equals_jax_binding(seed):
    rng = np.random.default_rng(seed + 100)
    nU, mh, ms = 8, 14, 6
    Hh = rng.normal(size=(nU, nU))
    args = (Hh @ Hh.T + np.eye(nU), rng.normal(size=nU) * 3,
            rng.normal(size=(mh, nU)), rng.uniform(0.1, 1.5, size=mh),
            rng.normal(size=(ms, nU)), rng.uniform(-0.5, -0.1, size=ms),
            rng.uniform(0.05, 0.3, size=ms), np.full(ms, 3.0),
            np.full(ms, 2.0), np.full(ms, 5.0), np.full(ms, 4.0))
    u, gap, iters, status = native.solve_qp_soft_native(*args)
    ju, jgap, jiters, jstatus = jnative.solve_qp_soft_native(*args)
    assert status == jstatus == 0 and iters == jiters and gap == jgap
    np.testing.assert_array_equal(u, ju)
    assert native.LIBRARY.startswith(os.path.join(ROOT, "build"))
    # tensors are taken too
    tu = native.solve_qp_soft_native(*(torch.as_tensor(a) for a in args))[0]
    np.testing.assert_array_equal(tu, u)
