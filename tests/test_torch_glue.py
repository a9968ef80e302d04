"""``ops/glue.py``: the condensing and assembly kernel's wrapper, its
refusals, its layout and the Gram kernel's tiles, and the body that
``ocp/assemble.py::condensed_qp`` runs in and out of
``plain_route(glue=True)``.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``
holds it against its plain twin ``ocp/assemble.py::assemble_iteration``,
which ``tests/test_torch_assemble.py`` holds to the SQP solve's CPU route).
"""

import dataclasses
import os

import pytest
import torch

from sampling_gpmpc_torch.config import load_problem
from sampling_gpmpc_torch.ocp import assemble
from sampling_gpmpc_torch.ocp.assemble import assemble_iteration, row_counts
from sampling_gpmpc_torch.ops import glue, routes
from sampling_gpmpc_torch.parallel.worker import glue_inputs

PARAMS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "params")
CPU = torch.device("cpu")


def layout(spec, gram=None):
    """The kernel's layout for the spec's own row counts."""
    return glue.layout(spec, row_counts(spec), gram)


@pytest.mark.parametrize("config,ns,over", [
    ("params_pendulum1D_samples", 4, {}),
    ("params_pendulum1D_samples", 4, {"use_feedback": False}),
    ("params_car", 2, {}),
    ("params_pendulum_samples", 3, {}),
])
def test_layout_views_have_the_plain_shapes(config, ns, over):
    """The kernel's buffer holds every output at the plain version's shape,
    each at an ALIGN-aligned offset and apart from the others, the
    workspace last; the cost sums sit in shared memory at these widths
    (one launch), and the wide branch, where asked for, keeps M in the
    workspace instead."""
    args = glue_inputs(config, ns, CPU, torch.float32, **over)[0]
    spec = args[0]
    qp, T, Gamma = assemble_iteration(*args)
    smem, gram, shapes, offsets, total, gram_grid = layout(spec)
    nU = spec.H * spec.nu
    assert not gram and gram_grid == 0 and 0 < smem <= glue.SMEM_LIMIT
    assert list(shapes[:13]) == [tuple(t.shape) for t in (*qp, T, Gamma)]
    assert shapes[13] == (ns * (nU * nU + nU),)
    wide = layout(spec, gram=True)
    assert wide[0] < smem and wide[2][:13] == shapes[:13]
    assert wide[2][13] == (ns * (spec.H + 1) * spec.nx * (nU + 1),)
    assert all(o % glue.ALIGN == 0 for o in offsets)
    ends = [o + glue._numel(s) for o, s in zip(offsets, shapes)]
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total


def test_layout_of_the_widest_qp_keeps_the_cost_sums_global():
    """Past GRAM_NU the cost forms in the second launch from M in the
    global workspace: at params_car_samples' nU = 200 and at nU = 256,
    where the narrow branch's sums do not fit in shared memory and cannot
    be asked for; params_car_residual's nU = 100 too.  A horizon whose
    stage rows alone pass the limit is refused."""
    params, spec, data = load_problem(os.path.join(PARAMS,
                                                   "params_car_samples.yaml"))
    wide = dataclasses.replace(spec, H=128)
    smem, gram = layout(wide)[:2]
    assert gram and smem <= glue.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        layout(wide, gram=False)
    assert layout(spec)[1]
    assert layout(dataclasses.replace(spec, ns=1, H=50))[1]
    assert not layout(dataclasses.replace(spec, H=glue.GRAM_NU //
                                                   spec.nu))[1]
    with pytest.raises(ValueError, match="shared memory"):
        layout(dataclasses.replace(spec, H=3000))


@pytest.mark.parametrize("nU", [1, 17, 31, 32, 33, 63, 64, 65, 100, 200,
                                 255, 256])
def test_gram_grid_covers_the_upper_triangle_once(nU):
    """glue_gram_kernel's tiles, decoded from the block index as the kernel
    does, write every entry of H_U's upper triangle and of g_U (column nU)
    exactly once over layout's gram_grid blocks."""
    spec = dataclasses.replace(load_problem(os.path.join(
        PARAMS, "params_pendulum1D_samples.yaml"))[1], H=nU, ns=2)
    grid = layout(spec, gram=True)[5]
    ts, ntv = glue.TS, (nU + glue.TS) // glue.TS
    seen = []
    for blk in range(grid):
        bu, rem = 0, blk
        while rem >= ntv - bu:
            rem -= ntv - bu
            bu += 1
        bv = bu + rem
        for t in range(256):
            v = bv * ts + (t & 31)
            for j in range(4):
                u = bu * ts + (t >> 5) * 4 + j
                if u < nU and v <= nU and (v == nU or u <= v):
                    seen.append((u, v))
    want = [(u, v) for u in range(nU) for v in range(u, nU + 1)]
    assert sorted(seen) == want


@pytest.mark.parametrize("what", ["float64", "shape", "strided", "ocp"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    """check_inputs (run before every launch) names the input the kernel
    cannot take: float64, a wrong shape, a non-contiguous tensor, an OCP
    field of another dtype; the launch raises on a device that is not
    CUDA.  Nothing falls back to the plain chain."""
    spec, ocp, combined, X, U, st = glue_inputs(
        "params_pendulum1D_samples", 4, CPU, torch.float32)[0]
    dev = CPU
    args = dict(combined=combined, X=X, U=U, st_curr=st)
    if what == "float64":
        args["combined"], match = combined.double(), "combined: need float32"
    elif what == "shape":
        args["X"], match = X[:-1], r"X: shape \(17, 4, 2\)"
    elif what == "strided":
        args["X"] = X.transpose(0, 1).contiguous().transpose(0, 1)
        match = "X: not contiguous"
    else:
        ocp, match = ocp._replace(lm=ocp.lm.double()), "ocp.lm: need float32"
    with pytest.raises(ValueError, match=match):
        glue.check_inputs(spec, ocp, dev=dev, **args)
    assert len(glue.check_inputs(spec, ocp._replace(lm=ocp.lm.float()),
                                 combined, X, U, st, dev)) == 4 + 17 + 8
    meta = combined.to("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        glue.launch(spec, row_counts(spec), ocp, meta, X, U, st)


@pytest.mark.parametrize("glue_plain", [True, False])
def test_plain_route_swaps_the_glue_and_puts_it_back(glue_plain,
                                                     monkeypatch):
    """Off the CPU, condensed_qp launches the kernel; inside
    plain_route(glue=True) it runs the chain instead, and glue=False
    leaves the launch; on exit the launch is back, also when the block
    raises.  The body that runs is seen through spies on the launch and
    the chain (on meta tensors, which neither could take)."""
    args = list(glue_inputs("params_pendulum1D_samples", 2, CPU,
                            torch.float32)[0])
    args[2] = args[2].to("meta")
    ran = []
    monkeypatch.setattr(glue, "launch",
                        lambda *a, **k: ran.append("launch") or (a, 0, 0))
    monkeypatch.setattr(assemble, "assemble_iteration",
                        lambda *a: ran.append("chain") or (a, 0, 0))
    with pytest.raises(RuntimeError):
        with routes.plain_route(gp=False, qp=False, glue=glue_plain):
            assemble.condensed_qp(*args)
            raise RuntimeError
    assemble.condensed_qp(*args)
    assert ran == ["chain" if glue_plain else "launch", "launch"]
    assert routes.launch_counts()["glue_condense"] == \
        glue.LAUNCHES["glue_condense"]
    routes.zero_launch_counts()
    assert glue.LAUNCHES["glue_condense"] == 0


# the step's consumption (glue.advance) at every shape the port solves on
# the card, as published: (config, ns)
ADVANCE_SHAPES = [("params_pendulum1D_samples", 70), ("params_pendulum", 20),
                  ("params_car", 20), ("params_car_residual", 1),
                  ("params_car_samples", 10), ("params_pendulum_samples", 500)]


def _spec(config, ns):
    spec = load_problem(os.path.join(PARAMS, config + ".yaml"))[1]
    return dataclasses.replace(spec, ns=ns)


def _solve_state(spec, dev, dtype=torch.float32, seed=0):
    """A state entering an SQP iteration on ``dev`` and its iteration's
    T, Gamma and QP solution, all seeded: (SolveState, T, Gamma, sol)."""
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.qp import QPSolution
    ns, H, nx, nu = spec.ns, spec.H, spec.nx, spec.nu
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=dtype).to(dev)  # noqa
    X, i32 = r(H + 1, ns, nx), torch.int32
    zero = torch.zeros((), dtype=i32, device=dev)
    s = sqp.SolveState(
        X=X, U=r(H, nu), X_prev=X, U_prev=r(H, nu), gp="gp", it=0,
        status=zero, done=torch.zeros((), dtype=torch.bool, device=dev),
        qp_ws=(r(H * nu),), qp_valid=torch.zeros((), dtype=torch.bool,
                                                 device=dev),
        qp_iters=torch.tensor(12, dtype=i32, device=dev), qp_gap=r(),
        best_step=torch.tensor(float("inf"), dtype=dtype, device=dev),
        stall_count=zero, mono_count=zero,
        alpha=torch.ones((), dtype=dtype, device=dev))
    sol = QPSolution(z=r(H * nu), lam=None, s=None,
                     iters=torch.tensor(5, dtype=torch.int32, device=dev),
                     status=torch.tensor(0, device=dev), gap=r(),
                     state=(r(H * nu),))
    return s, r(ns, H + 1, nx), r(ns, H + 1, nx, H * nu), sol


@pytest.mark.parametrize("where", ["cpu", "plain_route", "group", "card"])
def test_advance_takes_consume_step_off_the_kernel_route(where,
                                                         monkeypatch):
    """``sqp._advance`` launches ``glue.advance`` only on the kernel route
    with no group: on the CPU, inside plain_route(glue=True) and under a
    sample-axis group it runs ``consume_step`` on the candidate and counts
    no ``glue_advance`` launch.  On the CPU the state is consume_step's,
    bit for bit; elsewhere (meta tensors, which neither body could take)
    spies show the body that ran."""
    from sampling_gpmpc_torch.ocp import sqp
    spec = _spec("params_car", 3)
    dev = CPU if where == "cpu" else torch.device("meta")
    s, T, Gamma, sol = _solve_state(spec, dev)
    before = glue.LAUNCHES["glue_advance"]
    if where == "cpu":
        got = sqp._advance(spec, s, T, Gamma, "gp", sol)
        X_c, U_c = sqp.candidate(spec, s.X, s.U, T, Gamma, sol.z)
        ref = sqp.consume_step(spec, s.X, s.U, X_c, U_c, sol.status == 0,
                               s.best_step, s.stall_count, s.mono_count,
                               s.alpha)
        st = got[0]
        for k, v in zip(("X", "U", "x_diff", "u_diff", "done", "best_step",
                         "stall_count", "mono_count", "alpha"), ref):
            a = got[1] if k == "x_diff" else got[2] if k == "u_diff" \
                else getattr(st, k)
            assert torch.equal(a, v), k
        assert torch.equal(st.qp_iters, s.qp_iters + sol.iters)
        assert bool(st.qp_valid) and st.X_prev is s.X and st.it == 1
        assert glue.LAUNCHES["glue_advance"] == before
        return
    ran = []
    monkeypatch.setattr(sqp, "consume_step",
                        lambda *a, **k: ran.append("chain") or (0,) * 9)
    monkeypatch.setattr(glue, "advance",
                        lambda *a, **k: ran.append("kernel") or (0,) * 11)
    if where == "plain_route":
        with routes.plain_route(gp=False, qp=False, glue=True):
            sqp._advance(spec, s, T, Gamma, "gp", sol)
    else:
        sqp._advance(spec, s, T, Gamma, "gp", sol,
                     group=object() if where == "group" else None)
    assert ran == ["kernel" if where == "card" else "chain"]
    assert glue.LAUNCHES["glue_advance"] == before


def test_advance_refuses_cpu_tensors():
    """The wrapper raises for tensors off CUDA, before any check or
    build, and counts nothing; nothing falls back to the torch chain."""
    from sampling_gpmpc_torch.ocp import sqp
    spec = _spec("params_pendulum1D_samples", 4)
    s, T, Gamma, sol = _solve_state(spec, CPU)
    before = glue.LAUNCHES["glue_advance"]
    with pytest.raises(ValueError, match="unsupported device cpu"):
        glue.advance(spec, s.X, s.U, T, Gamma, sol.z, sol.status, sol.iters,
                     s.best_step, s.stall_count, s.mono_count, s.alpha,
                     s.qp_iters, sqp.STALL)
    assert glue.LAUNCHES["glue_advance"] == before


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("config,ns", ADVANCE_SHAPES)
def test_advance_layout_gives_each_output_its_place(config, ns, wide):
    """The advance kernel's buffer holds every output at the shape and
    dtype of the torch chain's (consume_step, ok, qp_iters + iters; int64
    qp_iters where ``wide``), each starting 256-byte aligned, apart from
    the others and inside the buffer; advance_views cuts them there."""
    from sampling_gpmpc_torch.ocp import sqp
    spec = _spec(config, ns)
    s, T, Gamma, sol = _solve_state(spec, CPU)
    if wide:
        sol = sol._replace(iters=sol.iters.long())
    X_c, U_c = sqp.candidate(spec, s.X, s.U, T, Gamma, sol.z)
    ok = sol.status == 0
    ref = sqp.consume_step(spec, s.X, s.U, X_c, U_c, ok, s.best_step,
                           s.stall_count, s.mono_count, s.alpha) + (
        ok, s.qp_iters + sol.iters)
    lay = glue.advance_layout(spec, wide)
    shapes, dtypes, offsets, total = lay[:4]
    assert len(shapes) == len(glue.ADVANCE_OUTPUTS) == len(ref)
    assert [tuple(t.shape) for t in ref] == list(shapes)
    assert [t.dtype for t in ref] == list(dtypes)
    buf = torch.zeros((total,), dtype=torch.float32)
    views = glue.advance_views(buf, lay)
    base = buf.data_ptr()
    spans = []
    for v, shape, dt, o in zip(views, shapes, dtypes, offsets):
        assert tuple(v.shape) == shape and v.dtype == dt
        assert v.is_contiguous() and v.data_ptr() == base + 4 * o
        assert (v.data_ptr() - base) % 256 == 0
        spans.append((4 * o, 4 * o + v.numel() * v.element_size()))
    assert all(e <= b for (_, e), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= 4 * total
    for n, v in enumerate(views):      # each view writes only its place
        v.fill_(n + 1)
    for n, v in enumerate(views):
        assert bool((v == (n + 1)).all()) if v.dtype != torch.bool \
            else bool(v)
