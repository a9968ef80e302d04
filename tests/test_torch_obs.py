"""The port's spans and counters (``sampling_gpmpc_torch/obs.py``) and the
benchmark's readers of them, on the CPU."""

import dataclasses
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import cell
from sampling_gpmpc_torch import bench, obs
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ops import build, ipm

GLUE, GP, QP, LOOP = obs.GLUE, obs.GP, obs.QP, obs.LOOP


@pytest.fixture
def clock(monkeypatch):
    """obs's clock, one microsecond a reading."""
    t = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(obs, "time", types.SimpleNamespace(
        time_ns=lambda: next(t)))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _off():
    """A span with spans off: ends the stretch."""
    with obs.span("glue.off"):
        pass


def test_spans_nest_with_parents_and_step_ids(clock):
    _off()
    with obs.recording():
        with obs.span("loop.plant"):
            pass
        for _ in range(2):
            with obs.span("sqp.solve"):
                with obs.span("sqp.iteration"):
                    with obs.span("gp.sample"):
                        pass
                    with obs.span("qp.solve"):
                        pass
            with obs.span("loop.shift"):
                pass
    got = [(s.name, s.parent, s.step) for s in obs.spans()]
    assert got == [("loop.plant", -1, 0),
                   ("sqp.solve", -1, 1), ("sqp.iteration", 1, 1),
                   ("gp.sample", 2, 1), ("qp.solve", 2, 1),
                   ("loop.shift", -1, 1),
                   ("sqp.solve", -1, 2), ("sqp.iteration", 6, 2),
                   ("gp.sample", 7, 2), ("qp.solve", 7, 2),
                   ("loop.shift", -1, 2)]
    assert all(s.t1_ns > s.t0_ns for s in obs.spans())


def test_each_profiled_block_is_a_stretch_of_its_own():
    _off()
    for n in (2, 1):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                with obs.span("sqp.solve"):
                    with obs.span("glue.condense"):
                        pass
        assert [(s.name, s.step) for s in obs.spans()] == [
            (name, k + 1) for k in range(n)
            for name in ("sqp.solve", "glue.condense")]
        _off()
    assert obs.spans()[0].name == "sqp.solve"       # kept after the stretch


def test_off_spans_call_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the "
                             "profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _off()
    kept = obs.spans()
    assert obs.span("sqp.solve") is obs.span("gp.sample")
    with obs.span("sqp.solve"):
        with obs.span("gp.sample"):
            pass
    assert obs.spans() == kept
    with obs.recording():               # on in memory, still no profiler
        with obs.span("qp.solve"):
            pass
    assert [s.name for s in obs.spans()] == ["qp.solve"]


def test_span_clock_lines_up_with_the_profiler_export(tmp_path):
    _off()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("glue.warm", "glue.timed"):
            with obs.span(name):
                torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    ev = [e for e in trace["traceEvents"] if e.get("name") == "glue.timed"]
    assert len(ev) == 1 and ev[0]["cat"] == "user_annotation"
    mine = obs.spans()[1]
    base_us = trace["baseTimeNanoseconds"] / 1e3
    assert abs(mine.t0_ns / 1e3 - base_us - ev[0]["ts"]) < 100
    assert abs(mine.t1_ns / 1e3 - base_us - ev[0]["ts"] - ev[0]["dur"]) < 100
    obs.write(str(tmp_path / "spans.json"), trace["baseTimeNanoseconds"])
    out = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert [e["name"] for e in out] == ["glue.warm", "glue.timed"]
    assert abs(out[1]["ts"] - ev[0]["ts"]) < 100


def _span(name, t0, t1, parent, step):
    return obs.Span(name, t0 * 1000, t1 * 1000, parent, step)


# two steps on a microsecond clock: step 1 from 0 to 100 (step 2's start),
# step 2 from 100 to its last span's end, 160
CANNED = [
    _span("sqp.solve", 0, 80, -1, 1),
    _span("sqp.iteration", 5, 75, 0, 1),
    _span("gp.sample", 10, 30, 1, 1),
    _span("gp.kernel", 20, 25, 2, 1),
    _span("qp.solve", 40, 70, 1, 1),
    _span("loop.plant", 85, 90, -1, 1),
    _span("sqp.solve", 100, 150, -1, 2),
    _span("qp.solve", 110, 140, 6, 2),
    _span("loop.shift", 152, 160, -1, 2),
]


def test_host_ms_by_layer_adds_up_to_each_step():
    got = obs.host_ms_by_layer(CANNED)
    want = {1: {GLUE: 0.030, GP: 0.020, QP: 0.030, LOOP: 0.005,
                obs.OUTSIDE: 0.015},
            2: {GLUE: 0.020, QP: 0.030, LOOP: 0.008, obs.OUTSIDE: 0.002}}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    assert sum(got[1].values()) == pytest.approx(0.100)
    assert sum(got[2].values()) == pytest.approx(0.060)


def test_idle_by_span_takes_the_innermost_span_then_the_host_op():
    def ev(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}
    events = [
        ev("sqp.solve", "user_annotation", 0, 100),
        ev("qp.mehrotra", "user_annotation", 40, 30),
        ev("loop.plant", "user_annotation", 120, 20),
        ev("perfbench_step", "user_annotation", -5, 150),   # not the program
        ev("aten::bmm", "cpu_op", 100, 10),
        ev("gp_sample_kernel", "kernel", 0, 10),
        ev("Memcpy HtoD", "gpu_memcpy", 8, 12),     # overlaps: 0-20 busy
        ev("ipm_mehrotra_kernel", "kernel", 50, 10),
        ev("fill", "gpu_memset", 90, 15),
        ev("k3", "kernel", 112, 2),
        ev("k4", "kernel", 116, 2),
        ev("k5", "kernel", 130, 20),                # past the spans' end
    ]
    # gaps in the spans' window (0-140): 20-50 and 60-90 inside sqp.solve,
    # 105-112 inside aten::bmm alone, 114-116 inside nothing, 118-130
    # inside loop.plant
    assert obs.idle_by_span(events) == pytest.approx(
        {"sqp.solve": 60.0, "aten::bmm": 7.0, obs.OUTSIDE: 2.0,
         "loop.plant": 12.0})
    events[1]["dur"] = 40                                   # 40-80 now
    assert obs.idle_by_span(events) == pytest.approx(
        {"sqp.solve": 30.0, "qp.mehrotra": 30.0, "aten::bmm": 7.0,
         obs.OUTSIDE: 2.0, "loop.plant": 12.0})
    assert obs.idle_by_span(events[3:]) == {}


READERS = [("gp_host_ms", (0.020 + 0.0) / 2),
           ("glue_host_ms", (0.030 + 0.020) / 2),
           ("qp_host_ms", (0.030 + 0.030) / 2),
           ("host_syncs_per_step", 3 / 2)]


@pytest.mark.parametrize("name,want", READERS)
def test_readers_on_a_canned_traced_run(monkeypatch, name, want):
    reader = cell.metric_module(name)
    assert reader.MOVES == "step_ms" and reader.LAYER in (GP, GLUE, QP)
    monkeypatch.setattr(obs, "_STATE", obs._State())
    monkeypatch.setattr(obs, "SYNCS", obs.Counter({"a": 5, "b": 1}))
    obs._STATE.spans = [list(s) for s in CANNED]
    obs._STATE.syncs0 = obs.Counter({"a": 3})
    traced = types.SimpleNamespace(summary=types.SimpleNamespace(steps=2))
    assert reader.read(traced) == pytest.approx(want)
    assert reader.read(types.SimpleNamespace(summary=None)) is None
    obs._STATE.spans = []
    assert reader.read(traced) is None


def test_counters_live_in_obs_alone():
    assert not hasattr(build, "count") and not hasattr(build, "thread_tally")
    table = {"k": 0}
    with obs.thread_tally() as tally:
        obs.count(table, "k")
        obs.count(obs.SYNCS, "test.site", tally=False)
    assert table == {"k": 1} and tally == {"k": 1}
    obs.count(table, "k")
    assert table == {"k": 2} and tally == {"k": 1}


def test_thread_tally_counts_ipm_launches_by_kernel():
    """A block's tally (``BlockGroup.launches``) names an IPM launch by its
    kernel, as ``routes.launch_counts`` does, whatever build it ran."""
    table = dict.fromkeys(ipm.LAUNCHES, 0)
    with obs.thread_tally() as tally:
        obs.count(table, ("ipm_prepare", "ipm"))
        obs.count(table, ("ipm_prepare", "ipm_hard_wide"))
        obs.count(table, ("ipm_mehrotra", "ipm_wide"))
    assert tally == {"ipm_prepare": 2, "ipm_mehrotra": 1}
    assert table[("ipm_prepare", "ipm_hard_wide")] == 1
    assert sum(table.values()) == 3


# the CPU's plain GP and QP bodies, which the card's kernels replace, and
# the copies from pageable host memory that torch synchronises on the card
PLAIN = ("ipm.mehrotra_plain:", "exact.safe_cholesky:")


def _solve_syncs(monkeypatch, iters):
    """One closed-loop step of params_pendulum1D_samples at ns = 4 with
    ``iters`` SQP iterations and no convergence exit, float64 on the CPU:
    (what each ``_go_on`` returned and the sqp sites it counted, every
    site the step counted)."""
    _, spec, data, env = bench.build(dict(ns=4, max_sqp_iter=iters))
    spec = dataclasses.replace(spec, tol_nlp=0.0)
    loop = bench.ClosedLoop(spec, data, env, "cpu", torch.float64)
    eps = bench.draws(spec, 1, 3, "cpu", torch.float64)[0]
    go_on, seen = sqp._go_on, []

    def counted(spec, s):
        before = sum(v for k, v in obs.SYNCS.items()
                     if k.startswith("sqp._go_on"))
        out = go_on(spec, s)
        seen.append((out, sum(v for k, v in obs.SYNCS.items()
                               if k.startswith("sqp._go_on")) - before))
        return out
    monkeypatch.setattr(sqp, "_go_on", counted)
    before = obs.Counter(obs.SYNCS)
    st = loop.step(eps)
    delta = obs.Counter(obs.SYNCS)
    delta.subtract(before)
    assert int(st.status) == 0 and st.it == iters
    return seen, +delta


def test_rti_step_reads_nothing_back_but_the_plain_bodies(monkeypatch,
                                                          one_thread):
    seen, delta = _solve_syncs(monkeypatch, 1)
    assert seen == [(False, 0)]
    assert {k: v for k, v in delta.items() if not k.startswith(PLAIN)} == {
        "sqp._initial_state:qp_gap": 1, "sqp._initial_state:best_step": 1,
        "sqp._assemble:g_idx_inputs": 1, "envs.pendulum1d.B_d": 2,
        "envs.Env.assemble_val_jac:pad_g": 1, "envs.Env.g_inputs": 1}
    assert delta["ipm.mehrotra_plain:finite"] > 0


def test_sqp_reads_two_values_after_each_iteration_it_goes_on_from(
        monkeypatch, one_thread):
    seen, delta = _solve_syncs(monkeypatch, 3)
    assert seen == [(True, 2), (True, 2), (False, 0)]
    assert delta["sqp._go_on:done"] == delta["sqp._go_on:status"] == 2
    assert delta["envs.pendulum1d.B_d"] == 4
    assert delta["sqp._assemble:g_idx_inputs"] == 3


def _car_step_spans(monkeypatch):
    """One closed-loop step of params_car at ns = 4, H = 8 with three SQP
    iterations and no convergence exit, float64 on the CPU (the plain GP
    route), inside ``obs.recording()``: (spec, the stretch's spans, the
    HALL_ROWS it counted)."""
    _, spec, data, env = bench.build_car(dict(ns=4, H=8, max_sqp_iter=3))
    spec = dataclasses.replace(spec, tol_nlp=0.0)
    loop = bench.ClosedLoop(spec, data, env, "cpu", torch.float64)
    eps = bench.draws(spec, 1, 5, "cpu", torch.float64)[0]
    _off()
    with obs.recording():
        st = loop.step(eps)
        got = obs.spans(), obs.hall_rows()
    assert int(st.status) == 0 and st.it == 3
    return spec, got[0], got[1]


def test_car_step_spans_its_hall_stages_apart(monkeypatch, one_thread):
    """The empty stage (iteration 0) keeps ``gp.inputs`` / ``gp.kernel``;
    each hall stage (iterations 1 and 2) opens ``gp.hall.inputs`` /
    ``gp.hall.kernel`` inside its ``gp.sample``, and ``HALL_ROWS`` counts
    it at its fill i H Ty."""
    spec, spans, rows = _car_step_spans(monkeypatch)
    samples = [i for i, s in enumerate(spans) if s.name == "gp.sample"]
    assert len(samples) == 3
    inner = [[s.name for s in spans if s.parent == i] for i in samples]
    assert inner[0] == ["gp.inputs", "gp.kernel", "gp.append"]
    assert inner[1] == inner[2] == ["gp.hall.inputs", "gp.hall.kernel",
                                    "gp.append"]
    fill = spec.H * spec.Ty
    assert rows == {fill: 1, 2 * fill: 1}
    assert all(obs.layer(s.name) == GP for s in spans
               if s.name.startswith("gp."))


def test_hall_rows_count_from_each_stretch():
    _off()
    obs.count(obs.HALL_ROWS, 60, tally=False)      # before the stretch
    with obs.recording():
        with obs.span("gp.hall.kernel"):
            obs.count(obs.HALL_ROWS, 60, tally=False)
            obs.count(obs.HALL_ROWS, 120, tally=False)
    assert obs.hall_rows() == {60: 1, 120: 1}
    _off()
    with obs.recording():
        with obs.span("gp.kernel"):
            pass
    assert obs.hall_rows() == {}


def test_host_ms_in_takes_a_prefix_innermost():
    spans = [_span("gp.sample", 0, 50, -1, 1),
             _span("gp.hall.inputs", 5, 20, 0, 1),
             _span("gp.hall.kernel", 20, 45, 0, 1),
             _span("glue.condense", 30, 40, 2, 1),
             _span("gp.hall.kernel", 60, 70, -1, 1),
             _span("gp.hall.kernel", 80, 1, -1, 1)._replace(t1_ns=None)]
    assert obs.host_ms_in(spans, "gp.hall.") == pytest.approx(
        (15 + 15 + 10) / 1e3)
    assert obs.host_ms_in(spans, "gp.") == pytest.approx(
        (10 + 15 + 15 + 10) / 1e3)
    assert obs.host_ms_in(spans, "qp.") is None


@dataclasses.dataclass
class _Ctx:
    summary: object
    sizes: dict


def test_hall_readers_on_a_recorded_car_step(monkeypatch, one_thread):
    """``hall_host_ms`` reads the hall spans' self time of a recorded car
    step; ``hall_roofline`` the hall bound at the fills ``HALL_ROWS``
    counted over a synthetic trace summary's ``hall_*`` / ``gp_hall_*``
    device time; both None where no hall stage ran."""
    from perfbench import bounds, trace
    spec, spans, rows = _car_step_spans(monkeypatch)
    host = cell.metric_module("hall_host_ms")
    roof = cell.metric_module("hall_roofline")
    assert host.LAYER == roof.LAYER == GP
    assert host.MOVES == roof.MOVES == "step_ms"
    summary = trace.Summary(
        steps=1, window_us=1e4, busy_us=600.0,
        ops={"hall_gemm_kernel": (200.0, 6), "gp_hall_factor_kernel":
             (300.0, 3), "gp_sample_kernel": (100.0, 1)},
        n_ops=10, idle_by_host={})
    sizes = dict(ns=spec.ns, g_ny=spec.g_ny, H=spec.H, Ty=spec.Ty, R=180)
    ctx = _Ctx(summary, sizes)
    want_ms = obs.host_ms_in(spans, "gp.hall.")
    assert want_ms > 0 and host.read(ctx) == pytest.approx(want_ms)
    Ht = spec.H * spec.Ty
    b = sum(bounds.bound_s(*(spec.g_ny * v for v in bounds.gp_hall_bound(
        spec.ns, Ht, 180, nh))) for nh in (Ht, 2 * Ht))
    assert roof.read(ctx) == pytest.approx(100.0 * b * 1e6 / 500.0)
    assert 0.0 < roof.read(ctx) < 100.0
    # no hall kernel in the trace, no trace
    assert roof.read(dataclasses.replace(ctx, summary=dataclasses.replace(
        summary, ops={"gp_sample_kernel": (100.0, 1)}))) is None
    assert roof.read(types.SimpleNamespace(summary=None, sizes=sizes)) is None
    # a step with no hall stage (one SQP iteration)
    _off()
    with obs.recording():
        with obs.span("sqp.solve"):
            with obs.span("gp.kernel"):
                pass
    assert host.read(ctx) is None and roof.read(ctx) is None
