"""The trace reduction and every metric reader on a small canned chrome
trace, and a reader whose kernels are absent."""

import pytest
import torch

from conftest import run_cell
from perfbench import bounds, cell, session, trace

SIZES = dict(ns=70, H=17, nx=2, nu=1, g_ny=1, Ty=3, max_sqp_iter=1,
             beta=2.5, dt=0.015, R=108, nU=17, m_h=7174, m_s=70)


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def canned():
    """Two steps of 1000 us: in each, a gp_sample kernel (100 us), a copy
    (50 us), the prepare and Mehrotra kernels (20 + 80 us) and an
    elementwise kernel (50 us) overlapping the copy by 25 us; the host
    launches kernels, reads a value back and runs Python between."""
    out = []
    for k, t0 in enumerate((0.0, 1000.0)):
        out += [
            ev(trace.STEP, "user_annotation", t0, 1000.0),
            ev("void (anonymous namespace)::gp_sample_kernel<true>(float "
               "const*, float*)", "kernel", t0 + 100, 100),
            ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t0 + 300, 50),
            ev("void at::native::elementwise_kernel<128, 2>(int)", "kernel",
               t0 + 325, 50),
            ev("void (anonymous namespace)::ipm_prepare_kernel<true, true>()",
               "kernel", t0 + 500, 20),
            ev("void (anonymous namespace)::ipm_mehrotra_kernel<1, true>()",
               "kernel", t0 + 520, 80),
            ev("aten::bmm", "cpu_op", t0 + 0, 90),
            ev("cudaLaunchKernel", "cuda_runtime", t0 + 10, 70),
            ev("aten::item", "cpu_op", t0 + 600, 300),
            ev("cudaStreamSynchronize", "cuda_runtime", t0 + 610, 280),
        ]
    return out


def test_base_names():
    assert trace.base_name("void (anonymous namespace)::gp_sample_kernel"
                           "<true>(float const*)") == "gp_sample_kernel"
    assert trace.base_name("void at::native::vectorized_elementwise_kernel"
                           "<4, at::native::FillFunctor<float> >(int)") == \
        "vectorized_elementwise_kernel"
    assert trace.base_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert trace.base_name("sm80_xmma_gemm_f32f32_nn") == \
        "sm80_xmma_gemm_f32f32_nn"


def test_reduce_canned_trace():
    s = trace.reduce(canned())
    assert s.steps == 2 and s.window_us == 2000.0
    # per step: 100 + (300..375) 75 + 100 = 275 us busy
    assert s.busy_us == pytest.approx(550.0)
    assert s.n_ops == 10
    assert s.ops["ipm_mehrotra_kernel"] == (160.0, 2)
    assert s.device_us(("ipm_",)) == pytest.approx(200.0)
    assert s.device_us(("gp_", "hall_")) == pytest.approx(200.0)
    assert s.device_us(("nothing_",)) is None
    # gaps: 0-100 (cudaLaunchKernel inside aten::bmm at 50), 200-300 and
    # 375-500 (python), 600-1100 (cudaStreamSynchronize at 850), ...,
    # 1600-2000 (cudaStreamSynchronize at 1800)
    assert s.idle_by_host["cudaLaunchKernel"] == pytest.approx(100.0)
    assert s.idle_by_host["cudaStreamSynchronize"] == pytest.approx(900.0)
    assert s.idle_by_host[trace.NO_HOST_OP] == pytest.approx(450.0)
    assert sum(s.idle_by_host.values()) == pytest.approx(2000.0 - 550.0)
    b = s.breakdown()
    assert b["device_ops"][0] == ["gp_sample_kernel", 200e-6]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize", 900e-6]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def context(summary, traced=((1, 27), (1, 1))):
    return session.Context(summary=summary, sizes=SIZES, traced=list(traced),
                           window=[(1, 27), (1, 1), (1, 1), (1, 1)],
                           step_ms=[10.0, 4.0, 4.0, 2.0], window_s=0.02,
                           setup_s=12.5)


def read(name, ctx):
    return cell.metric_module(name).read(ctx)


def test_every_reader_on_the_canned_trace():
    ctx = context(trace.reduce(canned()))
    assert read("step_ms", ctx) == pytest.approx(5.0)
    assert read("step_ms_p95", ctx) == 10.0
    assert read("setup_s", ctx) == 12.5
    assert read("idle_share", ctx) == pytest.approx(
        100 * (1 - 0.55 / (2 * 5.0)))
    assert read("device_ops_per_step", ctx) == 5.0
    assert read("ipm_iters_per_step", ctx) == 7.5
    assert read("sqp_iters_per_step", ctx) == 1.0
    qp = sum(bounds.qp_step_s(SIZES, it, q) for it, q in ctx.traced)
    assert read("qp_roofline", ctx) == pytest.approx(100 * qp / 200e-6)
    gp = 2 * bounds.gp_step_s(SIZES, 1)
    assert read("gp_roofline", ctx) == pytest.approx(100 * gp / 200e-6)
    assert 0 < read("gp_roofline", ctx) < 100


def test_a_layer_without_its_kernels_reads_nothing():
    events = [e for e in canned() if "ipm_" not in e["name"]
              and "gp_sample" not in e["name"]]
    ctx = context(trace.reduce(events))
    assert read("qp_roofline", ctx) is None
    assert read("gp_roofline", ctx) is None
    assert read("idle_share", ctx) is not None


def test_untraced_run_reads_no_device_metric():
    ctx = context(None)
    for name in ("idle_share", "device_ops_per_step", "qp_roofline",
                 "gp_roofline"):
        assert read(name, ctx) is None


def test_trace_without_step_annotation_is_refused():
    with pytest.raises(ValueError, match="perfbench_step"):
        trace.reduce([e for e in canned() if e["cat"] != "user_annotation"])


def test_profiler_events_reduce():
    """The profiler's chrome trace export reads back as events that the
    reduction takes: the step annotations and the host ops inside them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(trace.STEP):
                a = a @ a / 64.0
    events = trace.events_from_profiler(prof)
    assert any(e["cat"] == "cpu_op" and e["name"] == "aten::mm"
               for e in events)
    s = trace.reduce(events)
    assert s.steps == 2 and s.window_us > 0 and s.busy_us == 0.0


def test_traced_run_whose_layer_reads_nothing_fails_loudly(tmp_path):
    """On the CPU no device op runs, so the cell's device-trace metrics
    read nothing: the run raises instead of leaving them out."""
    with pytest.raises(session.NothingToRead, match="found nothing"):
        run_cell("pendulum1d_samples.cold_solves", 0.2, traced=True,
                 mix=dict(pool_episodes=2, warmup_episodes=0,
                          compare_steps=1, trace_steps=2),
                 out_dir=str(tmp_path))
