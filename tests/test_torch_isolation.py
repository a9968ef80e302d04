"""The port stands alone and never falls back silently.

* ``sampling_gpmpc_torch`` and every submodule import in a fresh process
  whose import system refuses ``jax`` and ``sampling_gpmpc_tpu``;
  ``chip_smoke.py`` imports neither either;
* entry points called without a device on a host without CUDA raise;
* the kernel wrappers take their plain version only for CPU tensors: any
  other device launches the kernel or raises.
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.ops import (batch_linalg, batched_chol, gp_hall,
                                      gp_sample, ipm)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCK = ("jax", "jaxlib", "sampling_gpmpc_tpu", "benchmarking", "profiling",
         "examples")
for k in list(sys.modules):
    if k.split(".")[0] in BLOCK:
        del sys.modules[k]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
import sampling_gpmpc_torch
names = [m.name for m in pkgutil.walk_packages(
    sampling_gpmpc_torch.__path__, "sampling_gpmpc_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20      # every module was imported


def test_no_jax_import_statements():
    """Static check, including imports inside functions (chip_smoke imports
    the port inside main())."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT,
                                                  "sampling_gpmpc_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "sampling_gpmpc_tpu", "benchmarking",
                    "profiling", "examples"), (path, m)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_evaluation_entry_points_raise_without_cuda(no_cuda):
    """The evaluation side's CLIs default to CUDA and raise without it."""
    from sampling_gpmpc_torch import (collective_traffic,
                                      linearization_baseline,
                                      robust_tube_baseline,
                                      simulate_true_reachable_set,
                                      status_band)
    from sampling_gpmpc_torch.examples import (gp_conditioning_demo,
                                               lqr_sanity)
    for main in (simulate_true_reachable_set.main,
                 linearization_baseline.main, robust_tube_baseline.main,
                 status_band.main, collective_traffic.main,
                 gp_conditioning_demo.main, lqr_sanity.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])


def test_entry_points_raise_without_cuda(no_cuda):
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import DEMPC
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch import profile_loop
    from sampling_gpmpc_torch.main import main
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data

    params, spec, data = load_problem(os.path.join(
        ROOT, "params", "params_pendulum1D_samples.yaml"))
    env = make_env(spec, params)
    for call in (lambda: setup.resolve_device(None),
                 lambda: setup.resolve_device("cuda"),
                 lambda: DEMPC(params, spec, data, env),
                 lambda: make_ocp_data(spec, data),
                 lambda: agent.init_gp_state(spec, env),
                 lambda: agent.make_epistemic(spec),
                 lambda: sqp.init_iterate(spec),
                 lambda: sqp.init_qp_ws(spec),
                 lambda: main(["-param", "params_pendulum1D_samples"]),
                 lambda: profile_loop.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # an explicit CPU request runs, in float64 by default
    assert setup.resolve("cpu") == (torch.device("cpu"), torch.float64)


def test_fs_and_microbench_entry_points_raise_without_cuda(no_cuda):
    from sampling_gpmpc_torch import microbench_ipm, microbench_linalg
    from sampling_gpmpc_torch import simulate_forward_sampling
    for call in (lambda: simulate_forward_sampling.main([]),
                 lambda: microbench_linalg.main([]),
                 lambda: microbench_ipm.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_linalg_wrappers_never_fall_back(monkeypatch):
    """chol, tri_solve and batched_cholesky(use_kernel=True) take their
    plain version only for a CPU tensor: at a kernel shape on another
    device they launch or raise, with no exception handler."""
    for mod, name in ((batch_linalg, "chol_plain"),
                      (batch_linalg, "tri_solve_plain"),
                      (batched_chol, "batched_cholesky_plain")):
        monkeypatch.setattr(mod, name, _refuse)
    meta = lambda *s: torch.empty(*s, device="meta")
    n = batch_linalg.MIN_N
    with pytest.raises(ValueError, match="unsupported device"):
        batch_linalg.chol(meta(3, n, n))
    with pytest.raises(ValueError, match="unsupported device"):
        batch_linalg.tri_solve(meta(3, n, n), meta(3, n, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        batched_chol.batched_cholesky(meta(3, n, n), use_kernel=True)
    for fn, plain, cond in (
            (batch_linalg.chol, "chol_plain(", 'A.device.type == "cpu"'),
            (batch_linalg.tri_solve, "tri_solve_plain(",
             'L.device.type == "cpu"'),
            (batched_chol.batched_cholesky, "batched_cholesky_plain(",
             'A.device.type == "cpu"')):
        src = inspect.getsource(fn)
        assert "try:" not in src and src.count(plain) == 1 and cond in src
    # float64 at a kernel shape is refused, naming the dtype
    with pytest.raises(ValueError, match="float32"):
        batched_chol.check_supported(n, torch.float64)
    batched_chol.check_supported(180, torch.float32)


def test_profile_busy_time_is_the_union_of_spans():
    """Device busy time counts overlapping or nested intervals once."""
    from sampling_gpmpc_torch.profile_loop import _intervals_union_us
    assert _intervals_union_us([]) == 0.0
    assert _intervals_union_us([(5, 7), (0, 2), (1, 3), (6, 6.5)]) == 5.0


def _refuse(*a, **k):
    raise AssertionError("plain version taken for a non-CPU tensor")


def test_gp_wrapper_never_falls_back(monkeypatch):
    monkeypatch.setattr(gp_sample, "sample_empty_plain", _refuse)
    ns, Ht, R = 2, 6, 4
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gp_sample.sample_empty_one(meta(ns, Ht, R), meta(ns, Ht, Ht),
                                   meta(ns, Ht), meta(R, R), meta(R),
                                   meta(Ht), 1e-6, 2.5, -1.0, 1e-5, ty=3)
    # the CPU branch is the only one that calls the plain version, and no
    # exception handler can turn a failed launch into a plain result
    src = inspect.getsource(gp_sample.sample_empty_one)
    assert "try:" not in src and src.count("sample_empty_plain(") == 1
    assert 'Kxm.device.type == "cpu"' in src


def test_gp_sample_stacked_wrapper_never_falls_back(monkeypatch):
    """The every-output empty-hall stage the agent calls: the plain version
    only for CPU tensors, a raise for any other device; the agent makes
    one call of it per stage."""
    monkeypatch.setattr(gp_sample, "sample_empty_plain_stacked", _refuse)
    no, ns, Ht, R = 3, 2, 6, 4
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gp_sample.sample_empty(meta(no, ns, Ht, R), meta(no, ns, Ht, Ht),
                               meta(no, ns, Ht), meta(no, R, R), meta(no, R),
                               meta(no, Ht), 1e-6, 2.5, -1.0, 1e-5, ty=3)
    src = inspect.getsource(gp_sample.sample_empty)
    assert "try:" not in src and src.count("sample_empty_plain_stacked(") == 1
    assert 'Kxm.device.type == "cpu"' in src
    from sampling_gpmpc_torch import agent
    src = inspect.getsource(agent._fused_sample_empty)
    assert src.count("gp_sample.sample_empty(") == 1 and "for j" not in src


def test_gp_hall_wrapper_never_falls_back(monkeypatch):
    monkeypatch.setattr(gp_hall, "sample_hall_plain", _refuse)
    ns, Ht, Rr, Rh = 2, 6, 4, 8
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gp_hall.sample_hall_one(4, meta(ns, Ht, Rr), meta(ns, Ht, Rh),
                                meta(ns, Ht, Ht), meta(ns, Rr, Rh),
                                meta(ns, Rh, Rh), meta(ns, Rh), meta(ns, Ht),
                                meta(Rr, Rr), meta(Rr), meta(Ht), 1e-6, 2.5,
                                -1.0, 1e-5, ty=3)
    src = inspect.getsource(gp_hall.sample_hall_one)
    assert "try:" not in src and src.count("sample_hall_plain(") == 1
    assert 'Kxr.device.type == "cpu"' in src


def test_gp_hall_stacked_wrapper_never_falls_back(monkeypatch):
    """The every-output stage the agent calls: the plain version only for
    CPU tensors, a raise for any other device."""
    monkeypatch.setattr(gp_hall, "sample_hall_plain_stacked", _refuse)
    no, ns, Ht, Rr, Rh = 3, 2, 6, 4, 8
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gp_hall.sample_hall(4, meta(no, ns, Ht, Rr), meta(no, ns, Ht, Rh),
                            meta(no, ns, Ht, Ht), meta(no, ns, Rr, Rh),
                            meta(no, ns, Rh, Rh), meta(no, ns, Rh),
                            meta(no, ns, Ht), meta(no, Rr, Rr), meta(no, Rr),
                            meta(no, Ht), 1e-6, 2.5, -1.0, 1e-5, ty=3)
    src = inspect.getsource(gp_hall.sample_hall)
    assert "try:" not in src and src.count("sample_hall_plain_stacked(") == 1
    assert 'Kxr.device.type == "cpu"' in src
    # the agent's hall stage is one call of it
    from sampling_gpmpc_torch import agent
    src = inspect.getsource(agent._fused_sample_hall)
    assert src.count("gp_hall.sample_hall(") == 1 and "for j" not in src


def test_ipm_wrapper_never_falls_back(monkeypatch):
    monkeypatch.setattr(ipm, "run_full_plain", _refuse)
    nU, m_h, m_s = 3, 4, 2
    meta = lambda *s: torch.empty(*s, device="meta")
    args = (meta(nU, nU), meta(nU), meta(m_h, nU), meta(m_h), meta(m_s, nU),
            *[meta(m_s) for _ in range(6)])
    with pytest.raises(ValueError, match="not CUDA"):
        ipm.run_full(*args, None, None, 3e-5, 1e-7, 150)
    src = inspect.getsource(ipm.run_full)
    assert "try:" not in src and src.count("run_full_plain(") == 1
    assert 'g.device.type == "cpu"' in src
    for fn in (ipm.prepare, ipm.mehrotra):
        assert "try:" not in inspect.getsource(fn)


def test_fused_gates_need_cuda_float32(monkeypatch):
    """Off the CPU there is no plain route: what the kernels cannot take
    raises, naming the limit, and the callers route on the device alone."""
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    _, spec, _ = load_problem(os.path.join(
        ROOT, "params", "params_pendulum1D_samples.yaml"))
    gp_sample.check_supported(51, 108, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        gp_sample.check_supported(51, 108, torch.float64)
    # R does not bound the stage's shared memory any more: R = 600 keeps
    # every region of the car's Ht = 60 in shared memory; an empty stage is
    # refused, naming the limit
    gp_sample.check_supported(60, 600, torch.float32)
    assert gp_sample.sample_layout(60)[2] == (False, False, False, False)
    with pytest.raises(ValueError, match="1 <= Ht"):
        gp_sample.check_supported(0, 108, torch.float32)
    # the hall stage: the car's fills up to 3 iterations of H*Ty = 60 rows
    for nh in (0, 60, 120, 180):
        gp_hall.check_supported(60, 180, 240, nh, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        gp_hall.check_supported(60, 180, 240, 60, torch.float64)
    # the full 240-row capacity runs with the factor's tiles in the
    # global workspace; a fill past the capacity is refused
    gp_hall.check_supported(60, 180, 240, 240, torch.float32)
    assert gp_hall.factor_tiles_global(60, 240)
    with pytest.raises(ValueError, match="nh <= Rh"):
        gp_hall.check_supported(60, 180, 240, 244, torch.float32)
    ipm.check_supported(17, 7174, 70, torch.float32)

    # a float64 QP off the CPU reaches the kernel wrapper and raises there
    monkeypatch.setattr(ipm, "run_full_plain", _refuse)
    meta = lambda *s: torch.empty(*s, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        qp_mod.solve_qp_soft(meta(3, 3), meta(3), meta(4, 3), meta(4),
                             meta(0, 3), *[meta(0) for _ in range(6)])
    # off the CPU the GP stages take the kernels; the posterior-mean sample
    # takes the reference body on every device, the JAX gate's own rule
    # (pallas_gp.py:97: the kernels return no posterior mean)
    spec_m = dataclasses.replace(spec, mean_as_dyn_sample=True)
    for dev in ("cuda", "meta"):
        assert agent.uses_gp_kernels(spec, dev)
        assert not agent.uses_gp_kernels(spec_m, dev)
    assert not agent.uses_gp_kernels(spec, "cpu")
    src = inspect.getsource(agent.sample_dynamics)
    assert "uses_gp_kernels(spec, Xt.device)" in src and "raise" not in src
    for fn in (qp_mod.solve_qp_soft, agent.sample_dynamics):
        assert "fused_ok" not in inspect.getsource(fn)


def test_epistemic_draws_truncated_and_seeded():
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    _, spec, _ = load_problem(os.path.join(
        ROOT, "params", "params_pendulum1D_samples.yaml"))
    a = agent.make_epistemic(spec, torch.Generator().manual_seed(1), "cpu")
    b = agent.make_epistemic(spec, torch.Generator().manual_seed(1), "cpu")
    assert a.shape == (spec.num_mpc_iter, spec.max_sqp_iter, spec.ns,
                       spec.g_ny, spec.H, spec.Ty)
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= spec.gp.beta
    # a standard normal truncated at +-2.5 has variance
    # 1 - 5 phi(2.5) / (2 Phi(2.5) - 1) = 0.9113
    assert abs(float(a.var()) - 0.9113) < 0.01
    assert np.isfinite(a.numpy()).all()
