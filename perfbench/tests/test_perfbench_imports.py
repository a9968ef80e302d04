"""What the benchmark loads: nothing of JAX or the JAX package in a run,
nothing of the measured program in the reference.  Both checks compare
top-level module names whole (the program's name begins with the JAX
package's)."""

import subprocess
import sys
import textwrap

from conftest import ROOT, fs_root


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter has loaded after
    running ``code`` from the repository root."""
    script = textwrap.dedent(code) + textwrap.dedent("""
        import sys
        print(sorted({m.split('.')[0] for m in list(sys.modules)}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded_after("""
        import time, torch
        from perfbench import cell, run, session
        c = cell.load("pendulum1d_samples.cold_solves")
        import dataclasses
        c.mix = dataclasses.replace(c.mix, pool_episodes=2, compare_steps=1,
                                    warmup_episodes=0)
        try:
            session.run(c, 3, 0.2, True, "cpu", time.perf_counter(),
                        "perfbench_out/tests", lambda m: None)
        except session.NothingToRead:
            pass    # the CPU runs no device op for the layers' shares
        assert run.forbidden_modules() == []
    """)
    assert "sampling_gpmpc_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "sampling_gpmpc_tpu"}


def test_a_rollout_run_loads_no_jax(tmp_path):
    config = tmp_path / "fs.json"
    names = loaded_after(f"""
        import dataclasses, json, time, torch
        from perfbench import cell, run, session
        c = cell.load("car_residual_fs.rollouts", "{fs_root(tmp_path)}")
        p = json.load(open(c.config_path))
        p["agent"]["num_dyn_samples"] = 4
        p["common"]["num_MPC_itrs"] = 2
        json.dump(p, open("{config}", "w"))
        c.config_path = "{config}"
        c.mix = dataclasses.replace(c.mix, pool_episodes=1,
                                    warmup_episodes=0,
                                    extra={{"compare_realizations": 2}})
        session.run(c, 3, 0.1, False, "cpu", time.perf_counter(),
                    "{tmp_path}", lambda m: None, dtype=torch.float64)
        assert run.forbidden_modules() == []
    """)
    assert "sampling_gpmpc_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "sampling_gpmpc_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("""
        import torch
        from perfbench import check, fs_bounds
        from perfbench.reference import fs, gp, mpc, problem, qp
        m = mpc.Model.from_file("perfbench/configs/car_samples.json", "cpu",
                                torch.float64)
        X, U = mpc.init_iterate(m)
        f = fs.Model.from_file("perfbench/configs/car_residual_fs.json",
                               "cpu", torch.float64)
        eps = torch.zeros((f.T, 2, f.spec.g_ny, 1, 1), dtype=torch.float64)
        f.T = 2
        fs.rollout(f, eps)
        fs_bounds.rollout_s(dict(ns=2, g_ny=3, R=45, T=2, D=2, nx=4, word=8))
    """)
    assert "perfbench" in names
    assert "sampling_gpmpc_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "sampling_gpmpc_tpu"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from perfbench import run
    before = set(run.forbidden_modules())
    fake = type(sys)("x")
    for name in ("sampling_gpmpc_tpux", "jaxfoo", "flaxen.core",
                 "sampling_gpmpc_torch.extra"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    monkeypatch.setitem(sys.modules, "sampling_gpmpc_tpu.agent", fake)
    assert set(run.forbidden_modules()) == before | {"jax",
                                                     "sampling_gpmpc_tpu"}


def test_cli_without_cuda_exits_non_zero_with_no_result():
    import torch
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "pendulum1d_samples.episodes", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
