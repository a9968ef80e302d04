"""The port's debug, live and replay paths on the CPU.

* ``DEMPC(debug_sqp_dir=...)`` writes one PNG per SQP iterate and
  ``render_frames_video`` assembles them into a GIF (magic GIF89a);
* ``LiveRenderer`` grabs one frame per MPC step while the loop runs;
* ``Recorder.load`` reads the JAX package's artifact and the JAX
  ``Recorder.load`` reads the port's (the same data.pkl keys);
* ``visu_main`` renders ``trajectory.png`` (and ``--video``) from an
  artifact;
* the modules on the solve path and the tools import without matplotlib
  and PIL (the GPU machine has neither).

params_pendulum1D_samples at ns = 6, 2 MPC steps, float64 on the CPU.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch.config import load_problem
from sampling_gpmpc_torch.dempc import DEMPC
from sampling_gpmpc_torch.envs import make_env
from sampling_gpmpc_torch.recorder import Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "params_pendulum1D_samples"
KEYS = ("state_traj", "input_traj", "mean_state_traj", "true_state_traj",
        "physical_state_traj", "solver_time", "gp_model_after_solve_train_X",
        "gp_model_after_solve_train_Y", "tilde_eps_list", "ci_list")


def _problem():
    params, spec, data = load_problem(os.path.join(ROOT, "params",
                                                   CONFIG + ".yaml"))
    spec = dataclasses.replace(spec, ns=6, num_mpc_iter=2)
    params["agent"]["num_dyn_samples"] = spec.ns
    return params, spec, data, make_env(spec, params)


@pytest.fixture(scope="module")
def debug_run(tmp_path_factory):
    """A 2-step loop with every SQP iterate recorded and rendered, an
    in-loop live renderer and the recorder."""
    from sampling_gpmpc_torch import visu
    params, spec, data, env = _problem()
    out = str(tmp_path_factory.mktemp("debug"))
    rec = Recorder(params, out)
    rec.tilde_eps_list, rec.ci_list = data.tilde_eps, data.ci
    live = visu.LiveRenderer(params, out, fps=2, tilde_eps=data.tilde_eps,
                             P=data.P_term)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mpc = DEMPC(params, spec, data, env, device="cpu",
                    dtype=torch.float64, recorder=rec, debug_sqp_dir=out,
                    live=live)
        res = mpc.run()
    finally:
        torch.set_num_threads(old)
    return params, spec, data, mpc, res, rec, live, out


def test_dempc_debug_frames(debug_run):
    from sampling_gpmpc_torch import visu
    params, spec, data, mpc, res, rec, live, out = debug_run
    # one SQP iteration per step in this config: one frame per step
    assert len(mpc.sqp_records) == spec.num_mpc_iter * spec.max_sqp_iter
    assert [(r["mpc_iter"], r["sqp_iter"]) for r in mpc.sqp_records] == [
        (m, 0) for m in range(spec.num_mpc_iter)]
    for r in mpc.sqp_records:
        assert os.path.getsize(r["frame"]) > 0
        with open(r["frame"], "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert np.isfinite(r["x_diff"]) and np.isfinite(r["u_diff"])
    assert res["sqp_status_traj"] == [0] * spec.num_mpc_iter
    vid = visu.render_frames_video([r["frame"] for r in mpc.sqp_records],
                                   os.path.join(out, "video_sqp.gif"))
    with open(vid, "rb") as f:
        assert f.read(6) == b"GIF89a"


def test_debug_run_is_the_default_loop(debug_run):
    """The recorded loop's trajectory is the default loop's, bit for bit."""
    params, spec, data, mpc, res, rec, live, out = debug_run
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = DEMPC(params, spec, data, make_env(spec, params),
                      device="cpu", dtype=torch.float64).run()
    finally:
        torch.set_num_threads(old)
    for k in ("physical_state_traj", "state_traj", "input_traj"):
        assert np.array_equal(np.stack(res[k]), np.stack(plain[k])), k
    assert res["qp_iters"] == plain["qp_iters"]


def test_live_renderer(debug_run):
    params, spec, data, mpc, res, rec, live, out = debug_run
    assert live.frames == spec.num_mpc_iter
    path = live.close()
    assert os.path.getsize(path) > 0
    if path.endswith(".gif"):
        with open(path, "rb") as f:
            assert f.read(6) == b"GIF89a"


def test_recorder_load_both_ways(debug_run, tmp_path):
    from sampling_gpmpc_tpu.recorder import Recorder as JRecorder
    params, spec, data, mpc, res, rec, live, out = debug_run
    # the port's artifact through the JAX package's load
    art = JRecorder.load(rec.save_data(str(tmp_path / "port")))
    assert set(art) == set(KEYS)
    assert len(art["state_traj"]) == spec.num_mpc_iter
    assert art["state_traj"][0].shape == (spec.H + 1, spec.ns * spec.nx)
    np.testing.assert_array_equal(art["state_traj"][1],
                                  rec.state_traj[1])
    np.testing.assert_array_equal(art["tilde_eps_list"], data.tilde_eps)
    # a JAX artifact through the port's load
    jrec = JRecorder(params, str(tmp_path / "jax"))
    for x, X, U in zip(rec.physical_state_traj, rec.state_traj,
                       rec.input_traj):
        jrec.record(x[:spec.nx], X.reshape(spec.H + 1, spec.ns, spec.nx), U,
                    0.1)
    jrec.tilde_eps_list, jrec.ci_list = data.tilde_eps, data.ci
    back = Recorder.load(jrec.save_data())
    assert set(back) == set(KEYS)
    for k in ("state_traj", "input_traj", "physical_state_traj"):
        for a, b in zip(back[k], getattr(rec, k)):
            np.testing.assert_array_equal(a, b)


def test_visu_main_renders_trajectory(debug_run):
    """``visu_main`` on an artifact under experiments/ (a fresh run index,
    removed afterwards): trajectory.png and the replay video."""
    from sampling_gpmpc_torch import visu_main
    params, spec, data, mpc, res, rec, live, out = debug_run
    i = 970000 + os.getpid() % 10000
    run_dir = os.path.join(ROOT, "experiments", params["experiment"]["folder"],
                           "env_0", CONFIG, str(i))
    try:
        rec.save_data(run_dir)
        path = visu_main.main(["-param", CONFIG, "-i", str(i), "--video"])
        assert path == os.path.join(run_dir, "trajectory.png")
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        vids = [f for f in os.listdir(run_dir) if f.startswith("video_gp")]
        assert vids and os.path.getsize(os.path.join(run_dir, vids[0])) > 0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


_NO_PLOTTING = r"""
import importlib, importlib.abc, sys
BLOCK = ("matplotlib", "PIL", "jax", "sampling_gpmpc_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
for n in ("sampling_gpmpc_torch.dempc", "sampling_gpmpc_torch.recorder",
          "sampling_gpmpc_torch.main", "sampling_gpmpc_torch.visu_main",
          "sampling_gpmpc_torch.ocp.sqp", "sampling_gpmpc_torch.tools",
          "sampling_gpmpc_torch.tools.goldens",
          "sampling_gpmpc_torch.tools.lipschitz",
          "sampling_gpmpc_torch.tools.mle",
          "sampling_gpmpc_torch.tools.num_of_samples",
          "sampling_gpmpc_torch.tools.sample_complexity",
          "sampling_gpmpc_torch.tools.terminal_set", "chip_smoke"):
    importlib.import_module(n)
try:
    importlib.import_module("sampling_gpmpc_torch.visu")
except ImportError:
    print("visu needs matplotlib")
"""


def test_solve_path_and_tools_import_without_matplotlib():
    out = subprocess.run([sys.executable, "-c", _NO_PLOTTING], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "visu needs matplotlib"
