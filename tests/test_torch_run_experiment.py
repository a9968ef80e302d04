"""The port's batch runner (``sampling_gpmpc_torch/run_experiment.sh``, the
counterpart of the repository root's ``run_experiment.sh``): one seed of
params_pendulum1D_samples on the CPU, the arguments after ``--`` passed to
every run of ``python -m sampling_gpmpc_torch.main``."""

import os
import pickle
import shutil
import subprocess

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_experiment_one_seed_on_the_cpu(tmp_path):
    config = "params_pendulum1D_samples"
    i = 970000 + os.getpid() % 10000
    run_dir = os.path.join(ROOT, "experiments", "pendulum", "env_0", config,
                           str(i))
    script = os.path.join(ROOT, "sampling_gpmpc_torch", "run_experiment.sh")
    try:
        # from another directory: the script runs from the repository root
        out = subprocess.run(
            ["bash", script, config, str(i), "--", "--device", "cpu", "-q"],
            cwd=tmp_path, capture_output=True, text=True, timeout=300,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        assert lines[0] == f"=== {config} seed {i} ==="
        assert f"saved {run_dir}/data.pkl" in lines
        assert "on cpu torch.float64" in out.stdout
        with open(os.path.join(run_dir, "data.pkl"), "rb") as f:
            art = pickle.load(f)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    # the flagship's closed loop: final state near [3.06, 0.25]
    final = np.asarray(art["physical_state_traj"][-1])
    assert np.all(np.isfinite(final)) and abs(final[0] - 3.06) < 0.1
