"""The port's float64 closed loops against the JAX package's committed
full-length goldens (tests/goldens/<config>.npz, written by
``python -m sampling_gpmpc_tpu.tools.goldens``).

The port cannot reproduce ``jax.random``, so each loop is fed the draws
JAX's ``DEMPC`` makes for the config (``agent.make_epistemic`` on the
config's seed).  Every key of the golden (the physical trajectory, the
final state, the applied inputs and the last plan) is held at 1e-7.
``params_pendulum``'s 40 steps run under ``slow``; tier-1 holds its first
8 steps (the per-step keys).
``params_car`` stays held by teacher forcing (tests/test_torch_car.py):
its free-running loop leaves the golden at step 6 in the JAX package
itself from a 1e-12 start perturbation.

The loops are chains of small torch ops, which run several times slower
when the suite's parallel workers oversubscribe the cores with torch's
intra-op threads, so they run on one thread; ``params_car_samples``
(H = 100, a QP of nU = 200) on four, its products being large (alone: 57
s on one thread, 21 on four, 13 on eight; in the suite on eight it took
15 s in one run and 242 s in the next).
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu import agent as jagent
from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.dempc import DEMPC
from sampling_gpmpc_torch.envs import make_env

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-7
PER_STEP = ("physical_state_traj", "u0_traj")


@contextlib.contextmanager
def _torch_threads(n):
    old = torch.get_num_threads()
    if n is not None:
        torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _check(config, steps=None, threads=1):
    """Run the port's loop on JAX's draws (the first ``steps`` MPC steps,
    or all) and hold it to the golden: every key, or the per-step keys'
    first ``steps`` rows."""
    path = os.path.join(HERE, "params", config + ".yaml")
    _, jspec, _ = jload(path)
    eps = np.asarray(jagent.make_epistemic(jax.random.PRNGKey(jspec.seed),
                                           jspec, jnp.float64))
    params, spec, data = tload(path)
    if steps is not None:
        spec = dataclasses.replace(spec, num_mpc_iter=steps)
    with _torch_threads(threads):
        out = DEMPC(params, spec, data, make_env(spec, params), device="cpu",
                    dtype=torch.float64, epistemic=eps).run()
    got = {
        "physical_state_traj": np.stack(out["physical_state_traj"]),
        "final_state": np.asarray(out["final_state"]),
        "u0_traj": np.stack([u[0] for u in out["input_traj"]]),
        "last_plan_X": np.asarray(out["state_traj"][-1]),
        "last_plan_U": np.asarray(out["input_traj"][-1]),
    }
    with np.load(os.path.join(HERE, "tests", "goldens",
                              config + ".npz")) as z:
        golden = {k: z[k] for k in z.files}
    assert set(got) == set(golden)
    if steps is not None:
        got = {k: got[k] for k in PER_STEP}
        golden = {k: golden[k][:steps] for k in PER_STEP}
    for key in sorted(golden):
        np.testing.assert_allclose(got[key], golden[key], atol=ATOL, rtol=0,
                                   err_msg=f"{config}: {key}")


@pytest.mark.parametrize("config,steps,threads", [
    ("params_pendulum", 8, 1),          # 3 SQP iterations a step, m_s = 0
    ("params_pendulum_samples", None, 1),   # ns = 500, H = 1, 60 steps
    ("params_car_residual", None, 1),   # one step of up to 150 iterations
    ("params_pendulum1D_samples", None, 1),  # the flagship, 55 steps
    ("params_car_samples", None, 4),    # H = 100, the condensing depth
])
def test_port_reproduces_golden(config, steps, threads):
    _check(config, steps, threads)


@pytest.mark.slow
def test_port_reproduces_full_pendulum_golden():
    """params_pendulum's 40 steps, every key."""
    _check("params_pendulum", threads=None)
