"""The port's Monte-Carlo ground truth (B1,
``sampling_gpmpc_torch.simulate_true_reachable_set``).

* ``batch_rollout`` over B = 3 repeats (one rollout of 3 ns realizations)
  equals the JAX package's ``forward_sample_rollout`` run once per repeat
  on the same injected draws, to 1e-10 (params_pendulum1D_samples, ns cut
  to 8, T = 5, the plan's ancillary feedback);
* the CLI's pickles, (repeats_in_chunk, T+1, ns, nx) each, are read
  unchanged by ``benchmarking/reachable_set_coverage.load_mc_stages``,
  ``generate_convex_hull.stage_hulls`` and ``paper_figures.
  fill_true_uncertainty`` (the JAX-free readers), and the chunks' draws
  depend on the chunk's index alone, not on the batch size, also where
  a rollout's repeats span chunks.
"""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from sampling_gpmpc_tpu import agent as jagent  # noqa: E402
from sampling_gpmpc_tpu.config import load_problem as jload  # noqa: E402
from sampling_gpmpc_tpu.envs import make_env as jmake_env  # noqa: E402
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp  # noqa: E402
from sampling_gpmpc_tpu.reachability import \
    forward_sample_rollout as jforward  # noqa: E402
from sampling_gpmpc_torch import agent as tagent  # noqa: E402
from sampling_gpmpc_torch import simulate_true_reachable_set as gt  # noqa
from sampling_gpmpc_torch.config import load_problem as tload  # noqa: E402
from sampling_gpmpc_torch.envs import make_env as tmake_env  # noqa: E402
from sampling_gpmpc_torch.gp.exact import GPHyperArrays  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarking"))
import generate_convex_hull  # noqa: E402
import paper_figures  # noqa: E402
import reachable_set_coverage as jcov  # noqa: E402

CONFIG = os.path.join(ROOT, "params", "params_pendulum1D_samples.yaml")
GOLDEN = os.path.join(ROOT, "tests", "goldens",
                      "oracle_pendulum1d_flagship.npz")
NS, T, B = 8, 5, 3


def _problem(load, make_env, ns):
    params, spec, data = load(CONFIG)
    spec = dataclasses.replace(spec, ns=ns)
    params["agent"]["num_dyn_samples"] = ns
    return spec, data, make_env(spec, params)


def test_batched_repeats_match_jax_per_repeat():
    torch.set_num_threads(1)
    spec, data, env = _problem(tload, tmake_env, NS)
    U = np.load(GOLDEN)["plan_U_traj"][0][:T]
    eps = np.clip(np.random.default_rng(3).normal(
        size=(T, B * NS, spec.g_ny, 1, spec.Ty)), -spec.gp.beta,
        spec.gp.beta)
    hyp = GPHyperArrays.from_spec(spec.gp, "cpu", torch.float64)
    gp0 = tagent.init_gp_state(dataclasses.replace(spec, ns=B * NS), env,
                               "cpu", torch.float64, capacity=T, hyp=hyp)
    fb = gt.feedback(spec, data)
    assert fb is not None
    got = gt.batch_rollout(spec, env, hyp, gp0, data.start, U, B,
                           use_feedback=fb, eps=eps).numpy()
    assert got.shape == (B, T + 1, NS, spec.nx)

    js, jd, jenv = _problem(jload, jmake_env, NS)
    jhyp = JHyp.from_spec(js.gp, jnp.float64)
    jgp = jagent.init_gp_state(js, jenv, jnp.float64, capacity=T)
    roll = jax.jit(lambda e: jforward(
        js, jenv, jhyp, jgp, jnp.asarray(jd.start), jnp.asarray(U),
        jax.random.PRNGKey(0), use_feedback={"K": jd.K_fb, "x_eq": jd.goal},
        eps=e)[0])
    for b in range(B):
        ref = roll(jnp.asarray(eps[:, b * NS:(b + 1) * NS]))
        np.testing.assert_allclose(got[b], np.asarray(ref), atol=1e-10,
                                   rtol=0, err_msg=f"repeat {b}")


def test_cli_pickles_read_by_the_jax_free_scripts(tmp_path):
    torch.set_num_threads(1)
    out = tmp_path / "mc"
    gt.main(["--device", "cpu", "--repeats", "5", "--chunk", "2",
             "--batch", "2", "--steps", "4", "--out", str(out)])
    files = sorted(os.listdir(out))
    assert files == [f"X_traj_list_{k}.pkl" for k in range(3)]
    _, spec, _ = tload(CONFIG)
    with open(out / "X_traj_list_2.pkl", "rb") as f:
        last = pickle.load(f)
    assert isinstance(last, np.ndarray)
    assert last.shape == (1, 5, spec.ns, spec.nx)
    assert np.isfinite(last).all()

    stages = jcov.load_mc_stages(str(out))
    assert stages.shape == (5, 5 * spec.ns, spec.nx)
    # repeat r's realization i sits at r * ns + i of every stage
    np.testing.assert_array_equal(stages[:, 4 * spec.ns:], last[0])
    trajs = np.transpose(stages, (1, 0, 2))          # (n_total, T+1, nx)
    hulls = generate_convex_hull.stage_hulls(trajs)
    assert len(hulls) == 5 and hulls[0].shape == (1, 2)   # pinned start
    assert all(h.shape[0] >= 3 for h in hulls[2:])
    fig = plt.figure()
    try:
        assert paper_figures.fill_true_uncertainty(fig.gca(), str(out))
    finally:
        plt.close(fig)

    # the draws are the chunk's: another batch size gives the same pickles,
    # also where a rollout spans chunks (3 repeats: a chunk and a half)
    for batch in (1, 3):
        out2 = tmp_path / f"mc_batch{batch}"
        gt.main(["--device", "cpu", "--repeats", "5", "--chunk", "2",
                 "--batch", str(batch), "--steps", "4", "--out", str(out2)])
        assert sorted(os.listdir(out2)) == files
        np.testing.assert_allclose(jcov.load_mc_stages(str(out2)), stages,
                                   atol=1e-12, rtol=0)


def test_entry_point_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.main(["--repeats", "1"])


@pytest.mark.slow
def test_f32_coverage_bar():
    """The float32 reading behind chip_smoke.py's phase gt, on the CPU:
    the plan's coverage and volume ratio over the first GT_CPU_REPEATS
    repeats' truth in float32 against float64 on the same draws, on the
    stages whose truth hull has a volume (prints the readings)."""
    import chip_smoke as cs
    spec, data, env = _problem(tload, tmake_env, 70)
    g = np.load(GOLDEN)
    U, x0 = g["plan_U_traj"][0], g["physical_state_traj"][0]
    R = cs.GT_CPU_REPEATS
    eps = cs.gt_draws(spec, len(U), R)
    X = {dt: cs.gt_rollout(spec, env, data, U, x0, eps, R,
                           torch.device("cpu"), dt).numpy()
         for dt in (torch.float32, torch.float64)}
    ra, rb, d_cov, d_vol, degen = cs.gt_coverage_compare(
        g["plan_X_traj"][0], X[torch.float32], X[torch.float64], spec.nx)
    print(f"coverage {d_cov}, volume ratio {d_vol} relative, degenerate "
          f"{degen}")
    assert degen == [1]
    assert d_cov <= cs.GT_COV_TOL and d_vol <= cs.GT_VOL_RTOL
