"""The posterior-mean sample (``mean_as_dyn_sample``) of the port's GP
stage against the JAX package's ``agent.sample_dynamics``, float64 on the
CPU: params_pendulum1D_samples and params_car at ns = 4 with the flag set,
seeded GP inputs and draws, iteration 0 (empty hallucination buffer) and
the next iteration on the filled buffer: dg to 1e-10, the mean in sample
0 and the hallucination rows appended alike.  The route is the reference
body on every device (``agent.uses_gp_kernels``), the JAX gate's rule; it
also holds with the true-dynamics sample before it (sample 1 the mean).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampling_gpmpc_tpu import agent as jagent
from sampling_gpmpc_tpu.config import load_problem as jload
from sampling_gpmpc_tpu.envs import make_env as jmake_env
from sampling_gpmpc_tpu.gp.exact import GPHyperArrays as JHyp
from sampling_gpmpc_torch import agent as tagent
from sampling_gpmpc_torch.config import load_problem as tload
from sampling_gpmpc_torch.envs import make_env as tmake_env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = 4


def _problem(load, make_env, config, true_dyn):
    params, spec, data = load(os.path.join(ROOT, "params", config + ".yaml"))
    spec = dataclasses.replace(spec, ns=NS, mean_as_dyn_sample=True,
                               true_dyn_as_sample=true_dyn)
    params["agent"]["num_dyn_samples"] = NS
    return spec, data, make_env(spec, params)


@pytest.mark.parametrize("config,true_dyn", [
    ("params_pendulum1D_samples", False), ("params_car", False),
    ("params_car", True)])
def test_mean_sample_matches_jax(config, true_dyn):
    spec, data, env = _problem(tload, tmake_env, config, true_dyn)
    assert not tagent.uses_gp_kernels(spec, "cuda")
    rng = np.random.default_rng(7)
    lo = np.concatenate([data.x_min, data.u_min])[list(spec.g_idx_inputs)]
    hi = np.concatenate([data.x_max, data.u_max])[list(spec.g_idx_inputs)]
    lo, hi = np.maximum(lo, -5.0), np.minimum(hi, 5.0)
    Xts = [rng.uniform(lo, hi, size=(NS, spec.H, spec.n_gp_inputs))
           for _ in range(2)]
    epss = [np.clip(rng.normal(size=(NS, spec.g_ny, spec.H, spec.Ty)),
                    -spec.gp.beta, spec.gp.beta) for _ in range(2)]

    hyp = GPHyperArrays.from_spec(spec.gp, "cpu", torch.float64)
    gp = tagent.init_gp_state(spec, env, "cpu", torch.float64,
                              capacity=2 * spec.H, hyp=hyp)
    js, _, jenv = _problem(jload, jmake_env, config, true_dyn)
    jhyp = JHyp.from_spec(js.gp, jnp.float64)
    jgp = jagent.init_gp_state(js, jenv, jnp.float64, capacity=2 * js.H)
    jsample = {he: jax.jit(lambda g, X_, e, _he=he: jagent.sample_dynamics(
        js, jenv, jhyp, g, X_, e, hall_empty=_he)) for he in (False, True)}
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for it, (Xt, eps) in enumerate(zip(Xts, epss)):
            dg, gp = tagent.sample_dynamics(
                spec, env, hyp, gp, torch.as_tensor(Xt), torch.as_tensor(eps),
                hall_empty=it == 0)
            jdg, jgp = jsample[it == 0](jgp, jnp.asarray(Xt),
                                        jnp.asarray(eps))
            np.testing.assert_allclose(dg.numpy(), np.asarray(jdg),
                                       atol=1e-10, rtol=0, err_msg=str(it))
            np.testing.assert_allclose(gp.hall_Y.numpy(),
                                       np.asarray(jgp.hall_Y), atol=1e-10,
                                       rtol=0, equal_nan=True)
            # the mean sample is the posterior mean of its inputs
            k = int(true_dyn)
            posterior = (tagent._batched_posterior_real if it == 0 else
                         tagent._batched_posterior_incremental)
            prev = gp._replace(hall_n=gp.hall_n - spec.H,
                               hall_Z=gp.hall_Z.clone(),
                               hall_Y=gp.hall_Y.clone())
            prev.hall_Y[:, :, prev.hall_n:] = float("nan")
            prev.hall_Z[:, :, prev.hall_n:] = tagent.FAR
            mean, _ = posterior(spec, hyp, prev, torch.as_tensor(Xt))
            np.testing.assert_allclose(
                dg[k].numpy(), mean[k].reshape(spec.g_ny, spec.H,
                                               spec.Ty).numpy(),
                atol=1e-12, rtol=0)
    finally:
        torch.set_num_threads(old)


@pytest.mark.slow
def test_f32_mean_route_bar():
    """The float32 reading behind chip_smoke.py's phase mean, on the CPU:
    the mean sample within the debug phase's moment bars of the float64
    posterior mean, no draw outside the tube, every draw within
    MEAN_REL_TOL of the tube from its float64 evaluation (prints the
    readings)."""
    import chip_smoke as cs
    reads = cs.mean_route_readings(torch.device("cpu"), torch.float32)
    print(reads)
    for it, r in enumerate(reads):
        tol = cs.DEBUG_MOMENT_TOL if it == 0 else cs.DEBUG_HALL_MOMENT_TOL
        assert r["finite"] and r["violations"] == 0
        assert r["mean"] <= tol and r["draws"] <= cs.MEAN_REL_TOL
