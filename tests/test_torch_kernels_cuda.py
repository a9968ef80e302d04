"""The port's CUDA kernels against their plain torch versions, on the GPU.

Marked ``cuda``: on a host without an NVIDIA GPU every test skips.  Run on
the GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest configures JAX, which the GPU
machine does not have; this file imports only the port.)

(chip_smoke.py runs the same comparisons at the flagship shape.)
"""

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch.ocp import qp as qp_mod
from sampling_gpmpc_torch.ops import gp_sample, ipm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from sampling_gpmpc_torch import setup
    return setup.resolve_device("cuda")


@pytest.mark.parametrize("ns,H,ty,R", [(8, 5, 3, 36), (70, 17, 3, 108)])
def test_gp_sample_kernel_matches_plain(dev, ns, H, ty, R):
    """Random feature-space covariances (K = Phi Phi' / F, F > R + Ht), so
    every posterior block is a true covariance; float32 rounding only
    (2e-4 relative)."""
    rng = np.random.default_rng(ns)
    Ht = H * ty
    F = R + Ht + 16
    P_tr = rng.normal(size=(R, F)) / np.sqrt(F)
    P_te = rng.normal(size=(ns, Ht, F)) / np.sqrt(F)
    L = np.linalg.cholesky(P_tr @ P_tr.T + 1e-6 * np.eye(R))
    kw = dict(Kxm=P_te @ P_tr.T, Ktt=P_te @ np.swapaxes(P_te, 1, 2),
              eps=np.clip(rng.normal(size=(ns, Ht)), -2.5, 2.5),
              Linv=np.linalg.inv(L), alpha=rng.normal(size=R) * 0.1,
              prior_var=np.full(Ht, 1.0))
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev).contiguous()
         for k, v in kw.items()}
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    got = gp_sample.sample_empty_one(**t, **args)
    ref = gp_sample.sample_empty_plain(**t, **args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-4 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ipm_kernels_match_plain(dev, seed):
    """The test_pallas_ipm problem family, cold and warm, float32."""
    rng = np.random.default_rng(seed)
    nU, mh, ms = 12, 384, 64
    Hh = rng.normal(size=(nU, nU))
    prob = [Hh @ Hh.T + np.eye(nU), rng.normal(size=nU) * 3,
            rng.normal(size=(mh, nU)), rng.uniform(0.1, 1.5, size=mh),
            rng.normal(size=(ms, nU)), rng.uniform(-0.5, -0.1, size=ms),
            rng.uniform(0.05, 2.0, size=ms), np.full(ms, 3.0),
            np.full(ms, 2.0), np.full(ms, 5.0), np.full(ms, 4.0)]
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
            for a in prob]
    ipm.check_supported(nU, mh, ms, torch.float32)
    cold = qp_mod.solve_qp_soft(*args)
    kw = (3e-5, 1e-7, 150, qp_mod.STALL_ITERS, qp_mod.STALL_RTOL,
          qp_mod.MU_GRIND, qp_mod.WS_BAND)
    plain = qp_mod._finish(*ipm.run_full_plain(*args, None, None, *kw), 3e-5)
    assert int(cold.status) == 0 and int(plain.status) == 0
    np.testing.assert_allclose(cold.z.cpu().numpy(), plain.z.cpu().numpy(),
                               atol=2e-3)
    args[1] = args[1] + 1e-3
    valid = torch.ones((), dtype=torch.bool, device=dev)
    warm = qp_mod.solve_qp_soft(*args, ws=cold.state, ws_valid=valid)
    warm_p = qp_mod._finish(*ipm.run_full_plain(*args, cold.state, valid,
                                                *kw), 3e-5)
    assert int(warm.status) == 0
    np.testing.assert_allclose(warm.z.cpu().numpy(), warm_p.z.cpu().numpy(),
                               atol=2e-4)
    assert abs(int(warm.iters) - int(warm_p.iters)) <= 2
