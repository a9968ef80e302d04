"""The port's CUDA kernels against their plain torch versions, on the GPU.

Marked ``cuda``: on a host without an NVIDIA GPU every test skips.  Run on
the GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest configures JAX, which the GPU
machine does not have; this file imports only the port.)

(chip_smoke.py runs the same comparisons at the shapes of the main paths.)
"""

import numpy as np
import pytest
import torch

from sampling_gpmpc_torch.ocp import qp as qp_mod
from sampling_gpmpc_torch.ops import (batch_linalg, batched_chol, gp_hall,
                                      gp_sample, ipm)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from sampling_gpmpc_torch import setup
    return setup.resolve_device("cuda")


@pytest.mark.parametrize("ns,H,ty,R", [(8, 5, 3, 36), (70, 17, 3, 108),
                                       (20, 15, 4, 180)])
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


def _hall_problem(ns, Ht, Rr, Rh, nh, seed):
    """A hall-block stage from random feature-space covariances (every
    block a true covariance, F = 2 (Rr + Rh + Ht) features), with the hall
    rows past the fill masked as the agent masks empty slots: zero
    couplings, identity diagonal, zero targets."""
    rng = np.random.default_rng(seed)
    F = 2 * (Rr + Rh + Ht)
    P_r = rng.normal(size=(Rr, F)) / np.sqrt(F)
    P_h = rng.normal(size=(ns, Rh, F)) / np.sqrt(F)
    P_t = rng.normal(size=(ns, Ht, F)) / np.sqrt(F)
    m = (np.arange(Rh) < nh).astype(np.float64)
    L = np.linalg.cholesky(P_r @ P_r.T + 1e-3 * np.eye(Rr))
    Linv = np.linalg.inv(L)
    y_r = rng.normal(size=Rr) * 0.3
    Ahh = P_h @ np.swapaxes(P_h, 1, 2) + 1e-3 * np.eye(Rh)
    Ahh = m[:, None] * Ahh * m[None, :] + np.diag(1.0 - m)
    return dict(
        Kxr=P_t @ P_r.T, Kxh=(P_t @ np.swapaxes(P_h, 1, 2)) * m,
        Ktt=P_t @ np.swapaxes(P_t, 1, 2),
        Arh=np.einsum("rf,shf->srh", P_r, P_h) * m, Ahh=Ahh,
        yh=rng.normal(size=(ns, Rh)) * 0.3 * m,
        eps=np.clip(rng.normal(size=(ns, Ht)), -2.5, 2.5), Linv=Linv,
        w_r=Linv @ y_r, prior_var=np.full(Ht, 1.0))


@pytest.mark.parametrize("ns,H,ty,Rr,Rh,nh", [
    (8, 5, 3, 36, 45, 30),          # small, partly filled
    (20, 15, 4, 180, 240, 180),     # the car at its largest fill
])
def test_gp_hall_kernel_matches_plain(dev, ns, H, ty, Rr, Rh, nh):
    """The kernels against the plain version on the same float32 inputs:
    the kernel may be no farther from the float64 evaluation of the
    algorithm than four times the plain float32 evaluation (both cancel the
    same posterior variances in float32), and it must follow eps."""
    Ht = H * ty
    kw = _hall_problem(ns, Ht, Rr, Rh, nh, seed=ns)
    args = dict(jitter=1e-6, beta=2.5, var_zero=-1.0, rel_floor=1e-5, ty=ty)
    t = lambda dtype: {k: torch.as_tensor(v, dtype=dtype, device=dev)
                       .contiguous() for k, v in kw.items()}
    t32 = t(torch.float32)
    got = gp_hall.sample_hall_one(nh, **t32, **args)
    ref = gp_hall.sample_hall_plain(nh, **t32, **args)
    ex = gp_hall.sample_hall_plain(nh, **t(torch.float64), **args)
    mean = gp_hall.sample_hall_plain(
        nh, **dict(t32, eps=torch.zeros_like(t32["eps"])), **args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(ex.abs().max())
    err_k = float((got.double() - ex).abs().max())
    err_p = float((ref.double() - ex).abs().max())
    assert err_k <= 4 * err_p + 1e-6 * scale, (err_k, err_p)
    assert float((got - mean).abs().max()) > 100 * (err_k + 1e-7 * scale)


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


def _close(got, ref, tol):
    """assert_allclose at rtol = atol = tol (the JAX tests' bars)."""
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,n,m", [(64, 60, 8), (60, 180, 8),
                                   (12000, 50, 1)])
def test_linalg_kernels_match_plain(dev, B, n, m):
    """Kernels 5-7 against their plain versions on the same float32
    inputs: factors 2e-4, solves 3e-4 (tests/test_batch_linalg.py's
    bars), upper triangles exactly zero."""
    from sampling_gpmpc_torch.microbench_linalg import spd_inputs
    S, R = spd_inputs(B, n, m, dev, seed=B)
    L = batch_linalg.chol(S)
    _close(L, batch_linalg.chol_plain(S), 2e-4)
    assert bool((torch.triu(L, 1) == 0).all())
    for tr in (False, True):
        _close(batch_linalg.tri_solve(L, R, lower_factor_transposed=tr),
               batch_linalg.tri_solve_plain(L, R, tr), 3e-4)
    Lb = batched_chol.batched_cholesky(S, 0.1, use_kernel=True)
    _close(Lb, batched_chol.batched_cholesky_plain(S, 0.1), 2e-4)
    assert bool((torch.triu(Lb, 1) == 0).all())


def test_linalg_kernels_nan_pattern(dev):
    """A pivot that goes negative: each kernel's NaN entries are its plain
    version's, its finite entries agree."""
    from sampling_gpmpc_torch.microbench_linalg import spd_inputs
    S, _ = spd_inputs(8, 40, 1, dev)
    S[:, 11, 11] = -1.0
    for got, ref in ((batch_linalg.chol(S), batch_linalg.chol_plain(S)),
                     (batched_chol.batched_cholesky(S, use_kernel=True),
                      batched_chol.batched_cholesky_plain(S))):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        fin = torch.isfinite(ref)
        _close(got[fin], ref[fin], 2e-4)
