"""Finite-sample-theory calculators, in float64.

Re-derivation of extra/compute_num_samples/helper.py on the port's GP
core: RKHS norm of the posterior mean, information-gain beta, and the
small-ball probability / epsilon(N) quantities of the finite-sample
reachability theory — the empirical probability that a GP function sample
stays within eps of the posterior mean uniformly over a grid, and the
quantile eps achieving a target probability.

Every function runs on the device it is given (CUDA unless asked
otherwise), except the posterior factor on the small-ball grid, formed on
the host so that every device draws through the same one
(:func:`_grid_factor`).  The draws are standard normals from an explicit
``torch.Generator`` on the device, or the caller's own (``eps=``): the
JAX package's ``jax.random`` stream cannot be reproduced.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.gp.kernel import rbf

F64 = torch.float64
CHUNK = 8192


def _t(a, dev):
    if torch.is_tensor(a):
        return a.to(device=dev, dtype=F64)
    return torch.as_tensor(np.array(a, np.float64), dtype=F64, device=dev)


def _gram(Z, lengthscale, outputscale, lam, dev):
    """(K + lam I, K) on the training inputs."""
    Z = _t(Z, dev)
    K = rbf(Z, Z, _t(lengthscale, dev), outputscale)
    return K + lam * torch.eye(K.shape[0], dtype=F64, device=dev), K


def rkhs_norm(Z, y, lengthscale, outputscale, lam, device=None) -> float:
    """||mu||_k^2 = y'(K + lam I)^-1 y (ref: helper.py:39-87)."""
    dev = setup.resolve_device(device)
    A, _ = _gram(Z, lengthscale, outputscale, lam, dev)
    y = _t(y, dev)
    return float(torch.dot(y, torch.linalg.solve(A, y)))


def info_beta(Z, lengthscale, outputscale, lam, delta_term=9.21,
              device=None) -> float:
    """Information-gain confidence multiplier
    sqrt(logdet(K/lam + I) + 2 log(1/delta)) (ref: helper.py:81-82)."""
    dev = setup.resolve_device(device)
    _, K = _gram(Z, lengthscale, outputscale, lam, dev)
    _, logdet = torch.linalg.slogdet(
        K / lam + torch.eye(K.shape[0], dtype=F64, device=dev))
    return float(torch.sqrt(logdet + delta_term))


def _posterior_on_grid(Z, y, grid, lengthscale, outputscale, lam, dev):
    ls = _t(lengthscale, dev)
    Z, y, grid = _t(Z, dev), _t(y, dev), _t(grid, dev)
    K = rbf(Z, Z, ls, outputscale)
    L = torch.linalg.cholesky(
        K + lam * torch.eye(K.shape[0], dtype=F64, device=dev))
    Kx = rbf(grid, Z, ls, outputscale)
    mean = Kx @ torch.cholesky_solve(y[:, None], L)[:, 0]
    V = torch.linalg.solve_triangular(L, Kx.T, upper=False)
    cov = rbf(grid, grid, ls, outputscale) - V.T @ V
    return mean, 0.5 * (cov + cov.T)


def _psd_factor(cov):
    """F with cov = F F^T via eigendecomposition, clipping the tiny negative
    eigenvalues a near-singular posterior produces (dense grids make the
    covariance rank-deficient — the reference hits the same wall and calls
    it "N_max = 8, maximum such that matrix is still psd"; clipping is the
    exact PSD projection and never NaNs).

    Through LAPACK's divide and conquer (scipy's, the JAX package's own),
    on the host: see :func:`_grid_factor`.
    """
    w, V = scipy.linalg.eigh(cov.cpu().numpy(), driver="evd")
    F = V * np.sqrt(np.clip(w, 0.0, None))[None, :]
    return torch.as_tensor(F, dtype=F64, device=cov.device)


def _grid_factor(Z, y, grid, lengthscale, outputscale, lam, dev):
    """The posterior covariance factor on the grid, formed on the host in
    float64 and moved to ``dev``, where the draws run.

    The grid covariance is a difference of O(outputscale) terms that
    leaves ~1e-6 (the noise level), so two evaluations that differ in the
    last bit of the kernel sums differ ~1e-10 relatively in the
    covariance, and the eigenvectors of its near-null space (eigenvalues
    down to 1e-17 at n_grid = 8) rotate with it; LAPACK eigensolvers also
    differ in the eigenvectors' signs (torch's CPU one from scipy's by
    1.5e-3 in F at n_grid = 3 on params_pendulum1D_samples).  A draw's
    deviation moves with all of these, so every device draws through this
    one host factor; it is at most (G, G), G the grid size, and the draws
    are the work.
    """
    _, cov = _posterior_on_grid(Z, y, grid, lengthscale, outputscale, lam,
                                torch.device("cpu"))
    return _psd_factor(cov).to(dev)


def _deviations(F, eps):
    """Sup-norm over the grid of each draw eps @ F^T."""
    return torch.max(torch.abs(eps @ F.T), dim=1).values


def _normals(generator, n, G, dev):
    return torch.randn((n, G), generator=generator, dtype=F64, device=dev)


def _generator(generator, seed, dev):
    if generator is not None:
        return generator
    return torch.Generator(device=dev).manual_seed(seed)


def max_deviation_samples(Z, y, grid, lengthscale, outputscale, lam,
                          n_samples, generator=None, eps=None,
                          device=None) -> np.ndarray:
    """Per-sample sup-norm deviation of GP draws from the posterior mean.

    Args:
        generator: torch.Generator on the device for the draws (seed 0
            when absent); ``eps``: the caller's (n_samples, G) standard
            normals instead.
    """
    dev = setup.resolve_device(device)
    F = _grid_factor(Z, y, grid, lengthscale, outputscale, lam, dev)
    if eps is None:
        eps = _normals(_generator(generator, 0, dev), n_samples, F.shape[0],
                       dev)
    return _deviations(F, _t(eps, dev)[:n_samples]).cpu().numpy()


def small_ball_probability(Z, y, grid, lengthscale, outputscale, lam, eps,
                           n_samples=2000, generator=None, draws=None,
                           device=None) -> float:
    """P(sup_grid |f - mu| <= eps) estimated over posterior draws
    (ref: helper.py:116-245); ``draws`` as ``max_deviation_samples``'s
    ``eps``."""
    dev = max_deviation_samples(Z, y, grid, lengthscale, outputscale, lam,
                                n_samples, generator, draws, device)
    return float(np.mean(dev <= eps))


def epsilon_for_probability(Z, y, grid, lengthscale, outputscale, lam, prob,
                            n_samples=2000, generator=None, draws=None,
                            device=None) -> float:
    """Quantile eps(N): smallest eps with small-ball probability >= prob
    (ref: helper.py:368-469)."""
    dev = max_deviation_samples(Z, y, grid, lengthscale, outputscale, lam,
                                n_samples, generator, draws, device)
    return float(np.quantile(dev, prob))


def num_samples_for_coverage(p_ball: float, delta: float = 0.05) -> int:
    """Samples N with P(at least one draw in the eps-ball) >= 1 - delta:
    N >= log(delta) / log(1 - p_ball)."""
    if p_ball <= 0:
        return np.iinfo(np.int64).max
    if p_ball >= 1:
        return 1
    return int(np.ceil(np.log(delta) / np.log(1.0 - p_ball)))


# ---------------------------------------------------------------------------
# Change-of-measure constant C_D and the full N(delta) pipeline
# (ref: extra/compute_num_samples/num_of_samples.py:36-73, helper.py:90-117)


def posterior_mean_at_train(Z, y, lengthscale, outputscale, lam,
                            device=None) -> np.ndarray:
    """GP posterior mean evaluated AT the training inputs."""
    dev = setup.resolve_device(device)
    A, K = _gram(Z, lengthscale, outputscale, lam, dev)
    return (K @ torch.linalg.solve(A, _t(y, dev))).cpu().numpy()


def posterior_norm_diff(Z, y, lengthscale, outputscale, lam, lam_total,
                        w_bound, device=None) -> float:
    """sum_i (|mu(z_i) - y_i| + w_bound)^2 / lam_total — the data-fit term
    of the change-of-measure exponent (ref: helper.py:90-117)."""
    mu = posterior_mean_at_train(Z, y, lengthscale, outputscale, lam, device)
    diff = np.abs(mu - np.asarray(y, np.float64))
    return float(np.sum((diff + w_bound) ** 2) / lam_total)


def change_of_measure_cd(Z, y, Z_dense, y_dense, lengthscale, outputscale,
                         lam, lam_total, w_bound, device=None) -> dict:
    """The exponent C_D of the measure shift between the GP prior centered
    at the posterior mean and the true-function small ball: samples drawn
    from the N-point posterior land in the eps-ball around the TRUE function
    with probability >= exp(-C_D) * B_phi (ref: num_of_samples.py:36-56).

    ``(Z_dense, y_dense)`` is a denser evaluation of the same function used
    as the finite-data stand-in for the true RKHS norm ||f||^2 (the
    reference uses a 10x-denser training grid, num_of_samples.py:31-37).

    Returns a dict with every term so tools can report them individually.
    """
    dev = setup.resolve_device(device)
    A, _ = _gram(Z, lengthscale, outputscale, lam, dev)
    yt = _t(y, dev)
    alpha = torch.linalg.solve(A, yt)
    mean_norm = float(yt @ alpha)
    true_norm = rkhs_norm(Z_dense, y_dense, lengthscale, outputscale, lam,
                          dev)
    cross = float(2.0 * (yt @ alpha))
    l1 = float(torch.sum(torch.abs(alpha)))
    fit = posterior_norm_diff(Z, y, lengthscale, outputscale, lam,
                              lam_total, w_bound, dev)
    cd = true_norm + mean_norm - cross + l1 * w_bound + 0.5 * fit
    return {"Cd": cd, "true_norm": true_norm, "mean_norm": mean_norm,
            "cross": cross, "alpha_l1": l1, "fit_term": fit}


def num_samples_with_measure_shift(Cd: float, p_ball: float,
                                   delta: float = 0.001) -> float:
    """N(delta) = log(delta) / log(1 - exp(-Cd) * B_phi): dynamics samples
    so that with prob >= 1-delta at least one GP function-sample is
    uniformly eps-close to the true dynamics (ref: num_of_samples.py:69)."""
    p_eff = float(np.exp(-Cd) * p_ball)
    if p_eff <= 0.0:
        return float("inf")
    if p_eff >= 1.0:
        return 1.0
    return float(np.log(delta) / np.log(1.0 - p_eff))


def gp_input_grid(spec, data, n_grid: int) -> np.ndarray:
    """Tensor grid over the GP input box: the [x_min,x_max]x[u_min,u_max]
    ranges restricted to ``g_idx_inputs`` (ref: helper.py:171-210 builds
    exactly these per-env ranges by hand; here the env protocol's input
    filter makes it generic)."""
    lo_full = np.concatenate([data.x_min, data.u_min])
    hi_full = np.concatenate([data.x_max, data.u_max])
    idx = np.asarray(spec.g_idx_inputs)
    axes = [np.linspace(lo_full[i], hi_full[i], n_grid) for i in idx]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


def max_deviation_samples_chunked(Z, y, grid, lengthscale, outputscale, lam,
                                  n_samples, generator=None,
                                  chunk: int = CHUNK, eps=None,
                                  device=None) -> np.ndarray:
    """Per-draw sup-norm deviations, drawn in chunks so millions of draws
    never materialize at once (the reference draws 1e6-1e7 at once on a
    24 GB GPU, helper.py:228-233; here only (chunk, G) lives on the device
    per step).  ``eps``: the caller's (n_samples, G) standard normals
    instead of the generator's."""
    dev = setup.resolve_device(device)
    F = _grid_factor(Z, y, grid, lengthscale, outputscale, lam, dev)
    G = F.shape[0]
    gen = None if eps is not None else _generator(generator, 0, dev)
    out = []
    for c in range(0, n_samples, chunk):
        n = min(chunk, n_samples - c)
        e = (_t(eps[c:c + n], dev) if eps is not None
             else _normals(gen, n, G, dev))
        out.append(_deviations(F, e))
    return torch.cat(out).cpu().numpy()
