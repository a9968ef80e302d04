"""Exact GP conditioning and pathwise sampling with derivative observations.

A frozen plain copy of the measured program's float64 GP body: ARD-RBF
kernels with value and gradient tasks (point-major), masked (NaN)
observations by the mask trick, the real-data factor, its block update by
hallucinated rows, and the sampling pipeline (pathwise draw, relative
variance floor, zero-variance points, clip to mean +/- beta std).
"""

from __future__ import annotations

import torch


def rbf_grad(X, Z, ls, os_):
    """(..., N(1+D), M(1+D)) covariance over [value, gradient] tasks."""
    N, D = X.shape[-2:]
    M = Z.shape[-2]
    inv_ls2 = 1.0 / (ls * ls)
    diff = X[..., :, None, :] - Z[..., None, :, :]
    delta = diff * inv_ls2
    k = os_ * torch.exp(-0.5 * torch.sum(diff * delta, dim=-1))
    top = torch.cat([k[..., None], k[..., None] * delta], dim=-1)
    lg = -k[..., None] * delta
    hess = k[..., None, None] * (torch.diag(inv_ls2)
                                 - delta[..., :, None] * delta[..., None, :])
    blk = torch.cat([top[..., None, :], torch.cat([lg[..., None], hess],
                                                  dim=-1)], dim=-2)
    blk = blk.transpose(-3, -2)
    return blk.reshape(blk.shape[:-4] + (N * (1 + D), M * (1 + D)))


def cholesky_nan(A):
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def safe_cholesky(A, jitter: float):
    """Cholesky with jitter max(jitter, dtype floor), escalating 10x per
    failure up to max(1e-3 mean diagonal, dtype cap), per matrix."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    mean_diag = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)
    floor, cap = (1e-6, 1e-2) if A.dtype == torch.float32 else (1e-14, 1e-4)
    j = torch.full(A.shape[:-2], max(jitter, floor), dtype=A.dtype,
                   device=A.device)
    cap = torch.clamp(1e-3 * mean_diag, min=cap)
    L = cholesky_nan(A + j[..., None, None] * eye)
    while True:
        retry = torch.isnan(L).any(-1).any(-1) & (j * 10.0 <= cap)
        if not bool(retry.any()):
            return L
        j = torch.where(retry, j * 10.0, j)
        L = torch.where(retry[..., None, None],
                        cholesky_nan(A + j[..., None, None] * eye), L)


def _tri(L, B, upper=False):
    return torch.linalg.solve_triangular(L, B, upper=upper)


def factor_real(Z, Y, ls, os_, noise_diag, jitter) -> dict:
    """Factor of the real data of one output: Z (M, D), Y (M, Ty)."""
    M, Ty = Y.shape
    y = Y.reshape(-1)
    m = (~torch.isnan(y)).to(Z.dtype)
    y = torch.nan_to_num(y) * m
    K = rbf_grad(Z, Z, ls, os_) + torch.diag(noise_diag.repeat(M))
    L = safe_cholesky(m[:, None] * K * m[None, :] + torch.diag(1.0 - m),
                      jitter)
    return {"L": L, "w": _tri(L, y[:, None])[:, 0], "mask": m}


def predict_real(Xt, Z, rf, ls, os_):
    """Posterior mean (..., Ht) and covariance from the real factor."""
    R = rf["L"].shape[-1]
    Kall = rbf_grad(Xt, torch.cat([Z.expand(Xt.shape[:-2] + Z.shape), Xt],
                                  dim=-2), ls, os_)
    V = _tri(rf["L"], (Kall[..., :R] * rf["mask"]).transpose(-1, -2))
    mean = (V.transpose(-1, -2) @ rf["w"][:, None])[..., 0]
    cov = Kall[..., R:] - V.transpose(-1, -2) @ V
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def predict_hall(Xt, Z, Zh, Yh, rf, ls, os_, noise_diag, jitter):
    """Posterior conditioned on the real data and hallucinated rows Zh
    (..., Mh, D), Yh (..., Mh, Ty) (NaN = empty), by the block Cholesky
    update of the real factor."""
    Mh, Ty = Yh.shape[-2:]
    y_h = Yh.reshape(Yh.shape[:-2] + (Mh * Ty,))
    m_h = (~torch.isnan(y_h)).to(Zh.dtype)
    y_h = torch.nan_to_num(y_h) * m_h
    m_r = rf["mask"]
    R_r = m_r.shape[-1]
    Zr = Z.expand(Zh.shape[:-2] + Z.shape)
    K_all = rbf_grad(torch.cat([Zr, Zh], dim=-2), Zh, ls, os_)
    A_rh = m_r[:, None] * K_all[..., :R_r, :] * m_h[..., None, :]
    K_hh = K_all[..., R_r:, :] + torch.diag(noise_diag.repeat(Mh))
    A_hh = (m_h[..., :, None] * K_hh * m_h[..., None, :]
            + torch.diag_embed(1.0 - m_h))
    C = _tri(rf["L"], A_rh)
    S = A_hh - C.transpose(-1, -2) @ C
    L_s = safe_cholesky(0.5 * (S + S.transpose(-1, -2)), jitter)
    w_h = _tri(L_s, (y_h - (C.transpose(-1, -2) @ rf["w"][:, None])[..., 0])
               [..., None])
    alpha_h = _tri(L_s.transpose(-1, -2), w_h, upper=True)
    alpha_r = _tri(rf["L"].T, rf["w"][:, None] - C @ alpha_h, upper=True)

    R_h = m_h.shape[-1]
    Kall = rbf_grad(Xt, torch.cat([Zr, Zh, Xt], dim=-2), ls, os_)
    Kx_r = Kall[..., :R_r] * m_r
    Kx_h = Kall[..., R_r:R_r + R_h] * m_h[..., None, :]
    mean = (Kx_r @ alpha_r + Kx_h @ alpha_h)[..., 0]
    V_r = _tri(rf["L"], Kx_r.transpose(-1, -2))
    V_h = _tri(L_s, Kx_h.transpose(-1, -2) - C.transpose(-1, -2) @ V_r)
    cov = (Kall[..., R_r + R_h:] - V_r.transpose(-1, -2) @ V_r
           - V_h.transpose(-1, -2) @ V_h)
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def prior_task_variances(ls, os_, Ty: int):
    """Prior variance of each task: os for the value, os / ls_d^2 for
    gradient d; (..., D) -> (..., Ty)."""
    o = torch.as_tensor(os_)[..., None]
    return torch.cat([o, o / (ls * ls)], dim=-1)[..., :Ty]


def sample(mean, cov, eps, H: int, Ty: int, beta: float, jitter: float,
           variance_is_zero: float, prior_var):
    """Pathwise draw mean + chol(cov) eps -> relative variance floor ->
    zero-variance points to the mean -> clip to mean +/- beta std ->
    non-finite entries to the mean; (..., H, Ty)."""
    shape = mean.shape[:-1] + (H, Ty)
    L = safe_cholesky(cov, jitter)
    y = (mean + (L @ eps[..., None])[..., 0]).reshape(shape)
    mu = mean.reshape(shape)
    var = torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                      min=0.0).reshape(shape)
    rel = 1e-5 if mean.dtype == torch.float32 else 1e-12
    var = torch.where(var < rel * prior_var, torch.zeros_like(var), var)
    if variance_is_zero >= 0.0:
        y = torch.where(torch.all(var <= variance_is_zero, dim=-1,
                                  keepdim=True), mu, y)
    std = torch.sqrt(var)
    y = torch.minimum(torch.maximum(y, mu - beta * std), mu + beta * std)
    return torch.where(torch.isfinite(y), y, mu)
