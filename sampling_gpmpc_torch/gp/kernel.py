"""ARD-RBF kernels with derivative observations.

Closed forms for the value/gradient cross-covariances of
k(x,z) = s * exp(-0.5 * sum_d (x_d-z_d)^2 / l_d^2):

    cov(f(x), f(z))             = k
    cov(f(x), df(z)/dz_e)       =  k * (x_e-z_e)/l_e^2
    cov(df(x)/dx_d, f(z))       = -k * (x_d-z_d)/l_d^2
    cov(df(x)/dx_d, df(z)/dz_e) =  k * (I_de/l_d^2 - (x_d-z_d)(x_e-z_e)/(l_d^2 l_e^2))

Rows/columns are point-major: for each point the (1+D) tasks
[value, d/dx_1, ..., d/dx_D] are contiguous (GPyTorch's ordering, so the
epistemic base draws flatten identically).  Every function takes leading
batch dimensions on X and Z.
"""

from __future__ import annotations

import torch


def rbf(X: torch.Tensor, Z: torch.Tensor, lengthscale,
        outputscale) -> torch.Tensor:
    """Plain RBF kernel matrix. X: (..., N, D), Z: (..., M, D) -> (..., N, M)."""
    ls = torch.as_tensor(lengthscale, dtype=X.dtype, device=X.device)
    diff = (X[..., :, None, :] - Z[..., None, :, :]) / ls
    return outputscale * torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))


def rbf_grad(X: torch.Tensor, Z: torch.Tensor, lengthscale,
             outputscale) -> torch.Tensor:
    """Derivative-kernel matrix.

    Args:
        X: (..., N, D) left points; Z: (..., M, D) right points.
    Returns:
        (..., N*(1+D), M*(1+D)) covariance over [value, gradient] tasks,
        point-major.
    """
    N, D = X.shape[-2:]
    M = Z.shape[-2]
    ls = torch.as_tensor(lengthscale, dtype=X.dtype, device=X.device)
    inv_ls2 = 1.0 / (ls * ls)
    diff = X[..., :, None, :] - Z[..., None, :, :]            # (..., N, M, D)
    delta = diff * inv_ls2
    k = outputscale * torch.exp(-0.5 * torch.sum(diff * delta, dim=-1))
    top = torch.cat([k[..., None], k[..., None] * delta], dim=-1)  # (N,M,1+D)
    lg = -k[..., None] * delta                                # (N, M, D)
    # hess[n,m,d,e] = k (I_de/l_d^2 - delta_d delta_e)
    hess = k[..., None, None] * (
        torch.diag(inv_ls2) - delta[..., :, None] * delta[..., None, :])
    grad_rows = torch.cat([lg[..., None], hess], dim=-1)      # (N, M, D, 1+D)
    blk = torch.cat([top[..., None, :], grad_rows], dim=-2)   # (N,M,1+D,1+D)
    blk = blk.transpose(-3, -2)                               # (N,1+D,M,1+D)
    return blk.reshape(blk.shape[:-4] + (N * (1 + D), M * (1 + D)))


def kernel_matrix(X, Z, lengthscale, outputscale,
                  with_grad: bool) -> torch.Tensor:
    if with_grad:
        return rbf_grad(X, Z, lengthscale, outputscale)
    return rbf(X, Z, lengthscale, outputscale)
