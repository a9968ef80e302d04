"""GP hyperparameter fitting by marginal-likelihood maximization.

Replaces the reference's GPyTorch Adam MLE scripts (ref: extra/mle_car.py,
mle_pendulum.py, mle_pendulum1D.py) with a ``torch.optim.Adam`` loop over
the masked-observation marginal likelihood of the derivative GP — the
fitted (lengthscale, outputscale, task noises) drop into the YAML config
fields Dyn_gp_lengthscale/outputscale/task_noises.  The parameters are the
logs of the hyperparameters, with the JAX package's initial values; Adam
runs with optax's defaults (betas 0.9/0.999, eps 1e-8 outside the square
root).  It runs on the device it is given (CUDA unless asked otherwise) in
the dtype of its inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.gp.exact import cholesky_nan
from sampling_gpmpc_torch.gp.kernel import kernel_matrix


def masked_nll(Z, Y, log_ls, log_os, log_noise, with_grad: bool):
    """Negative log marginal likelihood with NaN-masked observations.

    Args:
        Z: (M, D); Y: (M, Ty) with NaN for missing entries.
        log_ls: (D,); log_os: (); log_noise: (Ty,).
    """
    M, Ty = Y.shape
    y = Y.reshape(-1)
    m = (~torch.isnan(y)).to(Z.dtype)
    y = torch.nan_to_num(y)

    K = kernel_matrix(Z, Z, torch.exp(log_ls), torch.exp(log_os), with_grad)
    K = K + torch.diag(torch.exp(log_noise).repeat(M))
    Km = m[:, None] * K * m[None, :] + torch.diag(1.0 - m)
    L = cholesky_nan(
        Km + 1e-10 * torch.eye(Km.shape[0], dtype=Z.dtype, device=Z.device))
    alpha = torch.cholesky_solve((m * y)[:, None], L)[:, 0]
    # masked rows contribute log(1) = 0 to the determinant and 0 to the fit
    return (0.5 * torch.dot(m * y, alpha)
            + torch.sum(torch.log(torch.diagonal(L)))
            + 0.5 * torch.sum(m) * math.log(2 * math.pi))


def fit_gp_hyperparameters(Z, Y, with_grad: bool = True, iters: int = 300,
                           lr: float = 5e-2, init: Dict = None,
                           verbose: bool = False, device=None) -> Dict:
    """Fit one output's hyperparameters by Adam on the NLL.

    Args:
        Z: (M, D) inputs; Y: (M, Ty) observations (NaN-masked); numpy
            arrays or tensors, whose dtype the fit keeps.
    Returns:
        dict with lengthscale (D,), outputscale (), task_noises (Ty,),
        and the final nll (the loss of the last step's parameters before
        that step's update).
    """
    dev = setup.resolve_device(device)
    as_t = lambda a: (a.to(dev) if torch.is_tensor(a)
                      else torch.as_tensor(np.asarray(a), device=dev))
    Z, Y = as_t(Z), as_t(Y)
    dtype = Z.dtype
    D, Ty = Z.shape[1], Y.shape[1]
    init = init or {}
    p = lambda a: torch.log(torch.as_tensor(np.asarray(a, np.float64),
                                            dtype=dtype, device=dev)
                            ).requires_grad_(True)
    params = {
        "log_ls": p(init.get("lengthscale", np.ones(D))),
        "log_os": p(init.get("outputscale", 1.0)),
        "log_noise": p(init.get("task_noises", 1e-4 * np.ones(Ty))),
    }
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    for i in range(iters):
        opt.zero_grad()
        val = masked_nll(Z, Y, params["log_ls"], params["log_os"],
                         params["log_noise"], with_grad)
        val.backward()
        opt.step()
        if verbose and i % 50 == 0:
            print(f"iter {i}: nll {float(val):.4f}")

    host = lambda k: torch.exp(params[k].detach()).cpu().numpy()
    return {"lengthscale": host("log_ls"),
            "outputscale": float(host("log_os")),
            "task_noises": host("log_noise"), "nll": val.item()}


def fit_env_gp(env, spec, **kwargs) -> Tuple[list, list]:
    """Fit all g_ny outputs of an environment's prior training data."""
    X, Y = env.training_grid()
    return [fit_gp_hyperparameters(X, Y[j], **kwargs)
            for j in range(spec.g_ny)]
