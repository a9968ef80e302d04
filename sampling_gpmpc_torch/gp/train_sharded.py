"""Train-axis-sharded exact GP posterior.

Counterpart of ``sampling_gpmpc_tpu/gp/train_sharded.py`` (the reference's
multi-GPU kernel-sharding experiment, ref: extra/multi_gpu.py:64-66).  When
a GP conditioning set outgrows one device, the TRAINING-POINT axis is
sharded over a group and no rank ever holds the full kernel matrix:

  * each rank holds its point block ``Z_i`` (with its observation rows;
    the query points ``X`` are small and replicated),
  * the matvec ``w_i = K(Z_i, Z) v + noise_i v_i`` uses only the rank's
    (R/p, R) row block of the kernel matrix, with the search direction
    all-gathered,
  * conjugate gradients run on row-sharded vectors; the two dot products
    per iteration are psums,
  * the posterior mean ``K(X, Z) alpha`` and the covariance correction
    ``K(X, Z) K^-1 K(Z, X)`` are psums of shard-local products.

One CG runs per right-hand side (the observations and each query row of
``K(Z, X)``), batched over the columns with a per-column stopping rule:
a column that has converged is frozen, so each column's iterates are those
of its own CG.  Derivative-observation kernels reuse ``gp/kernel.py``'s
point-major task layout, so observation rows shard in point blocks too.
"""

from __future__ import annotations

import torch

from sampling_gpmpc_torch import obs
from sampling_gpmpc_torch.gp.kernel import kernel_matrix
from sampling_gpmpc_torch.parallel.collectives import (all_gather,
                                                       group_rank,
                                                       make_reducers)


def _cg(matvec, gather, B_loc, psum, tol, max_iter):
    """Column-batched CG on row-sharded right-hand sides B_loc (n_loc, C):
    each column stops when its residual norm falls to ``tol`` or after
    ``max_iter`` iterations.  Returns (X_loc, iterations per column)."""
    pdot = lambda a, b: psum(torch.sum(a * b, dim=0))  # noqa: E731
    X = torch.zeros_like(B_loc)
    R = B_loc.clone()
    P = B_loc.clone()
    rs = pdot(R, R)
    its = torch.zeros(B_loc.shape[1], dtype=torch.int64,
                      device=B_loc.device)
    for _ in range(max_iter):
        live = rs > tol * tol              # replicated: rs is psum-ed
        obs.count(obs.SYNCS, "train_sharded._cg:live", tally=False)
        if not bool(live.any()):
            break
        AP = matvec(gather(P))
        alpha = torch.where(live, rs / pdot(P, AP), 0.0)
        X = X + alpha * P
        R = R - alpha * AP
        rs_new = pdot(R, R)
        beta = torch.where(live, rs_new / torch.where(live, rs, 1.0), 0.0)
        P = torch.where(live, R + beta * P, P)
        rs = torch.where(live, rs_new, rs)
        its = its + live
    return X, its


def sharded_posterior_fn(group, lengthscale, outputscale, with_grad: bool,
                         tol: float = 1e-10, max_iter: int = 1000):
    """The train-axis-sharded posterior over ``group`` (None: one device;
    a ``torch.distributed`` group or a ``BlockGroup``, each rank calling
    the returned function inside its block).

    Returns ``f(Z_loc, y_loc, noise_loc, X) -> (mean, cov)``:
        Z_loc (R_pts / p, D)  this rank's block of training inputs,
        y_loc (R_rows / p,)   its observation rows (point-major tasks),
        noise_loc (R_rows / p,) their observation noise,
        X (M, D)              the query points (replicated),
    with mean (M_rows,) and the symmetrised cov (M_rows, M_rows),
    replicated.
    """
    psum = make_reducers(group)[0]

    def f(Z_loc, y_loc, noise_loc, X):
        Z_full = torch.cat(all_gather(Z_loc.contiguous(), group), dim=0)
        n_loc = y_loc.shape[0]
        lo = group_rank(group) * n_loc
        K_loc = kernel_matrix(Z_loc, Z_full, lengthscale, outputscale,
                              with_grad)                   # (n_loc, R)

        def matvec(V_full):
            return K_loc @ V_full + noise_loc[:, None] * V_full[lo:lo + n_loc]

        def gather(V_loc):
            return torch.cat(all_gather(V_loc.contiguous(), group), dim=0)

        K_xz_loc = kernel_matrix(X, Z_loc, lengthscale, outputscale,
                                 with_grad)                # (M_rows, n_loc)
        # column 0: the observations; 1..: K(Z, x_j) for each query row
        S_loc, _ = _cg(matvec, gather,
                       torch.cat([y_loc[:, None], K_xz_loc.T], dim=1), psum,
                       tol, max_iter)
        mean, corr = psum((K_xz_loc @ S_loc[:, 0], K_xz_loc @ S_loc[:, 1:]))
        cov = kernel_matrix(X, X, lengthscale, outputscale, with_grad) - corr
        return mean, 0.5 * (cov + cov.T)

    return f
