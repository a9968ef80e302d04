"""Batched exact GP conditioning with masked (NaN) observations.

Missing observations are handled by the mask trick

    K~ = m m^T ⊙ (K + Σ_noise) + diag(1 - m),    y~ = m ⊙ y

which leaves masked rows with zero posterior influence at a static shape.
The real training data never changes during an experiment, so its factor is
computed once (``factor_real``); SQP iteration 0 predicts from that factor
alone (``predict_real``), and later iterations append each sample's
hallucinated rows by a block Cholesky update (``condition_update``,
``predict_update``); both draw with ``sample_with_overrides``.  This is the
float64/CPU reference path; the float32 CUDA path runs the fused kernels of
``ops/gp_sample.py`` and ``ops/gp_hall.py`` instead.  Forward sampling
(``reachability.py``) extends a w-form block factor by one point per step
(``append_rows_update``) and predicts from it (``predict_from_w``), in plain
torch on both devices.  Functions accept leading batch dimensions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sampling_gpmpc_torch.gp.kernel import kernel_matrix


@dataclasses.dataclass(frozen=True)
class GPHyperArrays:
    """Per-output hyperparameters as tensors."""

    lengthscale: torch.Tensor   # (g_ny, D)
    outputscale: torch.Tensor   # (g_ny,)
    noise_diag: torch.Tensor    # (Ty,) per-task observation noise (incl. global)
    jitter: float
    beta: float
    variance_is_zero: float
    min_data_dist: float

    @classmethod
    def from_spec(cls, gp, device, dtype):
        tn = np.asarray(gp.task_noises, dtype=np.float64) + gp.noise
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                      device=device)
        return cls(lengthscale=f(gp.lengthscale), outputscale=f(gp.outputscale),
                   noise_diag=f(tn), jitter=gp.jitter, beta=gp.beta,
                   variance_is_zero=gp.variance_is_zero,
                   min_data_dist=gp.min_data_dist)


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a matrix that is not positive definite gets an
    all-NaN factor (the JAX convention the callers test for)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def safe_cholesky(A: torch.Tensor, jitter: float) -> torch.Tensor:
    """Cholesky with escalating-jitter retries (psd_safe_cholesky analog).

    The first attempt uses max(configured jitter, dtype floor); a failed
    factorization retries with 10x the jitter while that stays within
    max(1e-3 * mean diagonal, dtype cap).  Batched: every matrix escalates
    on its own.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    mean_diag = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)
    if A.dtype == torch.float32:
        floor, cap = 1e-6, 1e-2
    else:
        floor, cap = 1e-14, 1e-4
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


def solve_tri_shared(L, R, upper: bool = False, refine: bool = False):
    """L X = R (or L' X = R when ``upper``) for ONE lower factor L (n, n)
    and R (..., n, m): the batch folds into the columns of a single
    (n, batch * m) solve, so L is never broadcast over the batch.  With
    ``refine`` one step of iterative refinement follows (see
    ``_solve_refined``), its residual taken in the folded layout."""
    n = L.shape[-1]
    Rf = R if R.ndim == 2 else R.movedim(-2, 0).reshape(n, -1)
    A = L.transpose(-1, -2) if upper else L
    X = torch.linalg.solve_triangular(A, Rf, upper=upper)
    if refine:
        X = X + torch.linalg.solve_triangular(A, Rf - A @ X, upper=upper)
    if R.ndim == 2:
        return X
    return X.reshape((n,) + R.shape[:-2] + R.shape[-1:]).movedim(0, -2)


def _solve(L, B, upper: bool = False):
    """L X = B (or L' X = B when ``upper``) for lower factors L; a 2-D L
    is one factor shared by every batch entry of B."""
    if L.ndim == 2:
        return solve_tri_shared(L, B, upper)
    return _tri(L.transpose(-1, -2) if upper else L, B, upper=upper)


def _solve_refined(L, B, upper: bool = False):
    """Triangular solve + one step of iterative refinement.

    A float32 solve against an ill-conditioned factor carries relative
    error ~eps*cond(L); one refinement step (its residual has no
    cancellation, so it is float32-accurate) brings the error back to
    ~eps, which keeps the posterior-variance subtraction Ktt - V'V of the
    forward-sampling rollout below the true-variance scale at beta = 30.
    """
    if L.ndim == 2:
        return solve_tri_shared(L, B, upper, refine=True)
    A = L.transpose(-1, -2) if upper else L
    x = _tri(A, B, upper=upper)
    return x + _tri(A, B - A @ x, upper=upper)


def factor_real(Z_r, Y_r, hyp_ls, hyp_os, noise_diag, jitter,
                with_grad: bool) -> dict:
    """Factor the fixed real-data block for one output.

    Args:
        Z_r: (M, D) train inputs; Y_r: (M, Ty) observations (NaN = masked).
    Returns dict with L (R, R), w = L^-1 y~, mask (R,), Linv = L^-1 and
    alpha = K~^-1 y~ — the last two feed the fused GP kernel.
    """
    M, Ty = Y_r.shape
    y = Y_r.reshape(-1)
    m = (~torch.isnan(y)).to(Z_r.dtype)
    y = torch.nan_to_num(y) * m
    K = kernel_matrix(Z_r, Z_r, hyp_ls, hyp_os, with_grad and Ty > 1)
    K = K + torch.diag(noise_diag.repeat(M))
    A = m[:, None] * K * m[None, :] + torch.diag(1.0 - m)
    L = safe_cholesky(A, jitter)
    w = _tri(L, y[:, None])[:, 0]
    Linv = _tri(L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device))
    alpha = _tri(L.T, w[:, None], upper=True)[:, 0]
    return {"L": L, "w": w, "mask": m, "Linv": Linv, "alpha": alpha}


def predict_real(Xt, Z_r, rf, hyp_ls, hyp_os, with_grad: bool):
    """Joint posterior from the real-data factor only (empty hall buffer).

    Args:
        Xt: (..., H, D) test points; Z_r: (M, D); rf: one output's factor.
    Returns:
        mean (..., Ht), cov (..., Ht, Ht), point-major.
    """
    R = rf["L"].shape[-1]
    Zb = Z_r.expand(Xt.shape[:-2] + Z_r.shape)
    Kall = kernel_matrix(Xt, torch.cat([Zb, Xt], dim=-2), hyp_ls, hyp_os,
                         with_grad)
    Kx = Kall[..., :R] * rf["mask"]
    Ktt = Kall[..., R:]
    V = _tri(rf["L"], Kx.transpose(-1, -2))                  # (..., R, Ht)
    mean = (V.transpose(-1, -2) @ rf["w"][:, None])[..., 0]
    cov = Ktt - V.transpose(-1, -2) @ V
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def condition_update(rf, Z_r, Z_h, Y_h, hyp_ls, hyp_os, noise_diag, jitter,
                     with_grad: bool) -> dict:
    """Append hallucination rows to the real-data factor (block Cholesky).

    With A = [[A_rr, A_rh], [A_hr, A_hh]] the masked train covariance, the
    factor is L = [[L_r, 0], [C', L_s]] with C = L_r^-1 A_rh and
    L_s = chol(A_hh - C'C); only the (R_h, R_h) Schur block is factorized.

    Args:
        rf: one output's real factor; Z_r: (M_r, D).
        Z_h: (..., M_h, D), Y_h: (..., M_h, Ty) hallucinated rows (NaN =
            masked), with any leading batch dimensions.
    Returns dict with C (..., R_r, R_h), L_s, alpha_r, alpha_h (the split
    K~^-1 y~), w_h = L_s^-1 (y~_h - C' w_r) and mask_h.
    """
    Mh, Ty = Y_h.shape[-2:]
    y_h = Y_h.reshape(Y_h.shape[:-2] + (Mh * Ty,))
    m_h = (~torch.isnan(y_h)).to(Z_h.dtype)
    y_h = torch.nan_to_num(y_h) * m_h
    m_r = rf["mask"]
    R_r = m_r.shape[-1]
    Zr = Z_r.expand(Z_h.shape[:-2] + Z_r.shape)
    K_all = kernel_matrix(torch.cat([Zr, Z_h], dim=-2), Z_h, hyp_ls, hyp_os,
                          with_grad and Ty > 1)
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
    return {"C": C, "L_s": L_s, "alpha_r": alpha_r[..., 0],
            "alpha_h": alpha_h[..., 0], "w_h": w_h[..., 0], "mask_h": m_h}


def predict_update(Xt, Z_r, Z_h, rf, uf, hyp_ls, hyp_os, with_grad: bool):
    """Joint posterior from the block factorization of ``condition_update``.

    mean = Kx alpha; cov = Ktt - V_r'V_r - V_h'V_h with
    V_r = L_r^-1 (Kx_r ⊙ m_r)',  V_h = L_s^-1 ((Kx_h ⊙ m_h)' - C'V_r).
    All three kernel blocks come from one evaluation against [Z_r; Z_h; Xt].

    Args:
        Xt: (..., H, D); Z_h: (..., M_h, D); uf: batched like Xt.
    Returns:
        mean (..., Ht), cov (..., Ht, Ht).
    """
    R_r = rf["mask"].shape[-1]
    R_h = uf["mask_h"].shape[-1]
    Zr = Z_r.expand(Xt.shape[:-2] + Z_r.shape)
    Kall = kernel_matrix(Xt, torch.cat([Zr, Z_h, Xt], dim=-2), hyp_ls,
                         hyp_os, with_grad)
    Kx_r = Kall[..., :R_r] * rf["mask"]
    Kx_h = Kall[..., R_r:R_r + R_h] * uf["mask_h"][..., None, :]
    Ktt = Kall[..., R_r + R_h:]
    mean = ((Kx_r @ uf["alpha_r"][..., None])
            + (Kx_h @ uf["alpha_h"][..., None]))[..., 0]
    V_r = _tri(rf["L"], Kx_r.transpose(-1, -2))
    V_h = _tri(uf["L_s"], Kx_h.transpose(-1, -2)
               - uf["C"].transpose(-1, -2) @ V_r)
    cov = (Ktt - V_r.transpose(-1, -2) @ V_r
           - V_h.transpose(-1, -2) @ V_h)
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def posterior_sample(mean, cov, eps, jitter):
    """Pathwise joint sample: mean + chol(cov) @ eps (ref: agent.py:641)."""
    L = safe_cholesky(cov, jitter)
    return mean + (L @ eps[..., None])[..., 0]


def prior_task_variances(hyp_ls, hyp_os, Ty: int) -> torch.Tensor:
    """Prior variance of each task: ``outputscale`` for the value and
    ``outputscale / ls_d**2`` for gradient d; (..., D) -> (..., Ty)."""
    os_ = torch.as_tensor(hyp_os)[..., None]
    return torch.cat([os_, os_ / (hyp_ls * hyp_ls)], dim=-1)[..., :Ty]


def sample_with_overrides(Xt, Z, Y, mean, cov, eps, hyp: GPHyperArrays,
                          Ty_test: int, prior_var=None, dist=None):
    """Sampling pipeline of the reference's ``sample_gp``
    (ref: src/agent.py:629-730), batched over leading dimensions.

    Order (must match for parity): pathwise sample -> relative variance
    floor -> zero-variance points to the mean -> min-dist points copy the
    nearest train observation -> clip to mean ± beta*std -> non-finite
    entries to the mean.

    Args:
        Xt: (..., H, D); Z: (..., M, D); Y: (..., M, Ty) train data.
        mean (..., Ht), cov (..., Ht, Ht), eps (..., Ht).
        prior_var: optional (Ty_test,) prior task variances; posterior
            variances below the dtype's cancellation floor relative to it
            count as exactly zero.
        dist: optional precomputed (..., H, M) ||Xt - Z||.
    Returns:
        (..., H, Ty_test) sampled values(+gradients).
    """
    H = Xt.shape[-2]
    shape = mean.shape[:-1] + (H, Ty_test)
    y = posterior_sample(mean, cov, eps, hyp.jitter).reshape(shape)
    mu = mean.reshape(shape)
    var = torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=0.0)
    var = var.reshape(shape)
    if prior_var is not None:
        rel = 1e-5 if mean.dtype == torch.float32 else 1e-12
        var = torch.where(var < rel * prior_var, torch.zeros_like(var), var)
    if hyp.variance_is_zero >= 0.0:
        all_zero = torch.all(var <= hyp.variance_is_zero, dim=-1, keepdim=True)
        y = torch.where(all_zero, mu, y)
    if hyp.min_data_dist >= 0.0:
        if dist is None:
            dist = torch.linalg.norm(
                Xt[..., :, None, :] - Z[..., None, :, :], dim=-1)
        row_invalid = torch.isnan(Y).any(-1)                      # (..., M)
        dist = torch.where(row_invalid[..., None, :],
                           torch.full_like(dist, float("inf")), dist)
        close = torch.any(dist <= hyp.min_data_dist, dim=-1, keepdim=True)
        nearest = torch.argmin(dist, dim=-1)                      # (..., H)
        y = torch.where(close, torch.take_along_dim(
            Y, nearest[..., None], dim=-2), y)
    std = torch.sqrt(var)
    y = torch.minimum(torch.maximum(y, mu - hyp.beta * std),
                      mu + hyp.beta * std)
    return torch.where(torch.isfinite(y), y, mu)


def predict_from_w(Xt, Z_r, Z_h, rf, uf, hyp_ls, hyp_os, with_grad: bool,
                   refine: bool = False):
    """Joint posterior from the w-form block factorization.

    The math of :func:`predict_update`, with the alphas recovered from
    (w_r, w_h) by two capacity-sized back-substitutions, so the
    incremental-append rollout does no O(R^3) work.  ``refine=True``
    applies one iterative-refinement step to every triangular solve
    (needed in float32 at the forward-sampling workload's beta = 30).

    Args:
        Xt: (..., P, D); Z_r: (M_r, D); Z_h: (..., M_h, D).
        rf: one output's real factor; uf: {"C", "L_s", "w_h", "mask_h"}
            with the leading dimensions of Xt.
    Returns:
        mean (..., Ht), cov (..., Ht, Ht).
    """
    solve = _solve_refined if refine else _solve
    alpha_h = solve(uf["L_s"], uf["w_h"][..., None], True)
    alpha_r = solve(rf["L"], rf["w"][:, None] - uf["C"] @ alpha_h, True)
    R_r = rf["mask"].shape[-1]
    R_h = uf["mask_h"].shape[-1]
    Zr = Z_r.expand(Xt.shape[:-2] + Z_r.shape)
    Kall = kernel_matrix(Xt, torch.cat([Zr, Z_h, Xt], dim=-2), hyp_ls,
                         hyp_os, with_grad)
    Kx_r = Kall[..., :R_r] * rf["mask"]
    Kx_h = Kall[..., R_r:R_r + R_h] * uf["mask_h"][..., None, :]
    Ktt = Kall[..., R_r + R_h:]
    mean = (Kx_r @ alpha_r + Kx_h @ alpha_h)[..., 0]
    V_r = solve(rf["L"], Kx_r.transpose(-1, -2))
    V_h = solve(uf["L_s"], Kx_h.transpose(-1, -2)
                - uf["C"].transpose(-1, -2) @ V_r)
    cov = (Ktt - V_r.transpose(-1, -2) @ V_r
           - V_h.transpose(-1, -2) @ V_h)
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def append_rows_update(rf, uf, Z_r, Z_h, z_new, y_new, pos: int, hyp_ls,
                       hyp_os, noise_diag, jitter, with_grad: bool,
                       refine: bool = False) -> dict:
    """Rank-Ty append of ONE new conditioning point to a block factor.

    The O(t^2)-per-step path of iterative-conditioning rollouts: instead
    of refactorizing the hallucination Schur block, extend the factor by
    the new point's k = Ty rows:

        C   <- [C, c],   c = L_r^-1 A_r,new
        L_s <- [[L_s, 0], [b', D]],  b = L_s^-1 (A_h,new - C'c)
        D   = chol(A_new,new - c'c - b'b)
        w_h <- [w_h, D^-1 (y~_new - c'w_r - b'w_h)]

    Empty buffer slots are identity rows of L_s with zero C / w_h / mask
    entries, so the result equals :func:`condition_update` of the filled
    buffer.  The new rows are written into ``uf``'s tensors in place (the
    JAX package builds new arrays with dynamic_update_slice).

    Args:
        rf: one output's real factor; uf: {"C", "L_s", "w_h", "mask_h"}
            with leading batch dimensions (...).
        Z_h: (..., M_h, D); z_new: (..., 1, D); y_new: (..., 1, Ty) (NaN =
            masked task, e.g. value-only rollout observations).
        pos: row offset (filled slots * Ty) of the new rows.
    Returns:
        the updated ``uf`` (no alphas: predict with :func:`predict_from_w`).
    """
    Ty = y_new.shape[-1]
    grad = with_grad and Ty > 1
    y = y_new.reshape(y_new.shape[:-2] + (Ty,))
    m_new = (~torch.isnan(y)).to(z_new.dtype)
    y = torch.nan_to_num(y) * m_new
    m_r = rf["mask"]
    R_r = m_r.shape[-1]
    R_h = uf["mask_h"].shape[-1]
    Zr = Z_r.expand(z_new.shape[:-2] + Z_r.shape)
    # one kernel evaluation for the real, hall and new-point blocks (the
    # closed forms are elementwise per pair of points)
    K_all = kernel_matrix(torch.cat([Zr, Z_h, z_new], dim=-2), z_new,
                          hyp_ls, hyp_os, grad)
    A_rn = m_r[:, None] * K_all[..., :R_r, :] * m_new[..., None, :]
    A_hn = (uf["mask_h"][..., :, None] * K_all[..., R_r:R_r + R_h, :]
            * m_new[..., None, :])
    K_nn = K_all[..., R_r + R_h:, :] + torch.diag(noise_diag)
    A_nn = (m_new[..., :, None] * K_nn * m_new[..., None, :]
            + torch.diag_embed(1.0 - m_new))

    solve = _solve_refined if refine else _solve
    c = solve(rf["L"], A_rn)
    b = solve(uf["L_s"], A_hn - uf["C"].transpose(-1, -2) @ c)
    S = A_nn - c.transpose(-1, -2) @ c - b.transpose(-1, -2) @ b
    # The true Schur diagonal is a posterior variance + noise > 0, but f32
    # roundoff in the incremental c'c + b'b accumulation drives it negative
    # over long rollouts; floor it relative to the prior variance.
    rel = 1e-5 if z_new.dtype == torch.float32 else 1e-12
    dS = torch.diagonal(S, dim1=-2, dim2=-1)
    dS.copy_(torch.maximum(dS, rel * torch.diagonal(A_nn, dim1=-2,
                                                    dim2=-1)))
    D_blk = safe_cholesky(0.5 * (S + S.transpose(-1, -2)), jitter)
    rhs = (y - (c.transpose(-1, -2) @ rf["w"][:, None])[..., 0]
           - (b.transpose(-1, -2) @ uf["w_h"][..., None])[..., 0])
    w_new = _tri(D_blk, rhs[..., None])[..., 0]

    # last-resort sanitizer, per batch entry: an append that still failed
    # numerically masks its new rows (identity block, zero couplings)
    # instead of poisoning that realization with NaN for every later step
    fin = lambda t, k: torch.isfinite(t).flatten(-k).all(-1)
    ok = fin(c, 2) & fin(b, 2) & fin(D_blk, 2) & fin(w_new, 1)
    okm = ok[..., None, None]
    eye = torch.eye(Ty, dtype=z_new.dtype, device=z_new.device)
    c = torch.where(okm, c, torch.zeros_like(c))
    b = torch.where(okm, b, torch.zeros_like(b))
    D_blk = torch.where(okm, D_blk, eye)
    w_new = torch.where(ok[..., None], w_new, torch.zeros_like(w_new))
    m_new = torch.where(ok[..., None], m_new, torch.zeros_like(m_new))

    sl = slice(pos, pos + Ty)
    uf["C"][..., :, sl] = c
    uf["L_s"][..., sl, :] = b.transpose(-1, -2)
    uf["L_s"][..., sl, sl] = D_blk
    uf["w_h"][..., sl] = w_new
    uf["mask_h"][..., sl] = m_new
    return uf
