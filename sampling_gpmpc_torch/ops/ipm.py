"""Structured Mehrotra IPM: two CUDA kernels + the plain torch version.

Port of ``sampling_gpmpc_tpu/ops/pallas_ipm.py`` (``run_full``,
``_prepare_kernel``, ``_kernel``, ``_run_chunks``) and of the loop of
``ocp/qp.py::solve_qp_soft`` it replaces.  The QP is

    min_u  0.5 u'Hu + g'u + sum_j [zl sl + 0.5 Zl sl^2 + zu su + 0.5 Zu su^2]
    s.t.   G_h u <= d_h,   lo_j - sl_j <= G_s u <= hi_j + su_j,  sl, su >= 0

with the soft slacks eliminated analytically, so every Newton system is the
(nU, nU) Schur matrix H + Gh' diag(w_h) Gh + Gs' diag(w_eff) Gs.

* ``ipm_prepare`` (kernel 1), one QP on the loop kernel's cluster and row
  slices (:func:`prepare_layout`): per-row inf-norm equilibration of hard
  and soft rows, penalty rescaling and ``qscale``, the central-path cold
  start at mu0 = qscale, the duals-only warm start mapped into the new
  scaling (staleness tau, complementarity band ``ws_band``·mu_ws), and the
  warm/cold choice by their KKT residuals at u = 0, reported in a one-word
  ``warm`` flag.
* ``ipm_mehrotra`` (kernel 2), one QP on a thread-block cluster
  (:func:`loop_layout`): the predictor-corrector loop with Jacobi
  scaling + ``reg`` before the Cholesky, a 0.99 step to the boundary,
  sigma = (mu_aff/mu)^3, non-finite step rejection, best iterate by
  relative KKT residual, the stall exit (STALL_ITERS without a STALL_RTOL
  improvement once mu < MU_GRIND mu0) and an exact ``max_iter`` cap.

:func:`run_full` returns ``(best 11-tuple, best_res, iters, scale_h,
scale_s)`` — the scaled best iterate ``(u, sl, su, th, lh, tU, lU, tL, lL,
nl, nu)`` — for ``ocp/qp.py::_finish``.  It runs :func:`run_full_plain` for
CPU tensors and the two kernels (``csrc/ipm.cu``) for CUDA tensors, never
falling back: a CUDA problem the kernels cannot take (float64, no hard
rows, nU > 256) raises, naming the limit (:func:`check_supported`).  A QP
with no soft rows (m_s = 0) runs the kernels' hard-only build, the
counterpart of the JAX package's XLA body for it (``pallas_ipm.fused_ok``
refuses m_s = 0).  A wide QP (128 < nU <= 256, which ``fused_ok`` refuses
too) runs the wide builds, whose loop kernel holds the Schur matrix in
32 x 32 tiles (:func:`loop_layout`); nU <= 128 takes the narrow builds.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sampling_gpmpc_torch.ops import build
from sampling_gpmpc_torch.parallel.collectives import (group_size,
                                                       make_reducers)

LAUNCHES = {"ipm_prepare": 0, "ipm_mehrotra": 0}
# the launches of LAUNCHES that went to the wide builds (nU > NU_NARROW)
LAUNCHES_WIDE = {"ipm_prepare": 0, "ipm_mehrotra": 0}
NU_MAX = 256         # the wide builds' limit
NU_NARROW = 128      # the narrow builds' limit


def check_supported(nU: int, m_h: int, m_s: int, dtype) -> None:
    """Raise ValueError naming the limit when the kernels cannot take a
    problem: float32 only, hard rows present (the Pallas path cannot take
    m_h = 0 either), and a Schur matrix small enough for one CTA's shared
    memory as tiles (nU <= 256).  m_s = 0 takes the kernels' hard-only
    build."""
    if dtype != torch.float32:
        raise ValueError(f"ipm kernels take float32 only, got {dtype}; "
                         "solve float64 problems with device='cpu'")
    if not 1 <= nU <= NU_MAX:
        raise ValueError(f"ipm kernels take 1 <= nU <= {NU_MAX}, got "
                         f"nU={nU}")
    if m_h < 1 or m_s < 0:
        raise ValueError(f"ipm kernels need m_h >= 1 and m_s >= 0, got "
                         f"m_h={m_h}, m_s={m_s}")


# --------------------------------------------------------------------------
# plain torch version
# --------------------------------------------------------------------------

def _precond_factor(M, reg):
    """Jacobi-preconditioned Cholesky of the Schur matrix (load-bearing in
    f32: the symmetric diagonal scaling keeps the factorization alive when
    penalty-weighted rows push the condition number past single range)."""
    inv_s = torch.rsqrt(torch.clamp(torch.diagonal(M), min=1e-30))
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(
        inv_s[:, None] * M * inv_s[None, :] + reg * eye)
    # a failed factorization gives a NaN step, which the loop rejects
    return inv_s, torch.where(info != 0, torch.full_like(L, float("nan")), L)


def _precond_solve(inv_s, L, rhs):
    return inv_s * torch.cholesky_solve((inv_s * rhs)[:, None], L)[:, 0]


def _amax(x):
    return torch.max(x) if x.numel() else x.new_zeros(())


class Prepared(NamedTuple):
    """Equilibrated problem + start iterate (the prepare stage's output)."""
    H: torch.Tensor
    g: torch.Tensor
    G_h: torch.Tensor        # row-scaled hard rows (m_h, nU)
    d_h: torch.Tensor
    G_s: torch.Tensor        # row-scaled soft rows (m_s, nU)
    lo_s: torch.Tensor
    hi_s: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    Zl: torch.Tensor
    Zu: torch.Tensor
    qscale: torch.Tensor
    st0: tuple               # start iterate (u, sl, su, th, lh, tU, lU, tL, lL, nl, nu)
    scale_h: torch.Tensor
    scale_s: torch.Tensor
    warm: torch.Tensor = None  # bool: st0 is the warm start (None: no carried duals)


# the reducers without a group (make_reducers(None)): identities
_NO_GROUP = make_reducers(None)


def _compl_local(st):
    _, sl, su, th, lh_, tU, lU, tL, lL, nl, nu_ = st
    return (torch.dot(th, lh_) + torch.dot(tU, lU) + torch.dot(tL, lL)
            + torch.dot(sl, nl) + torch.dot(su, nu_))


def _compl_sum(st, psum=_NO_GROUP[0]):
    return psum(_compl_local(st))


def _m_total(p: Prepared, world: int = 1) -> int:
    """Complementarity pairs over every shard (equal row counts each)."""
    return (p.d_h.shape[0] + 4 * p.lo_s.shape[0]) * world


def _dual_rows(p: Prepared, st):
    """The row part of the stationarity residual, G_h' lh + G_s' (lU - lL)
    (a shard's partial under a group)."""
    lh_, lU, lL = st[4], st[6], st[8]
    return p.G_h.T @ lh_ + p.G_s.T @ (lU - lL)


def _stationarity(p: Prepared, st, psum=_NO_GROUP[0]):
    return p.H @ st[0] + p.g + psum(_dual_rows(p, st))


def _kkt_parts(p: Prepared, st, red=_NO_GROUP, world: int = 1):
    """Relative KKT residual: stationarity in units of qscale, primal rows
    relative to their bound magnitude, complementarity per row; and the
    complementarity sum, which the loop reuses as the next iteration's mu
    numerator.  Under a group the dual rows and the complementarity ride
    one tuple-psum and the primal rows' maximum a pmax (JAX
    ``ocp/qp.py::kkt_parts``)."""
    psum, _, pmax = red
    u, sl, su, th, lh_, tU, lU, tL, lL, nl, nu_ = st
    r1_s, compl = psum((_dual_rows(p, st), _compl_local(st)))
    r_stat = torch.max(torch.abs(p.H @ u + p.g + r1_s)) / p.qscale
    rp = [(p.G_h @ u + th - p.d_h) * (1.0 / (1.0 + torch.abs(p.d_h)))]
    if p.lo_s.shape[0]:
        rp += [(p.G_s @ u - su + tU - p.hi_s)
               * (1.0 / (1.0 + torch.abs(p.hi_s))),
               (-(p.G_s @ u) - sl + tL + p.lo_s)
               * (1.0 / (1.0 + torch.abs(p.lo_s)))]
    r_prim = pmax(torch.max(torch.abs(torch.cat(rp))))
    return torch.maximum(torch.maximum(r_stat, r_prim),
                         compl / (_m_total(p, world) * p.qscale)), compl


def _kkt_residual(p: Prepared, st, red=_NO_GROUP, world: int = 1):
    return _kkt_parts(p, st, red, world)[0]


def prepare_plain(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu,
                  ws, ws_valid, ws_band, group=None,
                  ordered: bool = False) -> Prepared:
    """Plain version of the prepare kernel: row equilibration, qscale, the
    cold start and the duals-only warm start with its acceptance test.

    ``group``: the rows are this shard's of a sample-sharded QP (H, g and
    the warm start's u replicated); qscale is pmax-ed, the warm start's
    dual residual psum-ed and the acceptance residuals reduced, at the
    places of the JAX package's XLA body (``ocp/qp.py:318``, ``:410``)."""
    red = make_reducers(group, ordered, scope="qp prepare")
    psum, _, pmax = red
    world = group_size(group)
    nU = g.shape[0]
    dtype, dev = g.dtype, g.device
    m_s = lo_s.shape[0]
    # row equilibration to unit inf-norm; soft-row scaling a rescales the
    # slacks (s' = s/a), so penalties transform as z' = z a, Z' = Z a^2
    scale_h = torch.clamp(torch.amax(torch.abs(G_h), dim=1), min=1e-10)
    if m_s:
        scale_s = torch.clamp(torch.amax(torch.abs(G_s), dim=1), min=1e-10)
    else:
        scale_s = G_s.new_ones((0,))
    G_h, d_h = G_h / scale_h[:, None], d_h / scale_h
    G_s = G_s / scale_s[:, None]
    lo_s, hi_s = lo_s / scale_s, hi_s / scale_s
    zl, zu = zl * scale_s, zu * scale_s
    Zl, Zu = Zl * scale_s * scale_s, Zu * scale_s * scale_s
    # zl is scaled by shard-local row norms: qscale must agree across shards
    qscale = pmax(1.0 + torch.max(torch.abs(g))
                  + torch.clamp(_amax(zl), min=0.0))

    # central-path cold start at the dual scale: s * lam = mu0 per pair
    mu0 = qscale
    u0 = torch.zeros(nU, dtype=dtype, device=dev)
    th0 = torch.clamp(d_h, min=1.0)
    one_s = torch.ones((m_s,), dtype=dtype, device=dev)
    tU0 = torch.clamp(hi_s + 1.0, min=1.0)
    tL0 = torch.clamp(-lo_s + 1.0, min=1.0)
    st0 = (u0, one_s, one_s, th0, mu0 / th0, tU0, mu0 / tU0, tL0, mu0 / tL0,
           mu0 * one_s, mu0 * one_s)
    p = Prepared(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu, qscale,
                 st0, scale_h, scale_s)
    if ws is None:
        return p

    # duals-only warm start: carried (unscaled) duals map into this call's
    # row scaling as lam' = a lam, slack' = slack / a
    (u_w, sl_w, su_w, _, lh_w, _, lU_w, _, lL_w, nl_w, nu_w) = ws
    lh_w = lh_w * scale_h
    sl_w, su_w = sl_w / scale_s, su_w / scale_s
    lU_w, lL_w = lU_w * scale_s, lL_w * scale_s
    nl_w, nu_w = nl_w * scale_s, nu_w * scale_s
    # staleness of the carried pair under the current data sets the warm
    # complementarity target
    rq = pmax(torch.max(torch.abs(_stationarity(
        p, (u_w, None, None, None, lh_w, None, lU_w, None, lL_w),
        psum)))) / qscale
    tau = torch.clamp(rq, 1e-4, 1.0)
    mu_ws = mu0 * tau
    lo_b, hi_b = ws_band[0] * mu_ws, ws_band[1] * mu_ws
    clip = lambda x, a, b: torch.minimum(torch.maximum(x, a), b)
    th_w = torch.maximum(d_h, tau * (1.0 + torch.abs(d_h)))
    lh_w = clip(lh_w, lo_b / th_w, hi_b / th_w)
    sl_w = torch.maximum(sl_w, tau)
    su_w = torch.maximum(su_w, tau)
    tU_w = torch.maximum(hi_s + su_w, tau * (1.0 + torch.abs(hi_s)))
    tL_w = torch.maximum(-lo_s + sl_w, tau * (1.0 + torch.abs(lo_s)))
    lU_w = clip(lU_w, lo_b / tU_w, hi_b / tU_w)
    lL_w = clip(lL_w, lo_b / tL_w, hi_b / tL_w)
    nl_w = clip(nl_w, lo_b / sl_w, hi_b / sl_w)
    nu_w = clip(nu_w, lo_b / su_w, hi_b / su_w)
    st_w = (u0, sl_w, su_w, th_w, lh_w, tU_w, lU_w, tL_w, lL_w, nl_w, nu_w)
    valid = torch.ones((), dtype=torch.bool, device=dev) \
        if ws_valid is None else torch.as_tensor(ws_valid, device=dev)
    valid = valid & (rq < 1e-2) & (_kkt_residual(p, st_w, red, world)
                                   <= _kkt_residual(p, st0, red, world))
    return p._replace(st0=tuple(torch.where(valid, w, c)
                                for w, c in zip(st_w, st0)), warm=valid)


def mehrotra_plain(p: Prepared, tol: float, reg: float, max_iter: int,
                   stall_iters: int, stall_rtol: float, mu_grind: float,
                   group=None, ordered: bool = False):
    """Plain version of the Mehrotra loop kernel.

    ``group``: the rows of ``p`` are this shard's of a sample-sharded QP.
    The reducers sit where the JAX package's XLA body has them
    (``ocp/qp.py:304-553``): one tuple-psum of the dual residual and both
    Schur contributions, one of the two right-hand-side parts, psums of the
    complementarity, pmin of the step ratios and of the finiteness flag,
    pmax of the primal residual; the complementarity pairs count every
    shard's rows.  As there, the complementarity sum of the KKT residual
    is carried into the next iteration's mu, so an iteration makes five
    sum rounds, three min rounds and one max round (and the loop one sum
    round before it, counted with the QP's pre-loop).  Every host-side
    branch reads a reduced value, so every rank issues the same
    collectives in the same order.

    Returns ``(best_state_11tuple, best_res, iters)``.
    """
    red = make_reducers(group, ordered, scope="mehrotra")
    psum, pmin, _ = red
    H, g, G_h, d_h, G_s = p.H, p.g, p.G_h, p.d_h, p.G_s
    lo_s, hi_s, zl, zu, Zl, Zu = p.lo_s, p.hi_s, p.zl, p.zu, p.Zl, p.Zu
    dtype, dev = g.dtype, g.device
    m_s = lo_s.shape[0]
    world = group_size(group)
    m_total = _m_total(p, world)
    mu0 = p.qscale

    def max_step(st, d):
        a = torch.ones((), dtype=dtype, device=dev)
        for v, dv in zip(st[1:], d[1:]):
            if v.shape[0]:
                ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                                    torch.full_like(v, float("inf")))
                a = torch.minimum(a, torch.min(ratio))
        return 0.99 * pmin(a)

    def factorize(st):
        u, sl, su, th, lh_, tU, lU, tL, lL, nl, nu_ = st
        w_h = lh_ / th
        rp_h = G_h @ u + th - d_h
        Mh = (G_h.T * w_h) @ G_h
        soft = None
        if m_s:
            w_U, w_L = lU / tU, lL / tL
            w_Pl, w_Pu = nl / sl, nu_ / su
            rp_U = G_s @ u - su + tU - hi_s
            rp_L = -(G_s @ u) - sl + tL + lo_s
            r2 = Zl * sl + zl - lL - nl
            r3 = Zu * su + zu - lU - nu_
            Dl = Zl + w_L + w_Pl
            Du = Zu + w_U + w_Pu
            w_eff = w_U + w_L - w_U * w_U / Du - w_L * w_L / Dl
            soft = (w_U, w_L, w_Pl, w_Pu, rp_U, rp_L, r2, r3, Dl, Du)
            # one round trip: dual residual and both Schur contributions
            r1_s, Mh, Ms = psum((_dual_rows(p, st), Mh,
                                 (G_s.T * w_eff) @ G_s))
            M = H + Mh + Ms
        else:
            r1_s, Mh = psum((_dual_rows(p, st), Mh))
            M = H + Mh
        r1 = H @ u + g + r1_s
        inv_s, L = _precond_factor(M, reg)
        return w_h, rp_h, r1, soft, inv_s, L

    def direction(st, aux, sig_mu, corr):
        u, sl, su, th, lh_, tU, lU, tL, lL, nl, nu_ = st
        w_h, rp_h, r1, soft, inv_s, L = aux
        ch, cU, cL, cPl, cPu = corr if corr is not None else (0.,) * 5
        b_h = (lh_ * th - sig_mu + ch) / th
        rhs_h = G_h.T @ (b_h - w_h * rp_h)
        if m_s:
            (w_U, w_L, w_Pl, w_Pu, rp_U, rp_L, r2, r3, Dl, Du) = soft
            b_U = (lU * tU - sig_mu + cU) / tU
            b_L = (lL * tL - sig_mu + cL) / tL
            b_Pl = (nl * sl - sig_mu + cPl) / sl
            b_Pu = (nu_ * su - sig_mu + cPu) / su
            cl = -r2 - b_L - b_Pl + w_L * rp_L
            cu = -r3 - b_U - b_Pu + w_U * rp_U
            const_s = (-b_U + b_L + w_U * rp_U - w_L * rp_L
                       - w_U * cu / Du + w_L * cl / Dl)
            rhs_h, rhs_s = psum((rhs_h, G_s.T @ const_s))
            rhs = -r1 + rhs_h - rhs_s
        else:
            rhs = -r1 + psum(rhs_h)
        du = _precond_solve(inv_s, L, rhs)
        dth = -(G_h @ du) - rp_h
        dlh = -b_h - w_h * dth
        if m_s:
            gsdu = G_s @ du
            dsl = (cl - w_L * gsdu) / Dl
            dsu = (cu + w_U * gsdu) / Du
            dtU = -gsdu + dsu - rp_U
            dtL = gsdu + dsl - rp_L
            dlU = -b_U - w_U * dtU
            dlL = -b_L - w_L * dtL
            dnl = -b_Pl - w_Pl * dsl
            dnu = -b_Pu - w_Pu * dsu
        else:
            dsl = dsu = dtU = dlU = dtL = dlL = dnl = dnu = sl
        return (du, dsl, dsu, dth, dlh, dtU, dlU, dtL, dlL, dnl, dnu)

    st = best = p.st0
    best_res = torch.tensor(float("inf"), dtype=dtype, device=dev)
    it, since = 0, 0
    # the loop's first mu numerator: a pre-loop round, as in JAX
    pre_sum = make_reducers(group, ordered, scope="qp prepare")[0]
    csum = _compl_sum(st, pre_sum)
    while it < max_iter:
        mu = csum / m_total
        aux = factorize(st)
        d_aff = direction(st, aux, 0.0, None)
        a_aff = max_step(st, d_aff)
        st_aff = tuple(v + a_aff * dv for v, dv in zip(st, d_aff))
        mu_aff = _compl_sum(st_aff, psum) / m_total
        sigma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
        corr = (d_aff[4] * d_aff[3], d_aff[6] * d_aff[5], d_aff[8] * d_aff[7],
                d_aff[9] * d_aff[1], d_aff[10] * d_aff[2])
        d = direction(st, aux, sigma * mu, corr)
        alpha = max_step(st, d)
        st_n = tuple(v + alpha * dv for v, dv in zip(st, d))
        ok = bool(pmin(torch.stack([torch.isfinite(v).all() for v in st_n])
                       .all().to(torch.int32)) > 0)
        it += 1
        if ok:
            st = st_n
        res, csum = _kkt_parts(p, st, red, world)
        if not ok:
            res = torch.full_like(best_res, float("inf"))
        if bool(res < best_res):
            best = st
        meaningful = bool(res < best_res * (1.0 - stall_rtol))
        best_res = torch.minimum(res, best_res)
        mu_new = csum / m_total
        grinding = bool(mu_new < mu_grind * mu0)
        since = 0 if (meaningful or not grinding) else since + 1
        live = ok and bool(mu_new > 1e-14 * mu0)
        if dtype != torch.float64:
            live = live and since < stall_iters
        if not live or bool(best_res <= tol):
            break
    return best, best_res, torch.tensor(it, device=dev)


def run_full_plain(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu,
                   ws, ws_valid, tol: float, reg: float, max_iter: int,
                   stall_iters: int, stall_rtol: float, mu_grind: float,
                   ws_band):
    """The kernels' algorithm in plain torch (the loop of the JAX package's
    ``solve_qp_soft``); same arguments and result as :func:`run_full`."""
    p = prepare_plain(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu,
                      ws, ws_valid, ws_band)
    best, best_res, it = mehrotra_plain(p, tol, reg, max_iter, stall_iters,
                                        stall_rtol, mu_grind)
    return best, best_res, it, p.scale_h, p.scale_s


def seeded_qp(nU: int, m_h: int, m_s: int, seed: int, device,
              dtype=torch.float32) -> tuple:
    """A QP of the JAX package's IPM test family (tests/test_pallas_ipm.py),
    made with numpy from ``seed``: H = A A' + I, u = 0 strictly feasible for
    the hard rows, soft rows with lo < 0 < hi.  Returns solve_qp_soft's
    first eleven arguments."""
    import numpy as np
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(nU, nU))
    prob = [A @ A.T + np.eye(nU), rng.normal(size=nU) * 3,
            rng.normal(size=(m_h, nU)), rng.uniform(0.1, 1.5, size=m_h),
            rng.normal(size=(m_s, nU)), rng.uniform(-0.5, -0.1, size=m_s),
            rng.uniform(0.05, 2.0, size=m_s), np.full(m_s, 3.0),
            np.full(m_s, 2.0), np.full(m_s, 5.0), np.full(m_s, 4.0)]
    return tuple(torch.as_tensor(a, dtype=dtype, device=device).contiguous()
                 for a in prob)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _schur_chunk(nU: int) -> int:
    """Rows of G staged per Schur pass of a streamed slice: the largest
    power of two with the (nU, chunk+1) tile within 64 KB, at most 1024."""
    c = 1024
    while c > 16 and nU * (c + 1) * 4 > 65536:
        c //= 2
    return c


PUB = 136            # floats of one publish buffer of the loop kernel
PUB_PREP = 264       # ... and of the prepare kernel (csrc/ipm.cu)
PUB_WIDE = 264       # ... of the wide builds' loop kernel
PUB_PREP_WIDE = 520  # ... and prepare kernel
CLUSTER = 16         # CTAs of the cluster that runs one QP (csrc/ipm.cu)
TILE_FLOATS = 32 * 33      # one 32 x 32 Schur tile at row stride 33
WIDE_CHUNK = 32      # rows of G staged per step of the wide Schur pass
GROUP_MAX = 16       # Schur tiles per group of the wide pass (csrc/ipm.cu)


class LoopLayout(NamedTuple):
    """How the loop kernel lays one QP over its cluster (csrc/ipm.cu)."""
    resident: bool       # G slices and state rows in shared memory
    chunk: int           # rows of G staged per Schur pass when streamed
    smem: int            # dynamic shared memory of each CTA, bytes
    group: int = 0       # wide branch: Schur tiles formed per group


def wide_layout(nU: int) -> LoopLayout:
    """The wide branch (128 < nU <= 256): the Schur matrix as its t (t + 1)
    / 2 lower 32 x 32 tiles, t = ceil(nU / 32), beside the publish buffers,
    eight vectors of 32 t + 8, the factor scratch and a staged chunk of G
    (32 t rows of WIDE_CHUNK + 1); the rest of the CTA's shared memory holds
    the staging area of as many partial tiles as fit, at most GROUP_MAX.
    The slices and state rows are always read from global memory, so the
    layout does not depend on the row counts."""
    t = -(-nU // 32)
    ntl, npad = t * (t + 1) // 2, 32 * t
    base = (ntl * TILE_FLOATS + 2 * PUB_WIDE + 8 * (npad + 8) + 2 * nU + 72
            + npad * (WIDE_CHUNK + 1) + WIDE_CHUNK)
    group = min(GROUP_MAX, ntl, (build.SMEM_MAX // 4 - base) // TILE_FLOATS)
    return LoopLayout(False, WIDE_CHUNK, 4 * (base + group * TILE_FLOATS),
                      group)


def loop_layout(nU: int, m_h: int, m_s: int) -> LoopLayout:
    """Each CTA owns ceil(m / CLUSTER) rows at most; its columns of G and
    its state rows (9 floats per hard row, 36 per soft row) stay in shared
    memory when they fit beside the Schur matrices and vectors, else the
    same kernel reads them from global memory (streamed).  The hard-only
    build (m_s = 0) has no soft slice; nU > 128 takes :func:`wide_layout`."""
    if nU > NU_NARROW:
        return wide_layout(nU)
    hmax, smax = -(-m_h // CLUSTER), -(-m_s // CLUSTER)
    base = 2 * nU * (nU + 1) + 2 * PUB + 8 * (nU + 8) + 2 * nU + 72
    # G slices at odd row strides (hmax | 1, smax | 1)
    resident = (base + nU * ((hmax | 1) + ((smax | 1) if m_s else 0))
                + 9 * hmax + 36 * smax)
    if 4 * resident <= build.SMEM_MAX:
        return LoopLayout(True, 0, 4 * resident)
    chunk = _schur_chunk(nU)
    return LoopLayout(False, chunk, 4 * (base + nU * (chunk + 1) + chunk))


class PrepLayout(NamedTuple):
    """How the prepare kernel lays one QP over the cluster (csrc/ipm.cu)."""
    resident: bool       # scaled G slices, row values, warm candidate in shared memory
    chunk: int           # rows staged per chunk (the whole slice when resident)
    smem: int            # dynamic shared memory of each CTA, bytes


def _prep_chunk(nU: int) -> int:
    """Rows per staged chunk of a streamed slice: the largest power of two
    up to 512 (one row a thread of the 512), at least 32, with the two
    staging buffers, their row inputs and the transposed chunk within
    160 KB."""
    c = 512
    while c > 32 and 4 * (3 * nU + 12) * c > 163840:
        c //= 2
    return c


def prepare_layout(nU: int, m_h: int, m_s: int) -> PrepLayout:
    """The prepare kernel's shared memory per CTA (the carve-up of
    ``ipm_prepare_kernel``): two staging buffers of ``chunk`` rows of G and
    of the 6 row inputs, the publish buffers, the reduced vectors and
    per-chunk rows; resident,
    with chunk = the larger slice, also the slices' transposed columns at
    odd row strides, 3 values per hard row and 5 per soft row, and the warm
    candidate (2 per hard row, 8 per soft row); else the chunk transposed.
    The hard-only build (m_s = 0) stages one row input (d_h), not six, and
    has no soft slice; the wide build (nU > 128) has larger publish
    buffers."""
    hmax, smax = -(-m_h // CLUSTER), -(-m_s // CLUSTER)
    n_in = 6 if m_s else 1
    pub = PUB_PREP_WIDE if nU > NU_NARROW else PUB_PREP

    def floats(chunk, tail):
        raw = -(-(chunk * nU + 4) // 4) * 4 + -(-n_in * chunk // 4) * 4
        return 2 * raw + 2 * pub + 2 * nU + 8 + 64 + 3 * chunk + tail

    chunk = max(hmax, smax)
    resident = floats(chunk, nU * ((hmax | 1) + ((smax | 1) if m_s else 0))
                      + 5 * hmax + 13 * smax)
    if 4 * resident <= build.SMEM_MAX:
        return PrepLayout(True, chunk, 4 * resident)
    chunk = _prep_chunk(nU)
    return PrepLayout(False, chunk, 4 * floats(chunk, nU * (chunk | 1)))


_CLUSTER: dict = {}


def _library(m_s: int, nU: int) -> str:
    """The library of the kernels' build for a QP: ``ipm`` (soft rows) or
    ``ipm_hard`` (m_s = 0; csrc/ipm.cu built with IPM_SOFT=0), with
    ``_wide`` for 128 < nU <= 256 (IPM_WIDE=1)."""
    return ("ipm" if m_s else "ipm_hard") + (
        "_wide" if nU > NU_NARROW else "")


def cluster_size(m_s: int = 1, nU: int = 1) -> int:
    """CTAs per QP, CLUSTER; raises if the card cannot co-schedule a
    cluster of that many CTAs of either kernel of the build for ``m_s``
    and ``nU`` (asked of the CUDA runtime once per library)."""
    name = _library(m_s, nU)
    if name not in _CLUSTER:
        fn = build.load(name).ipm_cluster_size
        fn.argtypes, fn.restype = [], ctypes.c_int
        n = fn()
        if n != CLUSTER:
            raise RuntimeError(
                f"ipm: this card cannot co-schedule a cluster of {CLUSTER} "
                f"CTAs of the IPM kernels of {name} (returned {n}; a "
                f"negative value is a CUDA error)")
        _CLUSTER[name] = n
    return _CLUSTER[name]


class Device(NamedTuple):
    """The prepare kernel's outputs (device buffers) for the loop kernel."""
    H: torch.Tensor
    g: torch.Tensor
    Gth: torch.Tensor        # scaled hard rows, transposed (nU, m_h)
    Gts: torch.Tensor        # scaled soft rows, transposed (nU, m_s)
    dh: torch.Tensor         # (2, m_h): scaled d, 1/(1+|d|)
    sd: torch.Tensor         # (8, m_s): lo hi zl zu Zl Zu 1/(1+|hi|) 1/(1+|lo|)
    h0: torch.Tensor         # (2, m_h): start th, lh
    s0: torch.Tensor         # (8, m_s): start tU tL sl su lU lL nl nu
    qs: torch.Tensor         # (1,) qscale
    sch: torch.Tensor        # (m_h,) row scales
    scs: torch.Tensor        # (m_s,)
    warm: torch.Tensor       # (1,) int32: 1 if h0/s0 is the warm start
    work: torch.Tensor       # the loop kernel's state rows when streamed


def _ptr(t):
    """A kernel argument: the tensor's address, or NULL for no tensor and
    for an empty one (its address may be 0; the hard-only build reads no
    soft argument)."""
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _lib_fns(m_s: int, nU: int):
    lib = build.load(_library(m_s, nU))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    prep, loop = lib.ipm_prepare, lib.ipm_mehrotra
    prep.argtypes = [P] * 30 + [I, I, I, F, F, I, I, I, P]
    prep.restype = I
    loop.argtypes = [P] * 15 + [I, I, I, F, F, I, I, F, F, I, I, I, I, P]
    loop.restype = I
    return prep, loop


def prepare(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu, ws, ws_valid,
            ws_band=(1e-8, 1e12)) -> Device:
    """Launch the prepare kernel (CUDA float32 tensors only) on a cluster
    laid out by :func:`prepare_layout`."""
    dev = g.device
    nU, m_h, m_s = g.shape[0], d_h.shape[0], lo_s.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"ipm_prepare: tensors on {dev}, not CUDA")
    check_supported(nU, m_h, m_s, g.dtype)
    for name, t, shape in [("H", H, (nU, nU)), ("g", g, (nU,)),
                           ("G_h", G_h, (m_h, nU)), ("d_h", d_h, (m_h,)),
                           ("G_s", G_s, (m_s, nU))] + [
            (n, t, (m_s,)) for n, t in (("lo_s", lo_s), ("hi_s", hi_s),
                                        ("zl", zl), ("zu", zu), ("Zl", Zl),
                                        ("Zu", Zu))]:
        build.check_tensor(name, t, shape, dev)
    if ws is not None:
        for k, (t, n) in enumerate(zip(ws, (nU, m_s, m_s, m_h, m_h, m_s, m_s,
                                            m_s, m_s, m_s, m_s))):
            build.check_tensor(f"ws[{k}]", t, (n,), dev)
        if ws_valid is None:
            ws_valid = torch.ones((), dtype=torch.bool, device=dev)
        if ws_valid.dtype != torch.bool or ws_valid.device != dev:
            raise ValueError("ws_valid: need a bool tensor on the device")
    cluster_size(m_s, nU)
    lay = prepare_layout(nU, m_h, m_s)
    if lay.smem > build.SMEM_MAX:
        raise ValueError(f"ipm_prepare: {lay.smem} B of shared memory exceeds "
                         f"{build.SMEM_MAX} B")
    streamed_loop = not loop_layout(nU, m_h, m_s).resident
    sizes = {"Gth": nU * m_h, "Gts": nU * m_s, "dh": 2 * m_h, "sd": 8 * m_s,
             "h0": 2 * m_h, "s0": 8 * m_s, "qs": 1, "sch": m_h, "scs": m_s,
             "warm": 1,
             "work": 9 * m_h + 36 * m_s if streamed_loop else 0}
    flat = torch.empty(sum(sizes.values()), dtype=torch.float32, device=dev)
    buf, o = {}, 0
    for k, n in sizes.items():
        buf[k] = flat[o:o + n]
        o += n
    buf["warm"] = buf["warm"].view(torch.int32)
    wsp = [None] * 8 if ws is None else [
        _ptr(ws[i]) for i in (0, 1, 2, 4, 6, 8, 9, 10)]  # u sl su lh lU lL nl nu
    prep, _ = _lib_fns(m_s, nU)
    with torch.cuda.device(dev):
        rc = prep(*(_ptr(t) for t in (H, g, G_h, d_h, G_s, lo_s, hi_s,
                                      zl, zu, Zl, Zu)),
                  *wsp, None if ws is None else ws_valid.data_ptr(),
                  *(_ptr(buf[k]) for k in ("Gth", "Gts", "dh", "sd", "h0",
                                           "s0", "qs", "sch", "scs",
                                           "warm")),
                  nU, m_h, m_s, float(ws_band[0]), float(ws_band[1]),
                  lay.chunk, int(lay.resident), lay.smem,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "ipm_prepare launch")
    build.count(LAUNCHES, "ipm_prepare")
    if nU > NU_NARROW:
        build.count(LAUNCHES_WIDE, "ipm_prepare", tally=False)
    return Device(H=H, g=g, Gth=buf["Gth"].view(nU, m_h),
                  Gts=buf["Gts"].view(nU, m_s), dh=buf["dh"].view(2, m_h),
                  sd=buf["sd"].view(8, m_s), h0=buf["h0"].view(2, m_h),
                  s0=buf["s0"].view(8, m_s), qs=buf["qs"], sch=buf["sch"],
                  scs=buf["scs"], warm=buf["warm"], work=buf["work"])


def prepared_fields(d: Device, p: Prepared) -> list:
    """``(name, kernel output, plain value)`` for every output field of the
    prepare kernel, against :func:`prepare_plain`'s result ``p`` on the same
    inputs: 25 fields, the 7 not on soft rows when the QP has none."""
    s, inv = p.st0, (lambda x: 1.0 / (1.0 + torch.abs(x)))
    soft = (("lo_s", p.lo_s), ("hi_s", p.hi_s), ("zl", p.zl), ("zu", p.zu),
            ("Zl", p.Zl), ("Zu", p.Zu), ("1/(1+|hi|)", inv(p.hi_s)),
            ("1/(1+|lo|)", inv(p.lo_s)))
    fields = [("G_h", d.Gth.T, p.G_h), ("d_h", d.dh[0], p.d_h),
              ("1/(1+|d_h|)", d.dh[1], inv(p.d_h)), ("G_s", d.Gts.T, p.G_s),
              *[(n, d.sd[k], v) for k, (n, v) in enumerate(soft)],
              ("qscale", d.qs[0], p.qscale), ("scale_h", d.sch, p.scale_h),
              ("scale_s", d.scs, p.scale_s), ("th", d.h0[0], s[3]),
              ("lh", d.h0[1], s[4]), ("tU", d.s0[0], s[5]),
              ("tL", d.s0[1], s[7]), ("sl", d.s0[2], s[1]),
              ("su", d.s0[3], s[2]), ("lU", d.s0[4], s[6]),
              ("lL", d.s0[5], s[8]), ("nl", d.s0[6], s[9]),
              ("nu", d.s0[7], s[10])]
    return [f for f in fields if f[2].numel()]


def mehrotra(d: Device, tol: float, reg: float, max_iter: int,
             stall_iters: int = 10, stall_rtol: float = 0.01,
             mu_grind: float = 1e-6):
    """Launch the Mehrotra loop kernel on a prepared problem.

    Returns ``(best_state_11tuple, best_res, iters)`` as device tensors.
    """
    dev = d.g.device
    nU, m_h, m_s = d.g.shape[0], d.dh.shape[1], d.sd.shape[1]
    cluster_size(m_s, nU)
    lay = loop_layout(nU, m_h, m_s)
    if lay.smem > build.SMEM_MAX:
        raise ValueError(f"ipm: {lay.smem} B of shared memory exceeds "
                         f"{build.SMEM_MAX} B")
    out = torch.empty(nU + 2 * m_h + 8 * m_s + 1, dtype=torch.float32,
                      device=dev)
    bu, bh = out[:nU], out[nU:nU + 2 * m_h].view(2, m_h)
    bs = out[nU + 2 * m_h:nU + 2 * m_h + 8 * m_s].view(8, m_s)
    bres = out[-1:]
    bit = torch.empty(1, dtype=torch.int32, device=dev)
    _, loop = _lib_fns(m_s, nU)
    with torch.cuda.device(dev):
        rc = loop(*(_ptr(t) for t in (d.H, d.g, d.Gth, d.dh, d.Gts, d.sd,
                                      d.h0, d.s0, d.qs, bu, bh, bs, bres,
                                      bit, d.work)),
                  nU, m_h, m_s, float(tol), float(reg), int(max_iter),
                  int(stall_iters), float(stall_rtol), float(mu_grind),
                  lay.chunk, int(lay.resident), lay.group, lay.smem,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "ipm_mehrotra launch")
    build.count(LAUNCHES, "ipm_mehrotra")
    if nU > NU_NARROW:
        build.count(LAUNCHES_WIDE, "ipm_mehrotra", tally=False)
    best = (bu, bs[2], bs[3], bh[0], bh[1], bs[0], bs[4], bs[1], bs[5],
            bs[6], bs[7])
    return best, bres[0], bit[0]


def run_full(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu,
             ws, ws_valid, tol: float, reg: float, max_iter: int,
             stall_iters: int = 10, stall_rtol: float = 0.01,
             mu_grind: float = 1e-6, ws_band=(1e-8, 1e12)):
    """Prepare kernel then Mehrotra kernel, back to back on the current
    stream, with no host synchronization; CPU tensors take
    :func:`run_full_plain`.

    Returns ``(best_state_11tuple_scaled, best_res, iters, scale_h,
    scale_s)``.
    """
    if g.device.type == "cpu":
        return run_full_plain(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu,
                              ws, ws_valid, tol, reg, max_iter, stall_iters,
                              stall_rtol, mu_grind, ws_band)
    d = prepare(H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu, ws,
                ws_valid, ws_band)
    best, best_res, it = mehrotra(d, tol, reg, max_iter, stall_iters,
                                  stall_rtol, mu_grind)
    return best, best_res, it, d.sch, d.scs
