"""The structured soft-constraint QP and its solution.

    min_u  0.5 u'Hu + g'u + sum_j [zl sl + 0.5 Zl sl^2 + zu su + 0.5 Zu su^2]
    s.t.   G_h u <= d_h,   lo_j - sl_j <= G_s u <= hi_j + su_j,  sl, su >= 0

``solve`` is a frozen plain copy of the measured program's Mehrotra
predictor-corrector method (row equilibration, central-path start at the
dual scale, analytic slack elimination, Jacobi-preconditioned Cholesky of
the Schur matrix, best-KKT iterate), always from a cold start.
``objective`` and ``hard_violation`` judge any u against the QP: the soft
slacks are set to their least values, so the objective is the QP's own.
"""

from __future__ import annotations

import torch

# float32 exit of the measured program and the float64 exit used here
TOL = {torch.float64: 1e-10, torch.float32: 3e-5}
STATUS_RTOL = 1e3
STALL_ITERS, STALL_RTOL, MU_GRIND = 10, 0.01, 1e-6


def objective(qp, u):
    """The QP's objective at u with the least slacks."""
    H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu = qp
    val = 0.5 * u @ (H @ u) + g @ u
    if lo_s.shape[0]:
        gs = G_s @ u
        sl = torch.clamp(lo_s - gs, min=0.0)
        su = torch.clamp(gs - hi_s, min=0.0)
        val = val + torch.sum(zl * sl + 0.5 * Zl * sl * sl
                              + zu * su + 0.5 * Zu * su * su)
    return val


def hard_violation(qp, u):
    """Largest violation of a hard row, relative to 1 + |bound|."""
    G_h, d_h = qp[2], qp[3]
    return torch.max(torch.clamp(G_h @ u - d_h, min=0.0)
                     / (1.0 + torch.abs(d_h)))


def _kkt(p, st):
    u, sl, su, th, lh, tU, lU, tL, lL, nl, nu_ = st
    H, g, G_h, d_h, G_s, lo_s, hi_s = p[:7]
    qscale = p[11]
    r_stat = torch.max(torch.abs(H @ u + g + G_h.T @ lh
                                 + G_s.T @ (lU - lL))) / qscale
    rp = [(G_h @ u + th - d_h) / (1.0 + torch.abs(d_h))]
    if lo_s.shape[0]:
        rp += [(G_s @ u - su + tU - hi_s) / (1.0 + torch.abs(hi_s)),
               (-(G_s @ u) - sl + tL + lo_s) / (1.0 + torch.abs(lo_s))]
    compl = (torch.dot(th, lh) + torch.dot(tU, lU) + torch.dot(tL, lL)
             + torch.dot(sl, nl) + torch.dot(su, nu_))
    m_total = d_h.shape[0] + 4 * lo_s.shape[0]
    res = torch.maximum(torch.maximum(r_stat, torch.max(torch.abs(
        torch.cat(rp)))), compl / (m_total * qscale))
    return res, compl


def solve(qp, max_iter: int = 150):
    """(u, status, iterations): status 0 when the best relative KKT
    residual is within STATUS_RTOL of the dtype's exit tolerance."""
    H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu = qp
    dtype, dev = g.dtype, g.device
    tol, reg = TOL[dtype], (1e-13 if dtype == torch.float64 else 1e-7)
    nU, m_s = g.shape[0], lo_s.shape[0]
    scale_h = torch.clamp(torch.amax(torch.abs(G_h), dim=1), min=1e-10)
    scale_s = (torch.clamp(torch.amax(torch.abs(G_s), dim=1), min=1e-10)
               if m_s else G_s.new_ones((0,)))
    G_h, d_h = G_h / scale_h[:, None], d_h / scale_h
    G_s = G_s / scale_s[:, None]
    lo_s, hi_s = lo_s / scale_s, hi_s / scale_s
    zl, zu = zl * scale_s, zu * scale_s
    Zl, Zu = Zl * scale_s ** 2, Zu * scale_s ** 2
    qscale = 1.0 + torch.max(torch.abs(g)) + torch.clamp(
        torch.max(zl) if m_s else g.new_zeros(()), min=0.0)
    p = (H, g, G_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu, qscale)
    mu0 = qscale
    th0 = torch.clamp(d_h, min=1.0)
    one = torch.ones((m_s,), dtype=dtype, device=dev)
    tU0 = torch.clamp(hi_s + 1.0, min=1.0)
    tL0 = torch.clamp(-lo_s + 1.0, min=1.0)
    st = (torch.zeros(nU, dtype=dtype, device=dev), one, one, th0, mu0 / th0,
          tU0, mu0 / tU0, tL0, mu0 / tL0, mu0 * one, mu0 * one)
    m_total = d_h.shape[0] + 4 * m_s
    eye = torch.eye(nU, dtype=dtype, device=dev)

    def max_step(st, d):
        a = torch.ones((), dtype=dtype, device=dev)
        for v, dv in zip(st[1:], d[1:]):
            if v.shape[0]:
                ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                                    torch.full_like(v, float("inf")))
                a = torch.minimum(a, torch.min(ratio))
        return 0.99 * a

    def factorize(st):
        u, sl, su, th, lh, tU, lU, tL, lL, nl, nu_ = st
        w_h = lh / th
        rp_h = G_h @ u + th - d_h
        M = H + (G_h.T * w_h) @ G_h
        soft = None
        if m_s:
            w_U, w_L, w_Pl, w_Pu = lU / tU, lL / tL, nl / sl, nu_ / su
            rp_U = G_s @ u - su + tU - hi_s
            rp_L = -(G_s @ u) - sl + tL + lo_s
            r2 = Zl * sl + zl - lL - nl
            r3 = Zu * su + zu - lU - nu_
            Dl, Du = Zl + w_L + w_Pl, Zu + w_U + w_Pu
            w_eff = w_U + w_L - w_U * w_U / Du - w_L * w_L / Dl
            soft = (w_U, w_L, w_Pl, w_Pu, rp_U, rp_L, r2, r3, Dl, Du)
            M = M + (G_s.T * w_eff) @ G_s
        r1 = H @ u + g + G_h.T @ lh + G_s.T @ (lU - lL)
        inv_s = torch.rsqrt(torch.clamp(torch.diagonal(M), min=1e-30))
        L, info = torch.linalg.cholesky_ex(inv_s[:, None] * M * inv_s[None, :]
                                           + reg * eye)
        L = torch.where(info != 0, torch.full_like(L, float("nan")), L)
        return w_h, rp_h, r1, soft, inv_s, L

    def direction(st, aux, sig_mu, corr):
        u, sl, su, th, lh, tU, lU, tL, lL, nl, nu_ = st
        w_h, rp_h, r1, soft, inv_s, L = aux
        ch, cU, cL, cPl, cPu = corr if corr is not None else (0.,) * 5
        b_h = (lh * th - sig_mu + ch) / th
        rhs = -r1 + G_h.T @ (b_h - w_h * rp_h)
        if m_s:
            (w_U, w_L, w_Pl, w_Pu, rp_U, rp_L, r2, r3, Dl, Du) = soft
            b_U = (lU * tU - sig_mu + cU) / tU
            b_L = (lL * tL - sig_mu + cL) / tL
            b_Pl = (nl * sl - sig_mu + cPl) / sl
            b_Pu = (nu_ * su - sig_mu + cPu) / su
            cl = -r2 - b_L - b_Pl + w_L * rp_L
            cu = -r3 - b_U - b_Pu + w_U * rp_U
            rhs = rhs - G_s.T @ (-b_U + b_L + w_U * rp_U - w_L * rp_L
                                 - w_U * cu / Du + w_L * cl / Dl)
        du = inv_s * torch.cholesky_solve((inv_s * rhs)[:, None], L)[:, 0]
        dth = -(G_h @ du) - rp_h
        dlh = -b_h - w_h * dth
        if m_s:
            gsdu = G_s @ du
            dsl = (cl - w_L * gsdu) / Dl
            dsu = (cu + w_U * gsdu) / Du
            dtU = -gsdu + dsu - rp_U
            dtL = gsdu + dsl - rp_L
            return (du, dsl, dsu, dth, dlh, dtU, -b_U - w_U * dtU, dtL,
                    -b_L - w_L * dtL, -b_Pl - w_Pl * dsl, -b_Pu - w_Pu * dsu)
        return (du, sl, sl, dth, dlh, sl, sl, sl, sl, sl, sl)

    best = st
    best_res = torch.tensor(float("inf"), dtype=dtype, device=dev)
    csum = _kkt(p, st)[1]
    it, since = 0, 0
    while it < max_iter:
        mu = csum / m_total
        aux = factorize(st)
        d_aff = direction(st, aux, 0.0, None)
        a_aff = max_step(st, d_aff)
        mu_aff = _kkt(p, tuple(v + a_aff * dv
                               for v, dv in zip(st, d_aff)))[1] / m_total
        sigma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
        corr = (d_aff[4] * d_aff[3], d_aff[6] * d_aff[5], d_aff[8] * d_aff[7],
                d_aff[9] * d_aff[1], d_aff[10] * d_aff[2])
        d = direction(st, aux, sigma * mu, corr)
        alpha = max_step(st, d)
        st_n = tuple(v + alpha * dv for v, dv in zip(st, d))
        ok = all(bool(torch.isfinite(v).all()) for v in st_n)
        it += 1
        if ok:
            st = st_n
        res, csum = _kkt(p, st)
        if not ok:
            res = torch.full_like(best_res, float("inf"))
        if bool(res < best_res):
            best = st
        meaningful = bool(res < best_res * (1.0 - STALL_RTOL))
        best_res = torch.minimum(res, best_res)
        grinding = bool(csum / m_total < MU_GRIND * mu0)
        since = 0 if (meaningful or not grinding) else since + 1
        live = ok and bool(csum / m_total > 1e-14 * mu0)
        if dtype != torch.float64:
            live = live and since < STALL_ITERS
        if not live or bool(best_res <= tol):
            break
    status = 0 if float(best_res) <= tol * STATUS_RTOL else 4
    return best[0], status, it
