"""Assembly of the condensed QP from the linearized augmented OCP.

Linear algebra over the condensing maps ``dx_{i,k} = T[i,k] + Gamma[i,k] dU``
(see condense.py): the quadratic cost, the hard two-sided rows (input box,
per-sample state box, realized feedback-input rows) and the soft rows
(terminal ellipse, obstacle ellipses) with acados' z/Z slack penalties.
Replaces acados' OCP-QP interface + HPIPM condensing (ref: src/utils/ocp.py).
:func:`condensed_qp`, which ``ocp/sqp.py`` calls, launches this module's
chain as one kernel (``ops/glue.py``) where ``build.kernel_route`` says,
else runs it (:func:`assemble_iteration`).

Shapes:  T (ns, H+1, nx),  Gamma (ns, H+1, nx, nU),  Xbar (H+1, ns, nx),
         Ubar (H, nu),  nU = H*nu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sampling_gpmpc_torch import obs
from sampling_gpmpc_torch.config import ProblemSpec
from sampling_gpmpc_torch.ocp.condense import condense_parallel
from sampling_gpmpc_torch.ocp.qp import boxes_to_rows
from sampling_gpmpc_torch.ocp.spec import OCPData
from sampling_gpmpc_torch.ops import build, glue
from sampling_gpmpc_torch.parallel.collectives import make_reducers


class Rows(NamedTuple):
    G: torch.Tensor    # (m, nU)
    lo: torch.Tensor   # (m,)
    hi: torch.Tensor   # (m,)


def row_counts(spec: ProblemSpec):
    """(canonical-hard, soft) row counts of the condensed QP; mirrors
    build_hard_rows/build_soft_rows (sizes the carried QP warm start)."""
    nU = spec.H * spec.nu
    n_hard = nU
    if spec.n_ellipses == 0:
        n_hard += spec.ns * spec.H * spec.nx
    if spec.use_feedback:
        n_hard += spec.ns * spec.H * spec.nu
    m_s = 0
    if spec.has_terminal_ellipse:
        m_s += spec.ns
    if spec.n_ellipses > 0:
        m_s += spec.ns * (spec.H + 1) * spec.n_ellipses
        m_s += spec.ns * spec.H * spec.nx
    return 2 * n_hard, m_s


def build_cost(spec: ProblemSpec, ocp: OCPData, T, Gamma, Xbar, Ubar,
               group=None, ordered: bool = False):
    """Condensed Hessian/gradient of the (expected) tracking cost + LM.

    Per stage k and sample i the x-block Hessian is 2 w_i Q_k + lm I and the
    gradient 2 w_i Q_k (x̄+T-xref) + lm T, both pulled through Gamma; the LM
    term regularizes the QP variable dx = T + Gamma dU toward zero like
    acados adds lm*I to every stage Hessian (ref: src/utils/ocp.py:303-306).

    Under a sample-axis ``group`` the per-sample x-contributions are summed
    over the shards (one tuple-psum) before the replicated input blocks are
    added once.
    """
    H, nx = spec.H, spec.nx
    dtype, dev = T.dtype, T.device
    Qk = torch.cat([ocp.Qs[None].expand(H, nx, nx), ocp.Qe[None]])  # (H+1,nx,nx)
    Hx = (2.0 * ocp.w_cost[:, None, None, None] * Qk[None]
          + ocp.lm * torch.eye(nx, dtype=dtype, device=dev)[None, None])
    xerr = Xbar.transpose(0, 1) + T - ocp.xref[None]            # (ns, H+1, nx)
    grad_x = (2.0 * ocp.w_cost[:, None, None]
              * torch.einsum("kab,ikb->ika", Qk, xerr) + ocp.lm * T)
    H_U = torch.einsum("ikau,ikab,ikbv->uv", Gamma, Hx, Gamma)
    g_U = torch.einsum("ikau,ika->u", Gamma, grad_x)
    H_U, g_U = make_reducers(group, ordered)[0]((H_U, g_U))
    H_in, g_in = input_cost(spec, ocp, Ubar)
    return H_U + H_in, g_U + g_in


def input_cost(spec: ProblemSpec, ocp: OCPData, Ubar):
    """The condensed cost's replicated input blocks: kron(I_H, 2 Qu + lm I)
    and 2 Ubar Qu."""
    H, nu = spec.H, spec.nu
    dtype, dev = Ubar.dtype, Ubar.device
    Hu = 2.0 * ocp.Qu + ocp.lm * torch.eye(nu, dtype=dtype, device=dev)
    return (torch.kron(torch.eye(H, dtype=dtype, device=dev), Hu),
            (2.0 * Ubar @ ocp.Qu).reshape(H * nu))


def build_hard_rows(spec: ProblemSpec, ocp: OCPData, T, Gamma, Xbar,
                    Ubar) -> Rows:
    H, nx, nu, ns = spec.H, spec.nx, spec.nu, spec.ns
    nU = H * nu
    xpred = Xbar.transpose(0, 1) + T            # (ns, H+1, nx)
    sel = torch.eye(nU, dtype=T.dtype, device=T.device)
    rows_G = [sel]
    rows_lo = [(ocp.u_lo[None] - Ubar).reshape(nU)]
    rows_hi = [(ocp.u_hi[None] - Ubar).reshape(nU)]

    # per-sample state box, stages 1..H; soft when ellipse obstacles exist
    if spec.n_ellipses == 0:
        rows_G.append(Gamma[:, 1:].reshape(ns * H * nx, nU))
        rows_lo.append((ocp.x_lo[None, 1:] - xpred[:, 1:]).reshape(-1))
        rows_hi.append((ocp.x_hi[None, 1:] - xpred[:, 1:]).reshape(-1))

    if spec.use_feedback:
        # realized input u_fb = -K(x_eq - x_i,k) + u_k, stages 0..H-1
        # (ref: src/utils/ocp.py:63-91); rows: K Gamma + selector
        KG = torch.einsum("ua,ikab->ikub", ocp.K_fb, Gamma[:, :H])
        G_fb = (KG + sel.reshape(H, nu, nU)[None]).reshape(ns * H * nu, nU)
        h_bar = Ubar[None] - (ocp.x_eq[None, None] - xpred[:, :H]) @ ocp.K_fb.T
        rows_G.append(G_fb)
        rows_lo.append((ocp.fb_lo[None] - h_bar).reshape(-1))
        rows_hi.append((ocp.fb_hi[None] - h_bar).reshape(-1))

    return Rows(torch.cat(rows_G), torch.cat(rows_lo), torch.cat(rows_hi))


def build_soft_rows(spec: ProblemSpec, ocp: OCPData, T, Gamma, Xbar):
    """Soft rows + their (zl, zu, Zl, Zu) penalty vectors."""
    H, nx, ns = spec.H, spec.nx, spec.ns
    nU = H * spec.nu
    dtype, dev = T.dtype, T.device
    xpred = Xbar.transpose(0, 1) + T
    G_list, lo_list, hi_list, pen = [], [], [], []

    if spec.has_terminal_ellipse:
        # (x_H - xf)' P (x_H - xf) in [0, delta^2], linearized at the iterate
        # (ref: src/utils/ocp.py:94-104,201-215)
        xe = Xbar.transpose(0, 1)[:, H] - ocp.x_eq[None]         # (ns, nx)
        q0 = torch.einsum("ia,ab,ib->i", xe, ocp.P_term, xe)
        J = 2.0 * xe @ ocp.P_term
        G_list.append(torch.einsum("ia,iau->iu", J, Gamma[:, H]))
        const = q0 + torch.einsum("ia,ia->i", J, T[:, H])
        lo_list.append(0.0 - const)
        hi_list.append(ocp.delta_sq - const)
        pen.append((ocp.zl_term, ocp.zu_term, ocp.Zl_term, ocp.Zu_term, ns))

    if spec.n_ellipses > 0:
        # obstacle ellipses (X-x0)^2/a + (Y-y0)^2/b >= f per sample+stage
        # (ref: src/utils/ocp.py:43-58,223-229)
        e = ocp.ellipses
        X0, Y0, a, b, fval = e[:, 0], e[:, 1], e[:, 2], e[:, 3], e[:, 4]
        px = xpred[:, :, 0][:, :, None] - X0[None, None]
        py = xpred[:, :, 1][:, :, None] - Y0[None, None]
        q0 = px * px / a + py * py / b
        Jx, Jy = 2 * px / a, 2 * py / b
        G = (Jx[..., None] * Gamma[:, :, 0][:, :, None, :]
             + Jy[..., None] * Gamma[:, :, 1][:, :, None, :])
        nrow = ns * (H + 1) * spec.n_ellipses
        G_list.append(G.reshape(nrow, nU))
        lo_list.append((fval[None, None] - q0).reshape(nrow))
        hi_list.append(torch.full((nrow,), 1e8, dtype=dtype, device=dev))
        pen.append((ocp.zl_path, ocp.zu_path, ocp.Zl_path, ocp.Zu_path, nrow))
        G_list.append(Gamma[:, 1:].reshape(ns * H * nx, nU))
        lo_list.append((ocp.x_lo[None, 1:] - xpred[:, 1:]).reshape(-1))
        hi_list.append((ocp.x_hi[None, 1:] - xpred[:, 1:]).reshape(-1))
        pen.append((ocp.zl_path, ocp.zu_path, ocp.Zl_path, ocp.Zu_path,
                    ns * H * nx))

    if not G_list:
        z = torch.zeros((0,), dtype=dtype, device=dev)
        return (Rows(torch.zeros((0, nU), dtype=dtype, device=dev), z, z),
                (z, z, z, z))

    def cat_pen(i):
        return torch.cat([p[i].expand(p[4]) for p in pen])

    return (Rows(torch.cat(G_list), torch.cat(lo_list), torch.cat(hi_list)),
            (cat_pen(0), cat_pen(1), cat_pen(2), cat_pen(3)))


def assemble_canonical(H_U, g_U, hard: Rows, soft: Rows, penalties):
    """Canonical QP over z = [dU; s_l; s_u]:  min 0.5 z'Pz + q'z, Cz <= d,
    the input of the generic ``qp.solve_qp`` (counterpart of the JAX
    package's ``ocp/assemble.py::assemble_canonical``).

    Soft row j relaxes to  lo_j - s_l <= G_j dU <= hi_j + s_u,  s >= 0,
    with cost z's + 0.5 s'Z s (acados convention, ref: ocp.py:205-215).
    """
    zl, zu, Zl, Zu = penalties
    nU = g_U.shape[0]
    m_s = soft.G.shape[0]
    dtype, dev = g_U.dtype, g_U.device
    nz = nU + 2 * m_s
    P = torch.zeros((nz, nz), dtype=dtype, device=dev)
    P[:nU, :nU] = H_U
    if m_s:
        P[nU:, nU:] = torch.diag(torch.cat([Zl, Zu]))
    q = torch.cat([g_U, zl, zu])
    Zb = torch.zeros((hard.G.shape[0], m_s), dtype=dtype, device=dev)
    eye = torch.eye(m_s, dtype=dtype, device=dev)
    Z0 = torch.zeros((m_s, m_s), dtype=dtype, device=dev)
    C = torch.cat([
        torch.cat([hard.G, Zb, Zb], dim=1),
        torch.cat([-hard.G, Zb, Zb], dim=1),
        torch.cat([soft.G, Z0, -eye], dim=1),
        torch.cat([-soft.G, -eye, Z0], dim=1),
        torch.cat([torch.zeros((2 * m_s, nU), dtype=dtype, device=dev),
                   -torch.eye(2 * m_s, dtype=dtype, device=dev)], dim=1),
    ])
    d = torch.cat([hard.hi, -hard.lo, soft.hi, -soft.lo,
                   torch.zeros(2 * m_s, dtype=dtype, device=dev)])
    return P, q, C, d


def dyn_linearization(spec: ProblemSpec, combined: torch.Tensor, K_fb):
    """Per-sample per-stage (value, A, B) from the rows of
    ``Env.assemble_val_jac``, with the feedback chain rule A <- A + B K
    (ref: src/agent.py:532-564).

    Args:
        combined: (ns, H, nx, 1+nx+nu) [value, d/dx, d/du] rows.
    Returns:
        val (ns, H, nx), A (ns, H, nx, nx), B (ns, H, nx, nu).
    """
    val = combined[..., 0]
    A = combined[..., 1:1 + spec.nx]
    B = combined[..., 1 + spec.nx:]
    if spec.use_feedback:
        A = A + B @ K_fb
    return val, A, B


def assemble_iteration(spec: ProblemSpec, ocp: OCPData, combined, X, U,
                       st_curr, group=None, ordered: bool = False):
    """The torch chain of one SQP iteration after the linearization rows.

    Args:
        combined: (ns, H, nx, 1+nx+nu) rows of ``Env.assemble_val_jac``.
        X: (H+1, ns, nx) iterate; U: (H, nu); st_curr: (nx,) state.
    Returns:
        (qp, T, Gamma): ``qp`` the 11 arguments of ``solve_qp_soft``.
    """
    ns, nx = spec.ns, spec.nx
    with obs.span("glue.linearize"):
        val, A, B = dyn_linearization(spec, combined, ocp.K_fb)
        # delta dynamics dx_{k+1} = A dx_k + B du_k + r_k,
        # r = f_lin - x̄_{k+1}
        r = val - X[1:].transpose(0, 1)
        dx0 = st_curr[None].expand(ns, nx) - X[0]
    with obs.span("glue.condense"):
        T, Gamma = condense_parallel(A, B, r, dx0)
    with obs.span("glue.assemble"):
        H_U, g_U = build_cost(spec, ocp, T, Gamma, X, U, group, ordered)
        hard = build_hard_rows(spec, ocp, T, Gamma, X, U)
        soft, (zl, zu, Zl, Zu) = build_soft_rows(spec, ocp, T, Gamma, X)
        C_h, d_h = boxes_to_rows(hard.G, hard.lo, hard.hi)
    return (H_U, g_U, C_h, d_h, soft.G, soft.lo, soft.hi, zl, zu, Zl,
            Zu), T, Gamma


def condensed_qp(spec: ProblemSpec, ocp: OCPData, combined, X, U, st_curr,
                 group=None, ordered: bool = False):
    """:func:`assemble_iteration`'s result: one launch of the glue kernel
    on ``build.kernel_route("glue", ...)``, the chain off it.  Under a
    group the launch leaves the input block out, and it is added after the
    psum, as :func:`build_cost` does."""
    if not build.kernel_route("glue", combined.device):
        return assemble_iteration(spec, ocp, combined, X, U, st_curr, group,
                                  ordered)
    with obs.span("glue.condense"):
        qp, T, Gamma = glue.launch(spec, row_counts(spec), ocp, combined, X,
                                   U, st_curr, with_block=group is None)
    if group is not None:
        H_U, g_U = make_reducers(group, ordered)[0](qp[:2])
        H_in, g_in = input_cost(spec, ocp, U)
        qp = (H_U + H_in, g_U + g_in) + qp[2:]
    return qp, T, Gamma
