"""The least time the card could take for the glue layer's work of one SQP
iteration, from the configuration's sizes alone.

The glue's work in an iteration is the condensing and QP assembly and then
the step's consumption, whichever launches do it (on the card today
``glue_condense``, past nU = 64 ``glue_gram``, and ``glue_advance``).  The
counts are those the repository's chip smoke test gives each launch
(``chip_smoke.py::glue_bound`` and ``advance_bound``), written from the
sizes so that a change to how the kernels split, fuse or lay out the work
leaves the yardstick as it is:

* the condensing and assembly: the rows, the iterate and the OCP data read
  once; the QP tuple (H, g, C_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu), T
  and Gamma written once (a kernel's own workspace stays out); the
  recursion's, the cost's (the Gram product) and the rows' operations;
* the step: Gamma, T, the iterate and dU read once, the new iterate
  written once; the row dots, the candidate and the four squared norms.

The bound is the larger of bytes over the HBM bandwidth and operations
over the float32 rate (bounds.bound_s).  Imports nothing of the measured
program.
"""

from __future__ import annotations

from perfbench import bounds


def ellipses(ns: int, H: int, nx: int, m_s: int) -> int:
    """The obstacle ellipses of a QP of ``m_s`` soft rows: with obstacles
    it holds ns (H + 1) rows an ellipse and ns H nx state-box rows, and ns
    more for a terminal ellipse (the program's ``row_counts``); 0
    otherwise."""
    per = ns * (H + 1)
    for terminal in (0, ns):
        rest = m_s - terminal - ns * H * nx
        if rest > 0 and rest % per == 0:
            return rest // per
    return 0


def condense_bound(ns: int, H: int, nx: int, nu: int, m_h: int, m_s: int,
                   n_ell: int):
    """(bytes, operations) of one iteration's condensing and QP assembly,
    for a QP of m_h hard and m_s soft rows."""
    nU = H * nu
    inp = (ns * H * nx * (1 + nx + nu) + (H + 1) * ns * nx + H * nu + nx
           + 3 * nx * nx + nu * nu + 4 * (H + 1) * nx + 2 * H * nu + ns
           + nu * nx + 5 * n_ell)
    out = (nU * nU + nU + m_h * nU + m_h + m_s * nU + 6 * m_s
           + ns * (H + 1) * nx * (1 + nU))
    flops = 0
    for k in range(H + 1):
        kn = k * nu
        flops += ns * (2 * nx * nx * (kn + nu + 1)      # the recursion
                       + 2 * nx * nx * kn                # Hx Gamma
                       + nx * kn * (kn + 1)              # Gamma' Hx Gamma
                       + 2 * nx * nu * nU)               # feedback rows
    return 4 * (inp + out), flops


def advance_bound(ns: int, H: int, nx: int, nu: int):
    """(bytes, operations) of one iteration's step consumption."""
    rows = ns * (H + 1) * nx
    nU = H * nu
    return (4 * (rows * nU + 3 * rows + 3 * nU),
            2 * rows * nU + 6 * rows + 6 * nU)


def iteration_bound(sizes: dict):
    """(bytes, operations) of the glue's work in one SQP iteration:
    :func:`condense_bound` plus :func:`advance_bound` at the sizes (ns, H,
    nx, nu, m_h, m_s) of a configuration."""
    ns, H, nx, nu = sizes["ns"], sizes["H"], sizes["nx"], sizes["nu"]
    m_h, m_s = sizes["m_h"], sizes["m_s"]
    cb, cf = condense_bound(ns, H, nx, nu, m_h, m_s,
                            ellipses(ns, H, nx, m_s))
    ab, af = advance_bound(ns, H, nx, nu)
    return cb + ab, cf + af


def step_s(sizes: dict, it: int) -> float:
    """Bound of one MPC step's glue work over ``it`` SQP iterations."""
    return it * bounds.bound_s(*iteration_bound(sizes))
