"""The least time the card could take for the GP and QP layers' work.

Copied from the arithmetic the repository's chip smoke test uses: bytes
count each input once and each output once, operations count the float32
arithmetic the algorithm needs at the layer's own shapes and iteration
counts, and the bound is the larger of bytes over the HBM bandwidth and
operations over the float32 rate.  Peaks: NVIDIA H100 SXM data sheet,
HBM3 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores (at the
full 700 W power limit).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def gp_sample_bound(ns: int, Ht: int, R: int):
    """(bytes, operations) of the empty-buffer GP stage of one output."""
    nbytes = 4 * (ns * Ht * R + ns * Ht * Ht + ns * Ht + R * R + R + Ht
                  + ns * Ht)
    flops = ns * (2 * R * R * Ht + 2 * R * Ht + R * Ht * (Ht + 1)
                  + Ht ** 3 / 3 + Ht * Ht)
    return nbytes, flops


def gp_hall_bound(ns: int, Ht: int, Rr: int, nh: int):
    """(bytes, operations) of the hall-conditioned GP stage of one output
    at fill nh: the filled part of each input read once, the draws written
    once; the products, both factorizations, the substitution, the fold
    and the draw."""
    nbytes = 4 * (ns * (Ht * Rr + Ht * nh + Ht * Ht + Rr * nh + nh * nh + nh
                        + Ht) + Rr * Rr + Rr + Ht + ns * Ht)
    flops = ns * (2 * Rr * Rr * nh + 2 * Rr * Rr * Ht + Rr * nh * (nh + 1)
                  + 2 * Ht * Rr * nh + 2 * Rr * nh + Rr * Ht * (Ht + 1)
                  + 2 * Rr * Ht + nh ** 3 / 3 + (Ht + 1) * nh * nh
                  + Ht * (Ht + 1) * nh + 2 * Ht * nh + Ht ** 3 / 3 + Ht * Ht)
    return nbytes, flops


def prepare_bound(nU: int, m_h: int, m_s: int, warm: bool = True):
    """(bytes, operations) of the QP's prepare stage (equilibration, cold
    start, and with ``warm`` the carried warm start's three matvecs)."""
    m = m_h + m_s
    nbytes = 4 * (nU * nU + nU + 2 * nU * m + m_h + 6 * m_s
                  + (nU + m_h + 6 * m_s if warm else 0)
                  + 4 * m_h + 16 * m_s + 1 + m + 1)
    flops = 4 * nU * m + (6 * nU * m if warm else 0)
    return nbytes, flops


def mehrotra_bound(nU: int, m_h: int, m_s: int, iters: float):
    """(bytes, operations) of the QP's Mehrotra loop over ``iters``
    iterations: the Schur matrix, its Cholesky and the row products of
    each iteration."""
    m = m_h + m_s
    nbytes = 4 * (nU * nU + nU + nU * m + 4 * m_h + 16 * m_s + 1
                  + nU + 2 * m_h + 8 * m_s + 2)
    flops = iters * (nU * (nU + 1) * m + 9 * 2 * nU * m + nU ** 3 / 3
                     + 4 * nU * nU + 60 * m)
    return nbytes, flops


def gp_step_s(sizes: dict, it: int) -> float:
    """Bound of one MPC step's GP stages over ``it`` SQP iterations: the
    empty-buffer stage, then the hall stage at fill i H Ty, each for every
    output."""
    ns, g_ny, Ty, R = sizes["ns"], sizes["g_ny"], sizes["Ty"], sizes["R"]
    Ht = sizes["H"] * Ty
    total = 0.0
    for i in range(it):
        nb, fl = (gp_sample_bound(ns, Ht, R) if i == 0 else
                  gp_hall_bound(ns, Ht, R, i * Ht))
        total += bound_s(g_ny * nb, g_ny * fl)
    return total


def qp_step_s(sizes: dict, it: int, qp_iters: int) -> float:
    """Bound of one MPC step's ``it`` QPs (one per SQP iteration), each
    prepared with the carried warm start and given the step's mean
    Mehrotra iteration count (exact with one QP a step, or where the loop
    is bound by operations at one iteration)."""
    nU, m_h, m_s = sizes["nU"], sizes["m_h"], sizes["m_s"]
    if it == 0:
        return 0.0
    per = qp_iters / it
    return it * (bound_s(*prepare_bound(nU, m_h, m_s))
                 + bound_s(*mehrotra_bound(nU, m_h, m_s, per)))
