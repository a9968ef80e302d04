"""Condensing and QP assembly of one SQP iteration: CUDA kernel + plain
version.

Replaces no TPU kernel: the JAX package leaves this chain to XLA's fusion
(``sampling_gpmpc_tpu/ocp/condense.py``, ``ocp/assemble.py``).  From the
rows of ``Env.assemble_val_jac`` and the iterate it forms the condensing
maps T, Gamma and the QP of the iteration, ``solve_qp_soft``'s arguments
(H, g, C_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu).

:func:`assemble_plain` is the torch chain (``agent.dyn_linearization``,
``ocp/condense.py``, ``ocp/assemble.py``, ``ocp/qp.py::boxes_to_rows``).
:func:`assemble` runs it for CPU tensors and the CUDA kernel
(``csrc/glue.cu``: one CTA per sample; one launch, or two for a QP wider
than ``GRAM_NU``) for CUDA float32 tensors, and raises for anything else:
no fallback.  The kernel's outputs are views of one buffer.  Under a sample-axis group the kernel leaves the
replicated input block out of (H, g), and the wrapper adds it after the
psum, as ``build_cost`` does.
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch import agent, obs
from sampling_gpmpc_torch.ocp.assemble import (build_cost, build_hard_rows,
                                               build_soft_rows, input_cost,
                                               row_counts)
from sampling_gpmpc_torch.ocp.condense import condense_parallel
from sampling_gpmpc_torch.ocp.qp import boxes_to_rows
from sampling_gpmpc_torch.ops import build
from sampling_gpmpc_torch.parallel.collectives import make_reducers

LAUNCHES = {"glue_condense": 0, "glue_gram": 0}
MAX_CTAS = 264      # two CTAs per SM of the H100's 132; CTAs loop past it
# nU past which the cost forms in a second launch, a Gram product over the
# rows (csrc/glue.cu, 3): in the stages its sums grow as nU^2 a stage on
# the recursion's serial path
GRAM_NU = 64
TS = 32             # csrc/glue.cu's Gram tile
ALIGN = 64          # floats: every output starts 256-byte aligned
SMEM_LIMIT = build.SMEM_MAX - 1024   # the kernel's static word aside
# OCPData fields the kernel reads, in csrc/glue.cu GlueArgs' order
OCP_INPUTS = ("Qs", "Qe", "Qu", "xref", "w_cost", "lm", "u_lo", "u_hi",
              "x_lo", "x_hi", "fb_lo", "fb_hi", "K_fb", "x_eq", "P_term",
              "delta_sq", "ellipses")
PENALTIES = ("zl_term", "zu_term", "Zl_term", "Zu_term", "zl_path",
             "zu_path", "Zl_path", "Zu_path")

_LAYOUTS: dict = {}
_TICKETS: dict = {}
_FN: list = []


def assemble_plain(spec, ocp, combined, X, U, st_curr, group=None,
                   ordered: bool = False):
    """The torch chain of one SQP iteration after the linearization rows.

    Args:
        combined: (ns, H, nx, 1+nx+nu) rows of ``Env.assemble_val_jac``.
        X: (H+1, ns, nx) iterate; U: (H, nu); st_curr: (nx,) state.
    Returns:
        (qp, T, Gamma): ``qp`` the 11 arguments of ``solve_qp_soft``.
    """
    ns, nx = spec.ns, spec.nx
    with obs.span("glue.linearize"):
        val, A, B = agent.dyn_linearization(spec, combined, ocp.K_fb)
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


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def layout(spec, gram=None):
    """The kernel's layout for a problem: (smem_bytes, gram, shapes,
    offsets, total floats, gram_grid).  ``gram``: the wide branch (None:
    past ``GRAM_NU``, or where the narrow branch's sums do not fit).
    Shared memory holds the sample's rows and iterate, the double-buffered
    carry, Hx Gamma_k, the stage's small vectors, the OCP data the stages
    read (csrc/glue.cu's order) and, narrow, the sample's cost sums.  The
    outputs, T, Gamma and the workspace (narrow: ns slots of nU^2 + nU;
    wide: M, ns (H+1) nx rows of nU + 1) lie in one buffer, each
    ALIGN-aligned.  Raises ValueError for a problem the kernel cannot
    take."""
    H, nx, nu, ns, n_ell = spec.H, spec.nx, spec.nu, spec.ns, spec.n_ellipses
    key = (ns, H, nx, nu, n_ell, spec.use_feedback,
           spec.has_terminal_ellipse, gram)
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    if n_ell > 0 and nx < 2:
        raise ValueError(f"glue kernel: ellipse rows need nx >= 2, got {nx}")
    nU = H * nu
    base = (H * nx * (1 + nx + nu) + (H + 1) * nx + 2 * nx * (nU + 1)
            + nx * nU + nx * nx + nx * nu + 4 * nx + 1          # per stage
            + 3 * nx * nx + nu * nx + nx + 3 * (H + 1) * nx     # OCP data
            + 3 * H * nu + 5 * n_ell)
    acc = nU * nU + nU
    if gram is None:
        gram = nU > GRAM_NU or 4 * (base + acc) > SMEM_LIMIT
    smem = 4 * (base + (0 if gram else acc))
    if smem > SMEM_LIMIT:
        raise ValueError(f"glue kernel: a sample's stage rows need {smem} B "
                         f"of shared memory, past {SMEM_LIMIT} (H={H}, "
                         f"nx={nx}, nu={nu}, gram={gram})")
    m_h, m_s = row_counts(spec)
    work = ns * (H + 1) * nx * (nU + 1) if gram else ns * acc
    shapes = ((nU, nU), (nU,), (m_h, nU), (m_h,), (m_s, nU)) + ((m_s,),) * 6 \
        + ((ns, H + 1, nx), (ns, H + 1, nx, nU), (work,))
    offsets, total = [], 0
    for shape in shapes:
        offsets.append(total)
        total += -(-_numel(shape) // ALIGN) * ALIGN
    ntu, ntv = -(-nU // TS), -(-(nU + 1) // TS)
    gram_grid = sum(ntv - bu for bu in range(ntu)) if gram else 0
    out = (smem, gram, shapes, tuple(offsets), total, gram_grid)
    _LAYOUTS[key] = out
    return out


def _fn():
    """The kernel's C entry point, loaded and typed once."""
    if not _FN:
        fn = build.load("glue").glue_condense
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _ticket(dev, stream) -> torch.Tensor:
    """The last-CTA ticket of one stream: zeroed once, reset by the kernel
    (launches on one stream run one after the other)."""
    key = (dev.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS.setdefault(key, torch.zeros((1,), dtype=torch.int32,
                                                 device=dev))
    return t


def check_inputs(spec, ocp, combined, X, U, st_curr, dev):
    """The kernel's inputs in csrc/glue.cu's order, each checked: float32,
    on ``dev``, its shape, contiguous (ValueError naming the first that is
    not)."""
    ns, H, nx, nu = spec.ns, spec.H, spec.nx, spec.nu
    want = dict(Qs=(nx, nx), Qe=(nx, nx), Qu=(nu, nu), xref=(H + 1, nx),
                w_cost=(ns,), lm=(), u_lo=(nu,), u_hi=(nu,),
                x_lo=(H + 1, nx), x_hi=(H + 1, nx), fb_lo=(H, nu),
                fb_hi=(H, nu), K_fb=(nu, nx), x_eq=(nx,), P_term=(nx, nx),
                delta_sq=(), ellipses=(spec.n_ellipses, 5))
    ins = [("combined", combined, (ns, H, nx, 1 + nx + nu)),
           ("X", X, (H + 1, ns, nx)), ("U", U, (H, nu)),
           ("st_curr", st_curr, (nx,))]
    ins += [(f"ocp.{n}", getattr(ocp, n), want[n]) for n in OCP_INPUTS]
    ins += [(f"ocp.{n}", getattr(ocp, n), ()) for n in PENALTIES]
    for name, t, shape in ins:
        build.check_tensor(name, t, shape, dev)
    return [t for _, t, _ in ins]


def launch(spec, ocp, combined, X, U, st_curr, with_block: bool = True,
           gram=None):
    """One launch of the kernel (CUDA float32 tensors), and the Gram
    kernel's after it in the wide branch (``gram``, as :func:`layout`):
    ((H, g, C_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu), T, Gamma), views of
    one buffer; H and g without the input block unless ``with_block``."""
    dev = combined.device
    smem, gram, shapes, offsets, total, gram_grid = layout(spec, gram)
    ins = check_inputs(spec, ocp, combined, X, U, st_curr, dev)
    buf = torch.empty((total,), dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        ptrs = [t.data_ptr() for t in ins] + [base + 4 * o for o in offsets]
        ptrs.append(_ticket(dev, stream).data_ptr())
        dims = (spec.ns, spec.H, spec.nx, spec.nu, spec.n_ellipses,
                int(spec.use_feedback), int(spec.has_terminal_ellipse),
                int(with_block), int(gram), min(spec.ns, MAX_CTAS), smem,
                gram_grid)
        rc = _fn()((ctypes.c_void_p * len(ptrs))(*ptrs),
                   (ctypes.c_int * len(dims))(*dims), stream.cuda_stream)
    build.check(rc, "glue_condense launch")
    obs.count(LAUNCHES, "glue_condense")
    if gram:
        obs.count(LAUNCHES, "glue_gram")
    outs = [buf[o:o + _numel(s)].view(s) for o, s in zip(offsets, shapes)]
    return tuple(outs[:11]), outs[11], outs[12]


def assemble(spec, ocp, combined, X, U, st_curr, group=None,
             ordered: bool = False):
    """:func:`assemble_plain`'s result: the plain chain for CPU tensors,
    one :func:`launch` for CUDA float32 ones (ValueError for any other
    dtype, shape or layout the kernel does not take).  Under a group the
    launch leaves the input block out, and it is added after the psum."""
    dev = combined.device
    if dev.type == "cpu":
        return assemble_plain(spec, ocp, combined, X, U, st_curr, group,
                              ordered)
    if dev.type != "cuda":
        raise ValueError(f"glue: unsupported device {dev}")
    with obs.span("glue.condense"):
        qp, T, Gamma = launch(spec, ocp, combined, X, U, st_curr,
                              with_block=group is None)
    if group is not None:
        H_U, g_U = make_reducers(group, ordered)[0](qp[:2])
        H_in, g_in = input_cost(spec, ocp, U)
        qp = (H_U + H_in, g_U + g_in) + qp[2:]
    return qp, T, Gamma
