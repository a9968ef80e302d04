"""Condensing and QP assembly of one SQP iteration: CUDA kernel + plain
version.

Replaces no TPU kernel: the JAX package leaves this chain to XLA's fusion
(``sampling_gpmpc_tpu/ocp/condense.py``, ``ocp/assemble.py``).  From the
rows of ``Env.assemble_val_jac`` and the iterate it forms the condensing
maps T, Gamma and the QP of the iteration, ``solve_qp_soft``'s arguments
(H, g, C_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu).

:func:`launch` runs the CUDA kernel (``csrc/glue.cu``: one CTA per
sample; one launch, or two for a QP wider than ``GRAM_NU``) on CUDA
float32 tensors, its outputs views of one buffer, and raises for anything
else.  Its plain twin and the choice between them are ``ocp/assemble.py``'s
(``assemble_iteration``, ``condensed_qp``).

:func:`advance` runs the same library's second kernel, the consumption of
the iteration's step (``glue_advance_kernel``, one CTA): from the QP's
solution, T and Gamma to the next iterate and the solve's scalars.  Its
plain twin and the choice are ``ocp/sqp.py``'s (``consume_step``,
``_advance``).
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch import obs
from sampling_gpmpc_torch.ops import build

LAUNCHES = {"glue_condense": 0, "glue_gram": 0, "glue_advance": 0}
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

# the advance kernel's outputs, in its buffer's order (ocp/sqp.py::
# consume_step's results, then the state's qp_valid and qp_iters)
ADVANCE_OUTPUTS = ("X", "U", "x_diff", "u_diff", "done", "best_step",
                   "stall_count", "mono_count", "alpha", "qp_valid",
                   "qp_iters")
_BYTES = {torch.float32: 4, torch.bool: 1, torch.int32: 4, torch.int64: 8}
_ARGTYPES = {
    "glue_condense": [ctypes.POINTER(ctypes.c_void_p),
                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
    "glue_advance": [ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]}

_LAYOUTS: dict = {}
_ADVANCE: dict = {}
_TICKETS: dict = {}
_FN: dict = {}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def layout(spec, rows, gram=None):
    """The kernel's layout for a problem of ``rows`` = (m_h, m_s) hard and
    soft QP rows (``ocp/assemble.py::row_counts``): (smem_bytes, gram,
    shapes, offsets, total floats, gram_grid).  ``gram``: the wide branch
    (None: past ``GRAM_NU``, or where the narrow branch's sums do not fit).
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
    m_h, m_s = rows
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


def _fn(name: str = "glue_condense"):
    """A C entry point of the library, loaded and typed once."""
    fn = _FN.get(name)
    if fn is None:
        fn = getattr(build.load("glue"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


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


def launch(spec, rows, ocp, combined, X, U, st_curr, with_block: bool = True,
           gram=None):
    """One launch of the kernel (CUDA float32 tensors; ValueError for any
    other device, dtype, shape or layout), and the Gram kernel's after it
    in the wide branch (``rows`` and ``gram`` as :func:`layout`): ((H, g,
    C_h, d_h, G_s, lo_s, hi_s, zl, zu, Zl, Zu), T, Gamma), views of one
    buffer; H and g without the input block unless ``with_block``."""
    dev = combined.device
    if dev.type != "cuda":
        raise ValueError(f"glue: unsupported device {dev}")
    smem, gram, shapes, offsets, total, gram_grid = layout(spec, rows, gram)
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


def advance_layout(spec, wide: bool):
    """The advance kernel's output buffer: (shapes, dtypes, offsets, total
    floats, plan), in ``ADVANCE_OUTPUTS``' order, each start ALIGN-aligned
    (256 bytes) in a float32 buffer; a bool takes a float's slot, and
    qp_iters is int64 where ``wide``, else int32.  ``plan``: how
    :func:`advance_views` cuts them."""
    key = ("advance", spec.ns, spec.H, spec.nx, spec.nu, wide)
    out = _LAYOUTS.get(key)
    if out is None:
        f32, i32 = torch.float32, torch.int32
        shapes = ((spec.H + 1, spec.ns, spec.nx), (spec.H, spec.nu)) \
            + ((),) * 9
        dtypes = (f32, f32, f32, f32, torch.bool, f32, i32, i32, f32,
                  torch.bool, torch.int64 if wide else i32)
        offsets, total, plan = [], 0, []
        for shape, dt in zip(shapes, dtypes):
            offsets.append(total)
            # (the buffer's dtype view, shape, strides, start in its units)
            plan.append((dt, shape, tuple(_numel(shape[d + 1:])
                                          for d in range(len(shape))),
                         4 * total // _BYTES[dt]))
            total += -(-_numel(shape) * _BYTES[dt] // (4 * ALIGN)) * ALIGN
        out = _LAYOUTS[key] = (shapes, dtypes, tuple(offsets), total,
                               tuple(plan))
    return out


def advance_views(buf, lay):
    """The outputs of :func:`advance_layout`'s ``lay`` in the float32
    buffer ``buf``: views at their offsets, shapes and dtypes."""
    typed = {torch.float32: buf, torch.bool: buf.view(torch.bool),
             torch.int32: buf.view(torch.int32)}
    if lay[1][-1] == torch.int64:
        typed[torch.int64] = buf.view(torch.int64)
    return tuple(typed[dt].as_strided(shape, stride, j) if shape
                 else typed[dt][j] for dt, shape, stride, j in lay[4])


def _advance_args(spec, stall, wide_it: bool, wide_q: bool, dev):
    """What one advance launch needs that its shape, constants and device
    fix, built once: (the inputs' (name, shape, dtype) in the C entry's
    order, the outputs' layout, their byte offsets, dims, fargs);
    ``stall`` = (window, shrink, recover window, min alpha)."""
    key = (spec.ns, spec.H, spec.nx, spec.nu, spec.tol_nlp, stall, wide_it,
           wide_q, dev.index)
    out = _ADVANCE.get(key)
    if out is None:
        ns, H, nx, nu = spec.ns, spec.H, spec.nx, spec.nu
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        window, shrink, recover, min_alpha = stall
        dims = (ns, H, nx, nu, int(window), int(recover), int(wide_it),
                int(wide_q), dev.index)
        lay = advance_layout(spec, wide_it or wide_q)
        ins = tuple(zip(
            ("X", "U", "T", "Gamma", "z", "status", "iters", "best_step",
             "stall_count", "mono_count", "alpha", "qp_iters"),
            ((H + 1, ns, nx), (H, nu), (ns, H + 1, nx),
             (ns, H + 1, nx, H * nu), (H * nu,), (), (), (), (), (), (), ()),
            (f32, f32, f32, f32, f32, i64, i64 if wide_it else i32, f32,
             i32, i32, f32, i64 if wide_q else i32)))
        out = _ADVANCE[key] = (
            ins, lay, tuple(4 * o for o in lay[2]),
            (ctypes.c_int * len(dims))(*dims),
            (ctypes.c_float * 3)(spec.tol_nlp, shrink, min_alpha))
    return out


def advance(spec, X, U, T, Gamma, z, status, iters, best_step, stall_count,
            mono_count, alpha, qp_iters, stall):
    """One launch of the step's consumption: ``ocp/sqp.py::consume_step``
    on X_cand = X + (T + Gamma dU)' and U_cand = U + dU (dU = z, the QP's
    solution), ok = (status == 0), with the state's scalars; ``stall`` =
    (STALL_WINDOW, STALL_SHRINK, RECOVER_WINDOW, MIN_ALPHA).  Float32 CUDA
    tensors, status int64, the counters int32, iters and qp_iters int32
    or int64; ValueError for any other device, dtype, shape or layout.
    Returns ``ADVANCE_OUTPUTS``' tensors, views of one new buffer; nothing
    given is written."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"glue: unsupported device {dev}")
    checks, lay, offsets, dims, fargs = _advance_args(
        spec, stall, iters.dtype == torch.int64,
        qp_iters.dtype == torch.int64, dev)
    ins = (X, U, T, Gamma, z, status, iters, best_step, stall_count,
           mono_count, alpha, qp_iters)
    for (name, shape, dtype), t in zip(checks, ins):
        build.check_tensor(name, t, shape, dev, dtype)
    buf = torch.empty((lay[3],), dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    ptrs = [t.data_ptr() for t in ins] + [base + o for o in offsets]
    rc = _fn("glue_advance")((ctypes.c_void_p * 23)(*ptrs), dims, fargs,
                             torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "glue_advance launch")
    obs.count(LAUNCHES, "glue_advance")
    return advance_views(buf, lay)
