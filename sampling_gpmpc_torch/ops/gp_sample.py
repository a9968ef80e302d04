"""Fused empty-hallucination GP sample stage: CUDA kernel + plain version.

Port of ``sampling_gpmpc_tpu/ops/pallas_gp.py`` (``_kernel`` and
``sample_empty_one``).  For one GP output and every sample i it computes,
from the masked cross-covariance rows Kx_i and the test block Ktt_i:

    V = Linv Kx_i',  G = V'V,  mean = Kx_i alpha,  cov = Ktt_i - G + J,
    L = chol(cov),   y = mean + L eps_i,   then the override tail,

J diagonal, each row's jitter :func:`row_jitter`: in float32 at least
``JITTER_REL`` of the prior variance of the row's task, so that it stays
above the float32 rounding of Ktt_i - G and rounding does not decide
whether the factor fails.

One deliberate difference from the float64 reference path
(``gp/exact.py`` predict_real + sample_with_overrides), shared by the kernel
and its plain version: the triangular solve against the fixed real-data
factor is a matmul with the precomputed ``Linv``.  As there, a covariance
factor that fails (a non-positive pivot) is retried with ten times each
row's jitter within ``safe_cholesky``'s float32 cap (:func:`factor_retried`;
the TPU kernel has no retry, and at ``params_car``'s GP its float32
covariance fails at the first jitter); one that fails at every jitter
gives NaN, and NaN entries fall back to the mean.  The Cholesky is the
right-looking blocked factor in panels of ``panel`` columns
(:func:`factor_panels`, which ``gp_hall`` and ``batch_linalg`` share);
panel width 1 is the column sweep of the earlier design, the kernel runs
width 32.

:func:`sample_empty` takes every GP output at once (inputs stacked on a
leading output axis) and runs the CUDA kernel (``csrc/gp_sample.cu``: one
launch, one CTA per (output, sample)) where ``build.kernel_route`` says,
else the plain version; :func:`sample_empty_one` is its one-output case.
Neither falls back: a kernel-route stage the kernel cannot take raises
(:func:`check_supported`).
"""

from __future__ import annotations

import ctypes

import torch

from sampling_gpmpc_torch import obs
from sampling_gpmpc_torch.ops import build

LAUNCHES = {"gp_sample": 0}
PANEL = 32          # the kernels' tile and panel width (csrc/common.cuh TB)
TILE_FLOATS = PANEL * (PANEL + 1)
# per-output arguments of sample_empty_one, stacked on a leading axis by
# sample_empty
STACKED = ("Kxm", "Ktt", "eps", "Linv", "alpha", "prior_var", "close",
           "ynear")
# csrc/gp_sample.cu: the product's tile and depth; the two stages (each a
# chunk of Kx_i, of Linv and of alpha) and the mean's partial sums
_PT, _PK = 64, 32
_STAGE_FLOATS = 2 * (2 * _PT * (_PK + 1) + _PK) + 4 * _PT
# The float32 covariance's first jitter on a row is at least this share of
# the prior variance of the row's task: at params_car's GP stages the
# float32 rounding of the covariance gives it smallest eigenvalues down to
# -1.7e-6 in those units, which the configured jitter (1e-6 absolute)
# does not cover, so that whether a factor failed, and the draw, which
# differs by 0.2-0.7 of the tube between the first jitter and the second,
# was decided by rounding
JITTER_REL = 1e-5


def sample_layout(Ht: int):
    """Where one CTA keeps its regions (csrc/gp_sample.cu): the staged
    chunks always in shared memory; the mean, variance and draw rows, the
    64-column block of V', the covariance's lower tiles and Ktt_i's, in
    that order, each in shared memory while it fits and in the CTA's
    region of the global workspace otherwise.  Returns (smem_bytes,
    work_floats per CTA, (rows, V' block, tiles, Ktt tiles) global
    flags)."""
    t = -(-Ht // PANEL)
    tiles = t * (t + 1) // 2 * TILE_FLOATS
    sizes = (3 * Ht, t * PANEL * (_PT + 1), tiles, tiles)
    smem, work, glob = _STAGE_FLOATS, 0, []
    for n in sizes:
        g = 4 * (smem + n) > build.SMEM_MAX
        glob.append(g)
        if g:
            work += n
        else:
            smem += n
    return 4 * smem, work, tuple(glob)


def check_supported(Ht: int, R: int, dtype) -> None:
    """Raise ValueError naming the limit when the kernel cannot take a
    stage: float32 only, 1 <= Ht and 1 <= R.  Every such shape runs:
    shared memory grows with Ht^2 only, and what does not fit goes to the
    global workspace (:func:`sample_layout`)."""
    if dtype != torch.float32:
        raise ValueError(f"gp_sample kernel takes float32 only, got {dtype}; "
                         "run float64 with device='cpu'")
    if Ht < 1 or R < 1:
        raise ValueError(f"gp_sample: need 1 <= Ht and 1 <= R, got Ht={Ht}, "
                         f"R={R}")


def chol_right_looking(A: torch.Tensor) -> torch.Tensor:
    """Batched right-looking Cholesky, the kernel's own column sweep:
    l = A[j:, j] / sqrt(A[j, j]), trailing block -= l l'.  A non-positive
    pivot gives NaN from that column on (no retry)."""
    A = A.clone()
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        r = 1.0 / torch.sqrt(A[..., j, j])
        col = A[..., j:, j] * r[..., None]
        L[..., j:, j] = col
        A[..., j + 1:, j + 1:] -= col[..., 1:, None] * col[..., None, 1:]
    return L


def subst_right_looking(W: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """W L^-T for a batch of lower factors L, column by column as the kernel
    sweeps: column j is divided by L[j, j], then subtracted, scaled by
    L[k, j], from every later column k."""
    W = W.clone()
    for j in range(L.shape[-1]):
        W[..., j] = W[..., j] / L[..., j, j][..., None]
        W[..., j + 1:] -= W[..., j:j + 1] * L[..., None, j + 1:, j]
    return W


def factor_panels(A, c0: int, c1: int, n: int, panel: int):
    """Right-looking blocked Cholesky, in place, of columns [c0, c1) of
    A[..., :n, :n] (symmetric, its earlier columns already eliminated):
    per panel of ``panel`` columns, the diagonal block's column sweep, the
    rows below solved against it, the trailing block updated.  A
    non-positive pivot gives NaN from that column on."""
    for k0 in range(c0, c1, panel):
        k1 = min(k0 + panel, c1)
        L = chol_right_looking(A[..., k0:k1, k0:k1])
        P = subst_right_looking(A[..., k1:n, k0:k1], L)
        A[..., k0:k1, k0:k1] = L
        A[..., k1:n, k0:k1] = P
        A[..., k1:n, k1:n] -= P @ P.transpose(-1, -2)
    return A


def row_jitter(jitter: float, prior_var):
    """The first jitter on each row of a stage's covariance, (..., Ht) as
    ``prior_var``: in float32 the larger of ``jitter`` and ``JITTER_REL``
    times the row's prior variance (the kernels' ``sgp::row_jitter``), in
    float64 ``jitter`` alone."""
    if prior_var.dtype != torch.float32:
        return torch.full_like(prior_var, jitter)
    return torch.clamp(JITTER_REL * prior_var, min=jitter)


def factor_retried(M, c0: int, n: int, base, added: bool, var, jit0,
                   panel: int):
    """Columns [c0, n) of M factored by :func:`factor_panels`, in place,
    their block M[..., c0:n, c0:n] holding the covariance plus each row's
    first jitter ``jit0`` (n - c0,) on its diagonal.  A sample whose factor
    failed (a non-positive pivot: its last diagonal entry is not finite)
    is factored again from ``base`` (that block before the factor, holding
    ``jit0`` on its diagonal where ``added``) with ten times every row's
    jitter, while ten times the largest stays within max(1e-3 x the mean
    of ``var``, 1e-2): ``exact.safe_cholesky``'s float32 rule, as the
    kernels retry.  A sample that fails at every jitter keeps its first
    factor, NaN from the failing column on, for the non-finite -> mean
    backstop."""
    factor_panels(M, c0, n, n, panel)
    first = M.clone()
    cap = torch.clamp(1e-3 * var.mean(-1), min=1e-2)
    mult = torch.ones_like(cap)
    jmax = jit0.max()
    while True:
        failed = ~torch.isfinite(M[..., n - 1, n - 1])
        retry = failed & (mult * 10.0 * jmax <= cap)
        if not bool(retry.any()):
            M[failed] = first[failed]
            return M
        mult = torch.where(retry, mult * 10.0, mult)
        d = mult[retry][:, None] * jit0
        Mr = M[retry]
        Mr[..., c0:n, c0:n] = base[retry] + torch.diag_embed(
            d - jit0 if added else d)
        M[retry] = factor_panels(Mr, c0, n, n, panel)


def sample_empty_plain(Kxm, Ktt, eps, Linv, alpha, prior_var, jitter: float,
                       beta: float, var_zero: float, rel_floor: float,
                       ty: int = 1, close=None, ynear=None,
                       panel: int = PANEL):
    """Plain torch version of the kernel for ONE output; same arguments
    and result as :func:`sample_empty_one`, ``panel`` the blocked
    factorization's panel width (1: the column sweep)."""
    Ht = Kxm.shape[1]
    V = Linv @ Kxm.transpose(1, 2)                        # (ns, R, Ht)
    G = V.transpose(1, 2) @ V
    G = torch.tril(G) + torch.tril(G, -1).transpose(1, 2)  # exactly symmetric
    mean = (Kxm @ alpha[:, None])[..., 0]                  # (ns, Ht)
    jit0 = row_jitter(jitter, prior_var)
    cov = Ktt - G
    S = cov + torch.diag(jit0)
    var = torch.diagonal(S, dim1=-2, dim2=-1) - jit0
    L = torch.tril(factor_retried(S, 0, Ht, cov, False, var, jit0, panel))
    y = mean + (L @ eps[..., None])[..., 0]
    return override_tail(mean, y, var, prior_var, beta, var_zero, rel_floor,
                         ty, close, ynear)


def sample_empty_plain_stacked(jitter: float, beta: float, var_zero: float,
                               rel_floor: float, ty: int = 1, **stacked):
    """Plain version of :func:`sample_empty`: one :func:`sample_empty_plain`
    per output."""
    no = stacked["Kxm"].shape[0]
    return torch.stack([sample_empty_plain(
        jitter=jitter, beta=beta, var_zero=var_zero, rel_floor=rel_floor,
        ty=ty, **{k: None if v is None else v[o] for k, v in stacked.items()})
        for o in range(no)])


def override_tail(mean, y, var, prior_var, beta: float, var_zero: float,
                  rel_floor: float, ty: int = 1, close=None, ynear=None):
    """The GP kernels' override tail on (ns, Ht) rows, in
    ``pallas_gp._override_tail``'s order: relative variance floor, zero
    variance -> mean (Ty>1: all tasks of the point), min-dist -> nearest
    train row, beta clip, non-finite -> mean; min/max propagate NaN."""
    ns, Ht = y.shape
    var = torch.clamp(var, min=0.0)
    if rel_floor > 0.0:
        var = torch.where(var < rel_floor * prior_var, torch.zeros_like(var),
                          var)
    if var_zero >= 0.0:
        z = var <= var_zero
        if ty > 1:
            z = z.reshape(ns, Ht // ty, ty).all(-1, keepdim=True).expand(
                ns, Ht // ty, ty).reshape(ns, Ht)
        y = torch.where(z, mean, y)
    if close is not None:
        y = torch.where(close > 0, ynear, y)
    std = torch.sqrt(var)
    y = torch.minimum(torch.maximum(y, mean - beta * std), mean + beta * std)
    return torch.where(torch.isfinite(y), y, mean)


def sample_empty_one(Kxm, Ktt, eps, Linv, alpha, prior_var, jitter: float,
                     beta: float, var_zero: float, rel_floor: float,
                     ty: int = 1, close=None, ynear=None):
    """Run the fused stage for ONE GP output.

    Args:
        Kxm: (ns, Ht, R) masked cross-covariance blocks.
        Ktt: (ns, Ht, Ht) test-test blocks.
        eps: (ns, Ht) base draws.
        Linv: (R, R) inverse Cholesky factor of the masked train matrix.
        alpha: (R,) K~^-1 y~.
        prior_var: (Ht,) prior variance of each test row's task.
        ty: tasks per test point (for the Ty>1 zero-variance override).
        close/ynear: optional (ns, Ht) min-dist override rows.
    Returns:
        (ns, Ht) sampled rows.
    """
    if not build.kernel_route("gp", Kxm.device):
        return sample_empty_plain(Kxm, Ktt, eps, Linv, alpha, prior_var,
                                  jitter, beta, var_zero, rel_floor, ty=ty,
                                  close=close, ynear=ynear)
    one = lambda t: None if t is None else t[None]
    return sample_empty(one(Kxm), one(Ktt), one(eps), one(Linv), one(alpha),
                        one(prior_var), jitter, beta, var_zero, rel_floor,
                        ty=ty, close=one(close), ynear=one(ynear))[0]


def sample_empty(Kxm, Ktt, eps, Linv, alpha, prior_var, jitter: float,
                 beta: float, var_zero: float, rel_floor: float, ty: int = 1,
                 close=None, ynear=None):
    """Run the fused stage for every GP output in one launch.

    The arguments are :func:`sample_empty_one`'s, each per-output tensor
    stacked on a leading axis of ``no`` outputs: Kxm (no, ns, Ht, R), Ktt
    (no, ns, Ht, Ht), eps (no, ns, Ht), Linv (no, R, R), alpha (no, R),
    prior_var (no, Ht), close/ynear (no, ns, Ht) or None; the scalars are
    shared.  Returns (no, ns, Ht) sampled rows.
    """
    if not build.kernel_route("gp", Kxm.device):
        return sample_empty_plain_stacked(
            jitter, beta, var_zero, rel_floor, ty, Kxm=Kxm, Ktt=Ktt, eps=eps,
            Linv=Linv, alpha=alpha, prior_var=prior_var, close=close,
            ynear=ynear)
    if Kxm.device.type != "cuda":
        raise ValueError(f"gp_sample: unsupported device {Kxm.device}")
    no, ns, Ht, R = Kxm.shape
    dev = Kxm.device
    check_supported(Ht, R, Kxm.dtype)
    args = [("Kxm", Kxm, (no, ns, Ht, R)), ("Ktt", Ktt, (no, ns, Ht, Ht)),
            ("eps", eps, (no, ns, Ht)), ("Linv", Linv, (no, R, R)),
            ("alpha", alpha, (no, R)), ("prior_var", prior_var, (no, Ht))]
    if close is not None:
        args += [("close", close, (no, ns, Ht)), ("ynear", ynear, (no, ns, Ht))]
    for name, t, shape in args:
        build.check_tensor(name, t, shape, dev)
    smem, stride, glob = sample_layout(Ht)
    fn = build.load("gp_sample").gp_sample_empty
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([P] * 10 + [I] * 5 + [F] * 5 + [I] * 4
                   + [ctypes.c_longlong, I, P])
    fn.restype = I
    dg = torch.empty((no, ns, Ht), dtype=torch.float32, device=dev)
    work = torch.empty((max(no * ns * stride, 1),), dtype=torch.float32,
                       device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = fn(Kxm.data_ptr(), Ktt.data_ptr(), eps.data_ptr(),
                Linv.data_ptr(), alpha.data_ptr(), prior_var.data_ptr(),
                ptr(close), ptr(ynear), dg.data_ptr(), work.data_ptr(), no,
                ns, Ht, R, int(ty), float(jitter), JITTER_REL, float(beta),
                float(var_zero), float(rel_floor), *map(int, glob), stride,
                smem, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gp_sample_empty launch")
    obs.count(LAUNCHES, "gp_sample")
    return dg
