#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``sampling_gpmpc_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. build   — compile every CUDA kernel (one nvcc per source, in parallel)
             and print the card's name and power limit;
params_pendulum1D_samples (ns=70, H=17, one SQP iteration):
2. gp      — the GP-sample kernel vs its plain torch version on the inputs
             of SQP iteration 0, held by the tube criterion
             |y - mu| <= beta (sigma + sigma_n) and pointwise to the plain
             version within 1e-3 of the tube;
3. ipm     — on the first QP of that solve and on a warm-started later QP:
             the whole kernel solve vs the plain solver, the prepare
             kernel's every output vs prepare_plain, and the Mehrotra kernel
             vs the plain loop on the same prepared problem;
4. loop    — the closed loop on cuda float32 with the stored oracle's
             epistemic draws: 20 teacher-forced steps, each through the
             kernels and through their plain versions, against each other
             and against tests/goldens/oracle_pendulum1d_flagship.npz; then
             20 free-running steps (DEMPC.run, the main path) with the
             kernels' launch counters zeroed before it and read after it;
params_car (ns=20, H=15, four SQP iterations, 4 soft ellipse obstacles):
5. gp      — the GP-sample kernel at the car shape (Ht=60, R=180), each
             output, with the same two checks;
6. gp_hall — the hall-block kernels at the fills nh = 60, 120, 180 of one
             solve's iterations 1-3, each output: against the float64
             reference posterior (tube, 0 violations), pointwise against
             the plain version, and a check that the pointwise bar would
             fail a kernel that returned the mean or ignored eps;
7. ipm     — the three IPM checks on the car's cold step-0 QP and on the
             warm QP of SQP iteration 2;
8. loop    — 12 teacher-forced car steps through the kernels and through
             the plain versions, against each other and against
             tests/goldens/torch_oracle_car.npz; then 12 free-running steps
             (DEMPC.run) with the counters zeroed before and read after,
             SQP iterations and ms per step;
9. timing  — each kernel at the main paths' shapes (CUDA events around
             back-to-back warm calls queued behind a sleep kernel, median)
             beside its plain version and its bound;
kernels 5-7, the batched small-matrix linalg (off the closed loop):
10. linalg — their own entry point, sampling_gpmpc_torch.microbench_linalg
             (chol, tri_solve both ways, batched_cholesky(use_kernel=True)
             at the JAX microbench's shapes and the fs shape B=12000, n=50,
             m=1), counters zeroed before and read after; then each kernel
             vs its plain version there and at B=60, n=180 (the JAX tests'
             bars: 2e-4 factors, 3e-4 solves; upper triangles exactly 0),
             an indefinite input's NaN pattern, and their timing beside the
             plain version, torch.linalg and the bound;
params_car_residual_fs (ns=4000 value-only realizations x 50 steps):
11. fs     — forward_sample_rollout, cuda float32, replaying the
             car_residual golden's last plan and on zero inputs, each
             against the same draws in cuda float64 (at most 1 non-finite
             realization, 0.25 per realization, 0.15 on the envelope of the
             first 256, 1.2x the JAX float32 path's own envelope error on
             all 4000, inside the state box + 10x its width), and sampled
             steps/s (warm, median of 3);
then one JSON line listing the kernels, the card line, and the contract
line {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = "params_pendulum1D_samples"
GOLDEN = os.path.join(HERE, "tests", "goldens",
                      "oracle_pendulum1d_flagship.npz")
CAR_CONFIG = "params_car"
CAR_GOLDEN = os.path.join(HERE, "tests", "goldens", "torch_oracle_car.npz")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
NOISE_REL = 1e-3               # f32 posterior-variance cancellation floor
# GP kernel vs its plain version, pointwise, as a share of the tube width
# beta (sigma + sigma_n) there: float32 rounding of the same algorithm is
# ~1e-7 of it; a dropped eps or a wrong factor moves a draw by O(1) of it.
GP_REL_TOL = 1e-3
# Hall-block kernels vs their plain version, pointwise, as a share of the
# tube width: about ten times the largest value measured on an H100
# (9.3e-4, car SQP iteration 3, nh=180, output 0; the others <= 4.2e-4).
# Both sides cancel Ktt - V_r'V_r - Vh'Vh in float32 with different
# summation orders; a kernel returning the mean reads 0.47-0.93.
GP_HALL_REL_TOL = 1e-2
# IPM prepare kernel vs prepare_plain, per output field, relative to that
# field's largest magnitude: the same float32 operations in the same order
# (measured 0 on an H100 for both flagship QPs); a wrong dual mapping,
# start or warm/cold choice is O(1).
PREP_RTOL = 1e-5
# Teacher-forced closed-loop tolerance against the float64 oracle.  The
# float32 QP exit (relative KKT 3e-5 on 1e7-penalty QPs) leaves solution
# error along flat input directions: the JAX package's own float32 path
# and the port's plain float32 path both deviate from this golden by up to
# 0.23 in X and 3.0 in U on these 20 steps (measured on the CPU by
# tests/test_torch_closed_loop.py::test_f32_teacher_forced_envelope).
TF_TOL_X, TF_TOL_U = 0.5, 5.0
# Teacher-forced kernel path vs the plain path on the same inputs, per step:
# about ten times the largest difference measured on an H100 (6.8e-5 in X,
# 2.4e-3 in U, both at step 1, whose cold QP runs ~25 Mehrotra iterations
# and the two solvers stop at different points of the float32 exit; every
# other step agrees within 7e-6).  U spans [-5, 5].
TF_KP_TOL_X, TF_KP_TOL_U = 1e-3, 2e-2
# The car's float32 teacher-forced envelope against its float64 golden:
# the JAX package's float32 path and the port's plain float32 path both
# deviate by up to 1.84 in X and 1.19 in U over the 12 steps (measured on
# the CPU by tests/test_torch_car.py::test_f32_teacher_forced_car_envelope).
TF_CAR_TOL_X, TF_CAR_TOL_U = 3.0, 2.0
# Car teacher-forced steps through the kernels vs through the plain
# versions, per step: about ten times the largest difference measured on
# an H100 in X (0.25; U 0.40, whose bar stays at the envelope's 2.0).  Four
# SQP iterations carry each float32 difference of a GP draw into the next
# QP, whose float32 exit leaves the plan loose along flat cost directions,
# so this closed-loop comparison cannot isolate the kernels the way the
# pendulum's does: phases 5-7 hold each kernel alone on the same inputs.
TF_CAR_KP_TOL_X, TF_CAR_KP_TOL_U = 2.5, 2.0
CAR_STEP = 5                   # golden step whose solve feeds phases 5-7
# Batched Cholesky / triangular-solve kernels vs their plain versions: the
# JAX package's own bars for its kernels (tests/test_batch_linalg.py).
LINALG_F_TOL, LINALG_S_TOL = 2e-4, 3e-4
FS_CONFIG = "params_car_residual_fs"
FS_GOLDEN = os.path.join(HERE, "tests", "goldens", "params_car_residual.npz")
# Float32 forward sampling against float64 on the same draws, with
# tests/test_f32_envelope.py's bars: 0.25 per realization (over the
# survivors), and 0.15 on the per-step min/max envelope over the test's own
# width of 256 realizations.  The envelope over all 4000 widens with ns,
# because the extremes are the most chaotic realizations, and the JAX
# package's own float32 path does not meet 0.15 there: on the CPU, on the
# same draws, it reads 0.213 over 4000 on the replayed plan (0.096 over the
# first 256, 0.148 over 1000) and 0.184 on zero inputs
# (tests/test_torch_reachability.py::test_f32_envelope_by_width_vs_jax).
# So the full width is held to FS_JAX_ENV_FACTOR times the reference's own
# reading, and its distance to 0.15 is printed, not enforced.
FS_REAL_TOL, FS_ENV_TOL, FS_ENV_NS = 0.25, 0.15, 256
FS_JAX_ENV = {"replay of the golden plan": 0.213, "zero inputs": 0.184}
FS_JAX_ENV_FACTOR = 1.2


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


@contextlib.contextmanager
def plain_route():
    """Swap the kernel wrappers the main path calls for their plain torch
    versions (same arguments, same results), to run a reference solve on
    the same device; restored on exit."""
    from sampling_gpmpc_torch.ops import gp_hall, gp_sample, ipm
    saved = (gp_sample.sample_empty_one, gp_hall.sample_hall_one,
             ipm.run_full)
    gp_sample.sample_empty_one = gp_sample.sample_empty_plain
    gp_hall.sample_hall_one = gp_hall.sample_hall_plain
    ipm.run_full = ipm.run_full_plain
    try:
        yield
    finally:
        (gp_sample.sample_empty_one, gp_hall.sample_hall_one,
         ipm.run_full) = saved


@contextlib.contextmanager
def sqp_iterations(sqp, out):
    """Record the SQP iterations of every ``sqp.solve`` call into ``out``."""
    solve = sqp.solve

    def recording(*a, **k):
        st = solve(*a, **k)
        out.append(int(st.it))
        return st

    sqp.solve = recording
    try:
        yield
    finally:
        sqp.solve = solve


def launch_counts():
    from sampling_gpmpc_torch.ops import gp_hall, gp_sample, ipm
    return {**gp_sample.LAUNCHES, **gp_hall.LAUNCHES, **ipm.LAUNCHES}


def zero_launch_counts():
    from sampling_gpmpc_torch.ops import gp_hall, gp_sample, ipm
    for k in (gp_sample.LAUNCHES, gp_hall.LAUNCHES, ipm.LAUNCHES):
        for name in k:
            k[name] = 0


def bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def gp_sample_bound(ns, Ht, R):
    """Bytes and float32 operations of one gp_sample launch."""
    nbytes = 4 * (ns * Ht * R + ns * Ht * Ht + ns * Ht + R * R + R + Ht
                  + ns * Ht)
    flops = ns * (2 * R * R * Ht + 2 * R * Ht + R * Ht * (Ht + 1)
                  + Ht ** 3 / 3 + Ht * Ht)
    return nbytes, flops


def gp_hall_bound(ns, Ht, Rr, nh):
    """Bytes and float32 operations of one gp_hall stage at fill nh: the
    filled part of each input read once, dg written once; the products,
    both factorizations, the substitution, the fold and the draw."""
    nbytes = 4 * (ns * (Ht * Rr + Ht * nh + Ht * Ht + Rr * nh + nh * nh + nh
                        + Ht) + Rr * Rr + Rr + Ht + ns * Ht)
    flops = ns * (2 * Rr * Rr * nh + 2 * Rr * Rr * Ht + Rr * nh * (nh + 1)
                  + 2 * Ht * Rr * nh + 2 * Rr * nh + Rr * Ht * (Ht + 1)
                  + 2 * Rr * Ht + nh ** 3 / 3 + (Ht + 1) * nh * nh
                  + Ht * (Ht + 1) * nh + 2 * Ht * nh + Ht ** 3 / 3 + Ht * Ht)
    return nbytes, flops


def tube_width(spec, mean64, cov64, prior_var):
    """beta (sigma + sigma_n) around the float64 posterior, sigma_n the
    float32 cancellation floor of the variance."""
    import torch
    var64 = torch.clamp(torch.diagonal(cov64, dim1=-2, dim2=-1), min=0.0)
    sig_n = torch.sqrt(NOISE_REL * prior_var.to(torch.float64))
    return spec.gp.beta * (torch.sqrt(var64) + sig_n)


class IPMChecks:
    """The three IPM checks of one QP: the whole kernel solve against the
    plain solver in float32 and float64, the prepare kernel's every output
    against prepare_plain, and the Mehrotra kernel alone against the plain
    loop on the prepare kernel's own outputs."""

    tol, reg = 3e-5, 1e-7

    def __init__(self):
        from sampling_gpmpc_torch.ocp import qp as qp_mod
        from sampling_gpmpc_torch.ops import ipm
        self.qp, self.ipm = qp_mod, ipm
        self.consts = (qp_mod.STALL_ITERS, qp_mod.STALL_RTOL, qp_mod.MU_GRIND)

    def solve_pair(self, qp_args, ws, wv):
        import torch
        qp_mod, ipm, tol = self.qp, self.ipm, self.tol
        qp_args = tuple(a.contiguous() for a in qp_args)
        k = qp_mod._finish(*ipm.run_full(*qp_args, ws, wv, tol, self.reg,
                                         150, *self.consts, qp_mod.WS_BAND),
                           tol)
        p = qp_mod._finish(*ipm.run_full_plain(
            *qp_args, ws, wv, tol, self.reg, 150, *self.consts,
            qp_mod.WS_BAND), tol)
        f64 = torch.float64
        ex = qp_mod._finish(*ipm.run_full_plain(
            *[a.to(f64) for a in qp_args],
            None if ws is None else tuple(a.to(f64) for a in ws), wv,
            1e-12, 1e-13, 150, *self.consts, qp_mod.WS_BAND), 1e-12)
        return k, p, ex

    def prepare_report(self, label, qp_args, ws, wv):
        """The prepare kernel's every output against prepare_plain's on the
        same inputs, each relative to the field's own largest magnitude;
        and which start each took (the kernel keeps its cold candidate in
        the head of its scratch buffer)."""
        import torch
        ipm, band = self.ipm, self.qp.WS_BAND
        qp_args = tuple(a.contiguous() for a in qp_args)
        m_h = qp_args[3].shape[0]
        d = ipm.prepare(*qp_args, ws, wv, band)
        p = ipm.prepare_plain(*qp_args, ws, wv, band)
        cold = ipm.prepare_plain(*qp_args, None, None, band).st0
        warm_k = not torch.equal(d.h0.reshape(-1), d.work[:2 * m_h])
        warm_p = not all(torch.equal(a, b) for a, b in zip(p.st0, cold))
        s, inv = p.st0, (lambda x: 1.0 / (1.0 + torch.abs(x)))
        fields = [
            ("G_h", d.Gth.T, p.G_h), ("d_h", d.dh[0], p.d_h),
            ("1/(1+|d_h|)", d.dh[1], inv(p.d_h)), ("G_s", d.Gts.T, p.G_s),
            *[(n, d.sd[k], v) for k, (n, v) in enumerate(
                (("lo_s", p.lo_s), ("hi_s", p.hi_s), ("zl", p.zl),
                 ("zu", p.zu), ("Zl", p.Zl), ("Zu", p.Zu),
                 ("1/(1+|hi|)", inv(p.hi_s)), ("1/(1+|lo|)", inv(p.lo_s))))],
            ("qscale", d.qs[0], p.qscale), ("scale_h", d.sch, p.scale_h),
            ("scale_s", d.scs, p.scale_s), ("th", d.h0[0], s[3]),
            ("lh", d.h0[1], s[4]), ("tU", d.s0[0], s[5]),
            ("tL", d.s0[1], s[7]), ("sl", d.s0[2], s[1]),
            ("su", d.s0[3], s[2]), ("lU", d.s0[4], s[6]),
            ("lL", d.s0[5], s[8]), ("nl", d.s0[6], s[9]),
            ("nu", d.s0[7], s[10])]
        errs = {n: (float(torch.max(torch.abs(k - v))),
                    float(torch.max(torch.abs(k - v))
                          / torch.clamp(torch.max(torch.abs(v)), min=1e-30)))
                for n, k, v in fields}
        worst = max(errs, key=lambda n: errs[n][1])
        print(f"[ipm] prepare {label}: start kernel "
              f"{'warm' if warm_k else 'cold'}, plain "
              f"{'warm' if warm_p else 'cold'}; {len(fields)} fields, worst "
              f"{worst} {errs[worst][1]:.3e} of its scale (tol {PREP_RTOL}); "
              f"max abs err {max(e[0] for e in errs.values()):.3e}",
              flush=True)
        if warm_k != warm_p or errs[worst][1] > PREP_RTOL:
            fail(f"IPM prepare kernel {label}")
        return errs[worst][1], d

    def as_prepared(self, d):
        """The prepare kernel's outputs as the plain loop's input."""
        import torch
        h, s = d.h0, d.s0
        st = (torch.zeros_like(d.g), s[2], s[3], h[0], h[1], s[0], s[4], s[1],
              s[5], s[6], s[7])
        return self.ipm.Prepared(d.H, d.g, d.Gth.T, d.dh[0], d.Gts.T,
                                 *d.sd[:6], d.qs[0], st, d.sch, d.scs)

    def report(self, label, qp_args, ws, wv):
        import torch
        f64 = torch.float64
        k, p, ex = self.solve_pair(qp_args, ws, wv)
        du = float(torch.max(torch.abs(k.z - p.z)))
        ek = float(torch.max(torch.abs(k.z.to(f64) - ex.z)))
        ep = float(torch.max(torch.abs(p.z.to(f64) - ex.z)))
        scale = 1.0 + float(torch.max(torch.abs(ex.z)))
        # the kernel may sit anywhere in the f32 tolerance ball, but no
        # farther from the exact solution than twice the plain f32 solver
        bound = 2.0 * ep + 1e-3 * scale
        print(f"[ipm] {label}: nU={qp_args[1].shape[0]} "
              f"m_h={qp_args[3].shape[0]} m_s={qp_args[5].shape[0]}: "
              f"|du kernel - plain|inf = {du:.3e}; |u - u_f64|inf kernel "
              f"{ek:.3e} plain {ep:.3e} (bound {bound:.3e}); status "
              f"{int(k.status)}/{int(p.status)}; kkt {float(k.gap):.3e}/"
              f"{float(p.gap):.3e}; iters {int(k.iters)}/{int(p.iters)}",
              flush=True)
        if int(k.status) != 0 or int(p.status) != 0 or ek > bound:
            fail(f"IPM kernel {label}")
        rel_prep, d = self.prepare_report(label, qp_args, ws, wv)
        pk = self.as_prepared(d)
        tol, reg = self.tol, self.reg
        bk, rk, ik = self.ipm.mehrotra(d, tol, reg, 150, *self.consts)
        bp, rp, ip = self.ipm.mehrotra_plain(pk, tol, reg, 150, *self.consts)
        du_m = float(torch.max(torch.abs(bk[0] - bp[0])))
        print(f"[ipm] mehrotra {label} on the same prepared problem: "
              f"|du kernel - plain|inf = {du_m:.3e} (bound {bound:.3e}); "
              f"kkt {float(rk):.3e}/{float(rp):.3e}; iters "
              f"{int(ik)}/{int(ip)}", flush=True)
        stat_tol = tol * self.qp.STATUS_RTOL
        if du_m > bound or float(rk) > stat_tol or float(rp) > stat_tol:
            fail(f"IPM Mehrotra kernel {label}")
        return rel_prep, du_m

    def timing(self, label, qpa, ws, wv):
        """Kernel and plain times of both IPM stages on one QP, with their
        bounds, for this QP's iteration count."""
        from sampling_gpmpc_torch.microbench_linalg import cuda_ms
        ipm, band = self.ipm, self.qp.WS_BAND
        tol, reg, consts = self.tol, self.reg, self.consts
        qpa = tuple(a.contiguous() for a in qpa)
        nU, m_h, m_s = qpa[1].shape[0], qpa[3].shape[0], qpa[5].shape[0]
        prep = ipm.prepare(*qpa, ws, wv, band)
        t_pk = cuda_ms(lambda: ipm.prepare(*qpa, ws, wv, band))
        t_pp = cuda_ms(lambda: ipm.prepare_plain(*qpa, ws, wv, band), n=10,
                       k=1)
        t_mk = cuda_ms(lambda: ipm.mehrotra(prep, tol, reg, 150, *consts),
                       k=2)
        pp = ipm.prepare_plain(*qpa, ws, wv, band)
        t_mp = cuda_ms(lambda: ipm.mehrotra_plain(pp, tol, reg, 150, *consts),
                       n=5, warm=1, k=1)
        iters = int(ipm.mehrotra(prep, tol, reg, 150, *consts)[2])
        m = m_h + m_s
        pb = 4 * (nU * nU + nU + 2 * nU * m + m_h + 6 * m_s
                  + (0 if ws is None else nU + m_h + 6 * m_s)
                  + 4 * m_h + 16 * m_s + 1 + m)
        pf = 4 * nU * m + (0 if ws is None else 6 * nU * m)
        bp, byp = bound_ms(pb, pf)
        mb = 4 * (nU * nU + nU + nU * m + 4 * m_h + 16 * m_s + 1
                  + nU + 2 * m_h + 8 * m_s + 2)
        mf = iters * (nU * (nU + 1) * m + 9 * 2 * nU * m + nU ** 3 / 3
                      + 4 * nU * nU + 60 * m)
        bm, bym = bound_ms(mb, mf)
        print(f"[timing] ipm {label} (nU={nU}, m_h={m_h}, m_s={m_s}, "
              f"{iters} iterations): prepare kernel {t_pk:.4f} ms, plain "
              f"{t_pp:.4f} ms, bound {bp:.5f} ms ({byp}); mehrotra kernel "
              f"{t_mk:.4f} ms, plain {t_mp:.4f} ms, bound {bm:.5f} ms "
              f"({bym}: {mb} B, {mf:.3e} flop); one-SM L2 estimate "
              f"4 passes x 4 B x nU x m per iteration = "
              f"{iters * 16 * nU * m / 1e6:.2f} MB", flush=True)
        return (dict(ms=t_pk, plain_ms=t_pp, bound_ms=bp, bound_by=byp),
                dict(ms=t_mk, plain_ms=t_mp, bound_ms=bm, bound_by=bym,
                     iters=iters))


def gp_report(tag, spec, label, dk, dp, tube, mean64, rel_tol, d0=None):
    """Tube violations of the kernel and the plain draws around the float64
    posterior, and the kernel's pointwise distance to the plain version as
    a share of the tube width; with ``d0`` (the plain draw at eps = 0, the
    posterior mean), also the share a kernel that returned the mean or
    ignored eps would read, which must be far above the bar."""
    import torch
    f64 = torch.float64
    viol_k = int((torch.abs(dk.to(f64) - mean64) > tube).sum())
    viol_p = int((torch.abs(dp.to(f64) - mean64) > tube).sum())
    err = float(torch.max(torch.abs(dk - dp)))
    rel = float(torch.max(torch.abs(dk - dp).to(f64) / tube))
    finite = bool(torch.isfinite(dk).all())
    extra = ""
    rel_mean = None
    if d0 is not None:
        rel_mean = float(torch.max(torch.abs(dp - d0).to(f64) / tube))
        extra = (f"; a kernel returning the mean would read {rel_mean:.3e} "
                 f"(must exceed 10x the bar)")
    print(f"[{tag}] {label}: max|dg kernel - plain| = {err:.3e} = {rel:.3e} "
          f"of the tube width (tol {rel_tol}); tube violations kernel="
          f"{viol_k} plain={viol_p} of {dk.numel()}; finite={finite}{extra}",
          flush=True)
    if viol_k or viol_p or not finite:
        fail(f"{tag} {label}: kernel outside the tube or non-finite")
    if rel > rel_tol:
        fail(f"{tag} {label}: kernel disagrees with its plain version")
    if rel_mean is not None and rel_mean <= 10 * rel_tol:
        fail(f"{tag} {label}: the pointwise bar would not catch a mean-only "
             "kernel")
    return err, rel


def linalg_bound(B, n, m=None):
    """Bound of one batched Cholesky (m None: each matrix's lower triangle
    read once, its whole factor, zero upper triangle included, written once,
    n^3/3 flop each) or triangular solve (the factor's lower triangle and
    the right-hand side read once, the solution written once, n^2 m flop
    each).  The kernels and their plain versions read no upper triangle."""
    tri = n * (n + 1) // 2
    if m is None:
        return bound_ms(4 * B * (tri + n * n), B * n ** 3 / 3)
    return bound_ms(4 * B * (tri + 2 * n * m), B * n * n * m)


def close_report(label, got, ref, tol):
    """max |got - ref|, failing past |got - ref| <= tol + tol |ref| (the
    JAX tests' assert_allclose bar) or on a non-finite entry."""
    import torch
    err = torch.abs(got - ref)
    bad = int((~(err <= tol + tol * torch.abs(ref))).sum())
    worst = float(err.max())
    print(f"[linalg] {label}: max|kernel - plain| {worst:.3e} (bar {tol} "
          f"abs + {tol} rel), {bad} entries past it of {got.numel()}",
          flush=True)
    if bad:
        fail(f"linalg {label}: kernel disagrees with its plain version")
    return worst


def nan_pattern_report(label, got, ref, tol):
    """An indefinite input: the kernel's NaN entries equal the plain
    version's and its finite entries agree to the bar."""
    import torch
    same = torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref) & torch.isfinite(got)
    err = float(torch.abs(got - ref)[fin].max())
    n_nan = int(torch.isnan(got).sum())
    print(f"[linalg] {label}, indefinite input: NaN pattern "
          f"{'identical' if same else 'DIFFERENT'} ({n_nan} NaN of "
          f"{got.numel()}); finite entries max|diff| {err:.3e}", flush=True)
    if not same or err > tol:
        fail(f"linalg {label}: NaN pattern of an indefinite input")


def linalg_phase(dev):
    """Kernels 5-7 through their own entry point (the microbench of
    sampling_gpmpc_torch/microbench_linalg.py: chol, tri_solve both ways,
    batched_cholesky(use_kernel=True) at its shapes and the fs shape), with
    the launch counts zeroed before it and read after; then each kernel
    against its plain version at those shapes and at (B=60, n=180), an
    indefinite input's NaN pattern, and the timing rows."""
    import torch
    from sampling_gpmpc_torch import microbench_linalg as mb
    from sampling_gpmpc_torch.microbench_linalg import cuda_ms
    from sampling_gpmpc_torch.ops import batch_linalg as bl
    from sampling_gpmpc_torch.ops import batched_chol as bc
    for k in (bl.LAUNCHES, bc.LAUNCHES):
        for name in k:
            k[name] = 0
    torch.cuda.synchronize()
    rows = mb.run(dev, n_iter=30)
    torch.cuda.synchronize()
    launches = {**bl.LAUNCHES, **bc.LAUNCHES}
    print(f"[linalg] microbench (the kernels' entry point) launches "
          f"{launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"a linalg kernel was not launched: {launches}")
    rows.append(mb.measure(60, 180, 8, dev, n_iter=30, seed=1))

    out = {"chol": [], "tri_solve": [], "batched_chol": []}
    for r in rows:
        B, n, m, S, R, L = r["B"], r["n"], r["m"], r["S"], r["R"], r["L"]
        tag = f"B={B} n={n}"
        e_c = close_report(f"chol {tag}", L, bl.chol_plain(S), LINALG_F_TOL)
        e_t = max(close_report(f"tri_solve {tag} m={m}", r["X"],
                               bl.tri_solve_plain(L, R), LINALG_S_TOL),
                  close_report(f"tri_solve transposed {tag} m={m}", r["Xt"],
                               bl.tri_solve_plain(L, R, True), LINALG_S_TOL))
        e_b = close_report(f"batched_chol {tag}", r["Lb"],
                           bc.batched_cholesky_plain(S), LINALG_F_TOL)
        lib = torch.linalg.cholesky(S)
        print(f"[linalg] {tag}: upper triangles exactly 0: chol "
              f"{bool((torch.triu(L, 1) == 0).all())}, batched_chol "
              f"{bool((torch.triu(r['Lb'], 1) == 0).all())}; max|chol - "
              f"torch.linalg.cholesky| {float((L - lib).abs().max()):.3e}",
              flush=True)
        if not (torch.triu(L, 1) == 0).all() or \
                not (torch.triu(r["Lb"], 1) == 0).all():
            fail(f"linalg {tag}: non-zero upper triangle")
        t_pc = cuda_ms(lambda: bl.chol_plain(S), n=5, warm=1, k=1)
        t_pt = cuda_ms(lambda: bl.tri_solve_plain(L, R), n=5, warm=1, k=1)
        t_pb = cuda_ms(lambda: bc.batched_cholesky_plain(S), n=5, warm=1,
                       k=1)
        bc_ms, bc_by = linalg_bound(B, n)
        bt_ms, bt_by = linalg_bound(B, n, m)
        common = dict(B=B, n=n)
        out["chol"].append(dict(common, max_abs_err=e_c, ms=r["chol_ms"],
                                plain_ms=t_pc, bound_ms=bc_ms,
                                bound_by=bc_by, library_ms=r["chol_lib_ms"]))
        out["tri_solve"].append(dict(
            common, m=m, max_abs_err=e_t, ms=r["tri_ms"],
            ms_transposed=r["tri_t_ms"], plain_ms=t_pt, bound_ms=bt_ms,
            bound_by=bt_by, library_ms=r["tri_lib_ms"]))
        out["batched_chol"].append(dict(
            common, max_abs_err=e_b, ms=r["bchol_ms"], plain_ms=t_pb,
            bound_ms=bc_ms, bound_by=bc_by, library_ms=r["chol_lib_ms"]))
        print(f"[timing] linalg {tag} m={m}: chol kernel {r['chol_ms']:.4f} "
              f"ms, plain {t_pc:.4f}, torch.linalg {r['chol_lib_ms']:.4f}, "
              f"bound {bc_ms:.5f} ({bc_by}); tri_solve kernel "
              f"{r['tri_ms']:.4f} ms (transposed {r['tri_t_ms']:.4f}), plain "
              f"{t_pt:.4f}, torch.linalg {r['tri_lib_ms']:.4f}, bound "
              f"{bt_ms:.5f} ({bt_by}); batched_chol kernel "
              f"{r['bchol_ms']:.4f} ms, plain {t_pb:.4f}", flush=True)

    # a pivot that goes negative mid-way: NaN from that column on, in the
    # pattern of each TPU kernel (batch_linalg: rows below it NaN in every
    # lower column; pallas_chol: rows from it down NaN in every column)
    S_bad = rows[0]["S"].clone()
    S_bad[:, 17, 17] = -1.0
    nan_pattern_report("chol", bl.chol(S_bad), bl.chol_plain(S_bad),
                       LINALG_F_TOL)
    nan_pattern_report("batched_chol",
                       bc.batched_cholesky(S_bad, use_kernel=True),
                       bc.batched_cholesky_plain(S_bad), LINALG_F_TOL)
    if not (torch.triu(bl.chol(S_bad), 1) == 0).all():
        fail("linalg chol: non-zero upper triangle on an indefinite input")
    return out, launches


def fs_phase(dev):
    """forward_sample_rollout at full width (params_car_residual_fs: 4000
    value-only realizations x 50 steps, ancillary feedback), cuda float32,
    replaying the car_residual golden's last plan and on zero inputs (as
    bench.py's fs row), each against the same draws in cuda float64.
    Returns sampled steps/s per run."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.reachability import forward_sample_rollout
    f32, f64 = torch.float32, torch.float64
    params, spec, data = load_problem(
        os.path.join(HERE, "params", FS_CONFIG + ".yaml"))
    env = make_env(spec, params)
    T = spec.num_mpc_iter
    if (spec.ns, T, spec.Ty) != (4000, 50, 1):
        fail(f"{FS_CONFIG}: ns={spec.ns}, T={T}, Ty={spec.Ty}")
    hyp = {d: GPHyperArrays.from_spec(spec.gp, dev, d) for d in (f32, f64)}
    gp = {d: agent.init_gp_state(spec, env, dev, d, capacity=T, hyp=hyp[d])
          for d in (f32, f64)}
    fb = {"K": data.K_fb, "x_eq": data.goal}
    eps = agent.truncated_normal((T, spec.ns, spec.g_ny, 1, spec.Ty),
                                 spec.gp.beta,
                                 torch.Generator().manual_seed(spec.seed),
                                 dev, f64)
    lo, hi = data.x_min, data.x_max
    margin = 10.0 * (hi - lo)
    U_replay = np.load(FS_GOLDEN)["last_plan_U"][:T]
    rates = {}
    for label, U in (("replay of the golden plan", U_replay),
                     ("zero inputs", np.zeros((T, spec.nu)))):
        def roll(d):
            return forward_sample_rollout(spec, env, hyp[d], gp[d],
                                          data.start, U, use_feedback=fb,
                                          eps=eps.to(d))[0]
        torch.cuda.reset_peak_memory_stats(dev)
        X32 = roll(f32)
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            roll(f32)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        X64 = roll(f64).cpu().numpy()
        X32 = X32.double().cpu().numpy()
        alive32 = np.isfinite(X32).all(axis=(0, 2))
        alive = alive32 & np.isfinite(X64).all(axis=(0, 2))
        n_bad = int((~alive32).sum())

        def env_err(keep):
            e32 = np.stack([X32[:, keep].min(1), X32[:, keep].max(1)])
            e64 = np.stack([X64[:, keep].min(1), X64[:, keep].max(1)])
            return float(np.abs(e32 - e64).max())

        head = alive & (np.arange(spec.ns) < FS_ENV_NS)
        env_head, env_all = env_err(head), env_err(alive)
        per_real = float(np.abs(X32[:, alive] - X64[:, alive]).max())
        inside = bool(np.all(X32[:, alive32] >= lo - margin)
                      and np.all(X32[:, alive32] <= hi + margin))
        wall = statistics.median(walls)
        rates[label] = spec.ns * T / wall
        env_bar = FS_JAX_ENV_FACTOR * FS_JAX_ENV[label]
        print(f"[fs] {FS_CONFIG} {label}: ns={spec.ns} x T={T}, cuda "
              f"float32: non-finite realizations {n_bad} (bar 1), float64 "
              f"{int((~np.isfinite(X64).all(axis=(0, 2))).sum())}; survivors' "
              f"per-realization max|X32 - X64| {per_real:.4e} (bar "
              f"{FS_REAL_TOL}); envelope vs float64 over the first "
              f"{FS_ENV_NS} {env_head:.4e} (bar {FS_ENV_TOL}), over all "
              f"{spec.ns} {env_all:.4e} (bar {env_bar:.4f} = "
              f"{FS_JAX_ENV_FACTOR} x the JAX float32 path's "
              f"{FS_JAX_ENV[label]}; {FS_ENV_TOL} "
              f"{'met' if env_all <= FS_ENV_TOL else 'NOT met'}); inside box "
              f"+ margin {inside}", flush=True)
        print(f"[fs] {FS_CONFIG} {label}: {rates[label]:.1f} sampled "
              f"steps/s (ns*T / wall, warm, median of 3 rollouts: "
              f"{[round(w, 4) for w in walls]} s); peak device memory "
              f"{peak:.3f} GiB", flush=True)
        if (n_bad > 1 or per_real > FS_REAL_TOL or env_head > FS_ENV_TOL
                or env_all > env_bar or not inside):
            fail(f"fs {label}")
    return rates


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "sampling_gpmpc_torch")):
        print("run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from sampling_gpmpc_torch import agent, setup
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import DEMPC, shift_solution
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.microbench_linalg import cuda_ms
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    from sampling_gpmpc_torch.ops import build, gp_hall, gp_sample

    dev = setup.resolve_device("cuda")
    f32, f64 = torch.float32, torch.float64
    T = lambda a: torch.as_tensor(a, dtype=f32, device=dev)
    results = {"gp_sample": {}, "gp_hall": {}, "ipm_prepare": {},
               "ipm_mehrotra": {}}
    checks = IPMChecks()
    t_start = time.perf_counter()

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    card = gpu_line()
    print(f"[build] {len(logs)} sources ({', '.join(logs)}) in {build_s:.1f}"
          f" s (nvcc {' '.join(build.FLAGS)})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    print(f"[card] {card}", flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    # ==== params_pendulum1D_samples at full width =========================
    g = np.load(GOLDEN)
    params, spec, data = load_problem(
        os.path.join(HERE, "params", CONFIG + ".yaml"))
    n_steps = int(g["n_steps"])
    if (spec.ns, spec.H) != (int(g["ns"]), int(g["H"])):
        fail("the oracle golden does not match the config's ns and H")
    spec = dataclasses.replace(spec, num_mpc_iter=n_steps)
    env = make_env(spec, params)
    ocp = make_ocp_data(spec, data, dev, f32)
    hyp = GPHyperArrays.from_spec(spec.gp, dev, f32)
    gp0 = agent.init_gp_state(spec, env, dev, f32, hyp=hyp)
    eps_all = T(g["eps"])
    pX, pU, phys = g["plan_X_traj"], g["plan_U_traj"], g["physical_state_traj"]
    st0 = T(phys[0])
    X0, U0 = sqp.init_iterate(spec, dev, f32, data.start)

    # ---- 2. GP-sample kernel vs plain -----------------------------------
    xu = sqp._linearization_inputs(spec, ocp, X0, U0)
    Xt = xu[..., list(spec.g_idx_inputs)]
    gp_in = agent.empty_stage_inputs(spec, hyp, agent.reset_hall(gp0), Xt,
                                     eps_all[0, 0], 0)
    dg_k = gp_sample.sample_empty_one(**gp_in)
    dg_p = gp_sample.sample_empty_plain(**gp_in)
    torch.cuda.synchronize()
    # tube: the float64 posterior of the same inputs (the reference path)
    gp64 = agent.init_gp_state(spec, env, dev, f64)
    hyp64 = GPHyperArrays.from_spec(spec.gp, dev, f64)
    mean64, cov64 = agent._batched_posterior_real(spec, hyp64, gp64,
                                                  Xt.to(f64))
    tube = tube_width(spec, mean64[:, 0], cov64[:, 0], gp_in["prior_var"])
    # the kernel clips its own draws into the tube, so the tube alone cannot
    # fail a wrong factor or a dropped eps: also hold the kernel to its plain
    # version pointwise, relative to the tube's width there
    gp_err, _ = gp_report(
        "gp", spec, f"pendulum ns={spec.ns} Ht={spec.H * spec.Ty} "
        f"R={gp_in['Kxm'].shape[-1]}", dg_k, dg_p, tube, mean64[:, 0],
        GP_REL_TOL)
    results["gp_sample"]["max_abs_err"] = gp_err

    # ---- 3. IPM kernels vs plain ----------------------------------------
    qp0, _, _, _ = sqp.assemble_qp(spec, env, hyp, ocp, st0, X0, U0,
                                   agent.reset_hall(gp0), eps_all[0, 0],
                                   hall_empty=True)
    prep0, du0 = checks.report("cold, step 0", qp0, None, None)
    # warm start: solve teacher-forced step m-1, carry its state into m
    m = 10
    Xa, Ua = shift_solution(T(pX[m - 2]), T(pU[m - 2]))
    sa = sqp.solve(spec, env, hyp, ocp, T(phys[m - 1]), Xa, Ua, gp0,
                   eps_all[m - 1])
    Xb, Ub = shift_solution(T(pX[m - 1]), T(pU[m - 1]))
    qpm, _, _, _ = sqp.assemble_qp(
        spec, env, hyp, ocp, T(phys[m]), Xb, Ub, agent.reset_hall(gp0),
        eps_all[m, 0], hall_empty=True)
    prep1, du1 = checks.report(f"warm, step {m}", qpm, sa.qp_ws, sa.qp_valid)
    prep_errs, mehr_errs = [prep0, prep1], [du0, du1]

    # ---- 4. closed loop -------------------------------------------------
    # Each teacher-forced step is solved twice on the same inputs: through
    # the kernels, and through their plain versions (swapped in for the
    # wrappers the main path calls).  Both share the float32 QP exit, so the
    # per-step difference isolates the kernels; the f64 oracle bounds both.
    ex, eu, kx, ku = [], [], [], []
    for m in range(n_steps):
        if m == 0:
            Xs, Us = X0, U0
        else:
            Xs, Us = shift_solution(T(pX[m - 1]), T(pU[m - 1]))
        st_m = T(phys[m])
        st = sqp.solve(spec, env, hyp, ocp, st_m, Xs, Us, gp0, eps_all[m])
        with plain_route():
            sp = sqp.solve(spec, env, hyp, ocp, st_m, Xs, Us, gp0,
                           eps_all[m])
        if int(st.status) != 0 or int(sp.status) != 0:
            fail(f"teacher-forced step {m}: status {int(st.status)} "
                 f"(plain {int(sp.status)})")
        ex.append(float(np.max(np.abs(st.X.cpu().numpy() - pX[m]))))
        eu.append(float(np.max(np.abs(st.U.cpu().numpy() - pU[m]))))
        kx.append(float(torch.max(torch.abs(st.X - sp.X))))
        ku.append(float(torch.max(torch.abs(st.U - sp.U))))
    print(f"[loop] pendulum teacher-forced {n_steps} steps vs the f64 oracle:"
          f" status 0 all; max|dX| {max(ex):.3e} (tol {TF_TOL_X}), max|dU| "
          f"{max(eu):.3e} (tol {TF_TOL_U}); per step dX "
          f"{[round(v, 5) for v in ex]}", flush=True)
    print(f"[loop] pendulum teacher-forced {n_steps} steps, kernels vs plain "
          f"versions: max|dX| {max(kx):.3e} (tol {TF_KP_TOL_X}), max|dU| "
          f"{max(ku):.3e} (tol {TF_KP_TOL_U}); per step dX "
          f"{[f'{v:.2e}' for v in kx]}, dU {[f'{v:.2e}' for v in ku]}",
          flush=True)
    if max(ex) > TF_TOL_X or max(eu) > TF_TOL_U:
        fail("teacher-forced closed loop outside the f32 tolerance")
    if max(kx) > TF_KP_TOL_X or max(ku) > TF_KP_TOL_U:
        fail("teacher-forced kernel path disagrees with the plain path")

    mpc = DEMPC(params, spec, data, env, device=dev, dtype=f32,
                epistemic=g["eps"])
    zero_launch_counts()
    torch.cuda.synchronize()
    out = mpc.run()
    torch.cuda.synchronize()
    launches_pend = launch_counts()
    traj = np.stack(out["physical_state_traj"] + [out["final_state"]])
    step_ms = [1e3 * t for t in out["solver_time"]]
    # the whole window after the first step (which builds and warms up):
    # its mean keeps the slow cold-QP steps a median would hide
    window_ms = sum(step_ms[1:]) / (len(step_ms) - 1)
    print(f"[loop] pendulum free-running {n_steps} steps (DEMPC.run, cuda "
          f"float32): statuses {sorted(set(out['sqp_status_traj']))}, finite "
          f"{bool(np.isfinite(traj).all())}, final state {out['final_state']}"
          f" (oracle {g['final_state']}); qp iters {out['qp_iters']}",
          flush=True)
    print(f"[loop] pendulum ms per MPC step over steps 1..{n_steps - 1}: mean"
          f" {window_ms} (median {statistics.median(step_ms[1:])}, max "
          f"{max(step_ms[1:])}); first step {step_ms[0]}; per step "
          f"{[round(v, 3) for v in step_ms]}; launches {launches_pend}",
          flush=True)
    if set(out["sqp_status_traj"]) != {0} or not np.isfinite(traj).all():
        fail("pendulum free-running closed loop")
    if min(launches_pend[k] for k in ("gp_sample", "ipm_prepare",
                                      "ipm_mehrotra")) <= 0:
        fail(f"a kernel of the pendulum path was not launched: "
             f"{launches_pend}")

    # ==== params_car at full width ========================================
    gc = np.load(CAR_GOLDEN)
    params_c, spec_c, data_c = load_problem(
        os.path.join(HERE, "params", CAR_CONFIG + ".yaml"))
    n_car = int(gc["n_steps"])
    if (spec_c.ns, spec_c.H, spec_c.max_sqp_iter) != (
            int(gc["ns"]), int(gc["H"]), int(gc["max_sqp_iter"])):
        fail("the car golden does not match the config's ns, H and SQP "
             "iterations")
    spec_c = dataclasses.replace(spec_c, num_mpc_iter=n_car)
    env_c = make_env(spec_c, params_c)
    ocp_c = make_ocp_data(spec_c, data_c, dev, f32)
    hyp_c = GPHyperArrays.from_spec(spec_c.gp, dev, f32)
    hyp_c64 = GPHyperArrays.from_spec(spec_c.gp, dev, f64)
    gp_c = agent.init_gp_state(spec_c, env_c, dev, f32, hyp=hyp_c)
    gp_c64 = agent.init_gp_state(spec_c, env_c, dev, f64, hyp=hyp_c64)
    eps_c = T(gc["eps"])
    cX, cU, cphys = gc["plan_X_traj"], gc["plan_U_traj"], \
        gc["physical_state_traj"]
    tfX, tfU = gc["tf_X_traj"], gc["tf_U_traj"]
    gidx = list(spec_c.g_idx_inputs)
    Ty_c, Ht_c = spec_c.Ty, spec_c.H * spec_c.Ty

    # ---- 5.-7. one solve's GP stages and QPs, iteration by iteration ----
    # golden step CAR_STEP, teacher-forced: each SQP iteration's GP stage
    # is checked on the inputs the solve gives it (iteration 0 on the
    # empty buffer, iterations 1-3 at fills 60, 120, 180), then the
    # iteration runs through the kernels and feeds the next
    st_c = T(cphys[CAR_STEP])
    Xc, Uc = T(cX[CAR_STEP - 1]), T(cU[CAR_STEP - 1])
    gp_it, ws, wv = agent.reset_hall(gp_c), None, None
    car_gp_in, hall_in, qp_warm_c = None, {}, None
    gs_errs, gh_errs, gh_rels = [], [], []
    for it in range(spec_c.max_sqp_iter):
        Xt = sqp._linearization_inputs(spec_c, ocp_c, Xc, Uc)[..., gidx]
        eps_it = eps_c[CAR_STEP, it]
        gp64_it = gp_c64._replace(hall_Z=gp_it.hall_Z.to(f64),
                                  hall_Y=gp_it.hall_Y.to(f64),
                                  hall_n=gp_it.hall_n)
        if it == 0:
            m64, c64 = agent._batched_posterior_real(spec_c, hyp_c64,
                                                     gp64_it, Xt.to(f64))
        else:
            m64, c64 = agent._batched_posterior_incremental(
                spec_c, hyp_c64, gp64_it, Xt.to(f64))
        for j in range(spec_c.g_ny):
            if it == 0:
                kw = agent.empty_stage_inputs(spec_c, hyp_c, gp_it, Xt,
                                              eps_it, j)
                dk = gp_sample.sample_empty_one(**kw)
                dp = gp_sample.sample_empty_plain(**kw)
                tube = tube_width(spec_c, m64[:, j], c64[:, j],
                                  kw["prior_var"])
                err, _ = gp_report(
                    "gp", spec_c, f"car ns={spec_c.ns} Ht={Ht_c} "
                    f"R={kw['Kxm'].shape[-1]} output {j}", dk, dp, tube,
                    m64[:, j], GP_REL_TOL)
                gs_errs.append(err)
                if j == 0:
                    car_gp_in = kw
            else:
                kw = agent.hall_stage_inputs(spec_c, hyp_c, gp_it, Xt,
                                             eps_it, j)
                dk = gp_hall.sample_hall_one(**kw)
                dp = gp_hall.sample_hall_plain(**kw)
                d0 = gp_hall.sample_hall_plain(
                    **dict(kw, eps=torch.zeros_like(kw["eps"])))
                tube = tube_width(spec_c, m64[:, j], c64[:, j],
                                  kw["prior_var"])
                err, rel = gp_report(
                    "gp_hall", spec_c, f"car SQP iteration {it}, nh="
                    f"{kw['nh']} (Rr={kw['Kxr'].shape[-1]}, Rh="
                    f"{kw['Kxh'].shape[-1]}) output {j}", dk, dp, tube,
                    m64[:, j], GP_HALL_REL_TOL, d0=d0)
                gh_errs.append(err)
                gh_rels.append(rel)
                if j == 0:
                    hall_in[kw["nh"]] = kw
        if it == 2:
            qp_warm_c, _, _, _ = sqp.assemble_qp(
                spec_c, env_c, hyp_c, ocp_c, st_c, Xc, Uc, gp_it, eps_it)
            ws_warm_c, wv_warm_c = ws, wv
        Xn, Un, gp_it, sol = sqp.sqp_iteration(
            spec_c, env_c, hyp_c, ocp_c, st_c, Xc, Uc, gp_it, eps_it,
            qp_ws=ws, qp_valid=wv, hall_empty=(it == 0))
        if int(sol.status) != 0:
            fail(f"car SQP iteration {it}: QP status {int(sol.status)}")
        Xc, Uc, ws, wv = Xn, Un, sol.state, sol.status == 0
    if sorted(hall_in) != [Ty_c * spec_c.H * k
                           for k in range(1, spec_c.max_sqp_iter)]:
        fail(f"car hall fills {sorted(hall_in)}")
    results["gp_sample"]["max_abs_err_car"] = max(gs_errs)
    results["gp_hall"].update(max_abs_err=max(gh_errs),
                              max_rel_tube=max(gh_rels))

    X0c, U0c = sqp.init_iterate(spec_c, dev, f32, data_c.start)
    qp0_c, _, _, _ = sqp.assemble_qp(
        spec_c, env_c, hyp_c, ocp_c, T(cphys[0]), X0c, U0c,
        agent.reset_hall(gp_c), eps_c[0, 0], hall_empty=True)
    p, d = checks.report("car cold, step 0", qp0_c, None, None)
    prep_errs.append(p)
    mehr_errs.append(d)
    p, d = checks.report(f"car warm, step {CAR_STEP} SQP iteration 2",
                         qp_warm_c, ws_warm_c, wv_warm_c)
    prep_errs.append(p)
    mehr_errs.append(d)
    results["ipm_prepare"].update(max_abs_err=max(prep_errs),
                                  err_relative_to="each field's max |plain|")
    results["ipm_mehrotra"]["max_abs_err"] = max(mehr_errs)

    # ---- 8. car closed loop ---------------------------------------------
    ex, eu, kx, ku, its_tf = [], [], [], [], []
    for m in range(n_car):
        if m == 0:
            Xs, Us = X0c, U0c
        else:                                   # shift_soln: False
            Xs, Us = T(cX[m - 1]), T(cU[m - 1])
        st_m = T(cphys[m])
        st = sqp.solve(spec_c, env_c, hyp_c, ocp_c, st_m, Xs, Us, gp_c,
                       eps_c[m])
        with plain_route():
            sp = sqp.solve(spec_c, env_c, hyp_c, ocp_c, st_m, Xs, Us, gp_c,
                           eps_c[m])
        if int(st.status) != 0 or int(sp.status) != 0:
            fail(f"car teacher-forced step {m}: status {int(st.status)} "
                 f"(plain {int(sp.status)})")
        its_tf.append((st.it, sp.it))
        ex.append(float(np.max(np.abs(st.X.cpu().numpy() - tfX[m]))))
        eu.append(float(np.max(np.abs(st.U.cpu().numpy() - tfU[m]))))
        kx.append(float(torch.max(torch.abs(st.X - sp.X))))
        ku.append(float(torch.max(torch.abs(st.U - sp.U))))
    print(f"[loop] car teacher-forced {n_car} steps vs the f64 golden: status"
          f" 0 all; max|dX| {max(ex):.3e} (tol {TF_CAR_TOL_X}), max|dU| "
          f"{max(eu):.3e} (tol {TF_CAR_TOL_U}); per step dX "
          f"{[round(v, 4) for v in ex]}; SQP iterations kernel/plain "
          f"{its_tf}", flush=True)
    print(f"[loop] car teacher-forced {n_car} steps, kernels vs plain "
          f"versions: max|dX| {max(kx):.3e} (tol {TF_CAR_KP_TOL_X}), max|dU| "
          f"{max(ku):.3e} (tol {TF_CAR_KP_TOL_U}); per step dX "
          f"{[f'{v:.2e}' for v in kx]}, dU {[f'{v:.2e}' for v in ku]}",
          flush=True)
    if max(ex) > TF_CAR_TOL_X or max(eu) > TF_CAR_TOL_U:
        fail("car teacher-forced closed loop outside the f32 tolerance")
    if max(kx) > TF_CAR_KP_TOL_X or max(ku) > TF_CAR_KP_TOL_U:
        fail("car teacher-forced kernel path disagrees with the plain path")

    mpc_c = DEMPC(params_c, spec_c, data_c, env_c, device=dev, dtype=f32,
                  epistemic=gc["eps"])
    sqp_its = []
    zero_launch_counts()
    torch.cuda.synchronize()
    with sqp_iterations(sqp, sqp_its):
        out_c = mpc_c.run()
    torch.cuda.synchronize()
    launches_car = launch_counts()
    traj = np.stack(out_c["physical_state_traj"] + [out_c["final_state"]])
    step_ms_c = [1e3 * t for t in out_c["solver_time"]]
    window_c = sum(step_ms_c[1:]) / (len(step_ms_c) - 1)
    print(f"[loop] car free-running {n_car} steps (DEMPC.run, cuda float32):"
          f" statuses {sorted(set(out_c['sqp_status_traj']))}, finite "
          f"{bool(np.isfinite(traj).all())}, final state "
          f"{out_c['final_state']} (golden {gc['final_state']}); SQP "
          f"iterations per step {sqp_its}; qp iters {out_c['qp_iters']}",
          flush=True)
    print(f"[loop] car ms per MPC step over steps 1..{n_car - 1}: mean "
          f"{window_c} (median {statistics.median(step_ms_c[1:])}, max "
          f"{max(step_ms_c[1:])}); first step {step_ms_c[0]}; per step "
          f"{[round(v, 3) for v in step_ms_c]}; launches {launches_car}",
          flush=True)
    if set(out_c["sqp_status_traj"]) != {0} or not np.isfinite(traj).all():
        fail("car free-running closed loop")
    if min(launches_car.values()) <= 0:
        fail(f"a kernel of the car path was not launched: {launches_car}")

    # ---- 9. timing at the main paths' shapes ----------------------------
    def time_gp_sample(label, kw):
        ns, Ht, R = kw["Kxm"].shape
        t_k = cuda_ms(lambda: gp_sample.sample_empty_one(**kw))
        t_p = cuda_ms(lambda: gp_sample.sample_empty_plain(**kw), n=10,
                      k=1)
        cov_batch = (kw["Ktt"] + 1e-3 * torch.eye(Ht, device=dev)
                     ).contiguous()
        t_chol = cuda_ms(lambda: torch.linalg.cholesky(cov_batch))
        nb, fl = gp_sample_bound(ns, Ht, R)
        b, by = bound_ms(nb, fl)
        print(f"[timing] gp_sample {label} (ns={ns}, Ht={Ht}, R={R}): kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b:.5f} ms ({by}: "
              f"{nb} B, {fl:.3e} flop); partial yardstick "
              f"torch.linalg.cholesky of the ({ns},{Ht},{Ht}) batch "
              f"{t_chol:.4f} ms (only the factorization)", flush=True)
        return dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
                    partial_library_ms=t_chol)

    results["gp_sample"].update(time_gp_sample("pendulum", gp_in),
                                library_ms=None)
    results["gp_sample"]["car"] = time_gp_sample("car", car_gp_in)

    hall_rows = []
    for nh, kw in sorted(hall_in.items()):
        ns, Ht, Rr = kw["Kxr"].shape
        t_k = cuda_ms(lambda: gp_hall.sample_hall_one(**kw))
        t_p = cuda_ms(lambda: gp_hall.sample_hall_plain(**kw), n=5, warm=1,
                      k=1)
        C = kw["Linv"] @ kw["Arh"][..., :nh]
        S = (kw["Ahh"][:, :nh, :nh] - C.transpose(1, 2) @ C
             + kw["jitter"] * torch.eye(nh, device=dev)).contiguous()
        t_chol = cuda_ms(lambda: torch.linalg.cholesky(S))
        nb, fl = gp_hall_bound(ns, Ht, Rr, nh)
        b, by = bound_ms(nb, fl)
        print(f"[timing] gp_hall nh={nh} (ns={ns}, Ht={Ht}, Rr={Rr}, Rh="
              f"{kw['Kxh'].shape[-1]}): kernels {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {b:.5f} ms ({by}: {nb} B, {fl:.3e} flop);"
              f" partial yardstick torch.linalg.cholesky of the ({ns},{nh},"
              f"{nh}) Schur batch {t_chol:.4f} ms (only the factorization)",
              flush=True)
        hall_rows.append(dict(nh=nh, ms=t_k, plain_ms=t_p, bound_ms=b,
                              bound_by=by, partial_library_ms=t_chol))
    per_step = launches_car["gp_hall"] / n_car
    print(f"[timing] gp_hall launches per car MPC step {per_step} "
          f"({spec_c.g_ny} outputs x {spec_c.max_sqp_iter - 1} hall "
          f"iterations when every step runs {spec_c.max_sqp_iter})",
          flush=True)
    top = hall_rows[-1]
    results["gp_hall"].update(
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None,
        partial_library_ms=top["partial_library_ms"], nh=top["nh"],
        by_fill=hall_rows, launches_per_mpc_step=per_step)

    prep_t, mehr_t = checks.timing("pendulum cold", qp0, None, None)
    results["ipm_prepare"].update(prep_t, library_ms=None)
    results["ipm_mehrotra"].update(mehr_t, library_ms=None)
    checks.timing("pendulum warm", qpm, sa.qp_ws, sa.qp_valid)
    car_prep, car_mehr = checks.timing("car cold", qp0_c, None, None)
    results["ipm_prepare"]["car"] = car_prep
    results["ipm_mehrotra"]["car"] = car_mehr
    checks.timing("car warm", qp_warm_c, ws_warm_c, wv_warm_c)

    # ---- 10. kernels 5-7 through their own entry point ------------------
    linalg, launches_linalg = linalg_phase(dev)

    # ---- 11. forward-sampling reachability at full width ----------------
    fs_phase(dev)

    # ---- report -----------------------------------------------------------
    meta = {
        "gp_sample": ("csrc/gp_sample.cu",
                      "sampling_gpmpc_tpu/ops/pallas_gp.py:148"),
        "gp_hall": ("csrc/gp_hall.cu",
                    "sampling_gpmpc_tpu/ops/pallas_gp.py:229"),
        "ipm_prepare": ("csrc/ipm.cu",
                        "sampling_gpmpc_tpu/ops/pallas_ipm.py:423"),
        "ipm_mehrotra": ("csrc/ipm.cu",
                         "sampling_gpmpc_tpu/ops/pallas_ipm.py:112"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for name, (src, rep) in meta.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sampling_gpmpc_torch/" + src, "replaces": rep,
            # this slice's main path (the car loop) runs all four kernels
            "launches": launches_car[name],
            "launches_pendulum": launches_pend[name],
            **{k: r[k] for k in keys},
            **{k: v for k, v in r.items() if k not in keys}})
    # kernels 5-7: launches from the microbench (their entry point), times
    # at the forward-sampling shape, every shape under "by_shape"
    meta_linalg = {
        "chol": ("csrc/batch_linalg.cu",
                 "sampling_gpmpc_tpu/ops/batch_linalg.py:87"),
        "tri_solve": ("csrc/batch_linalg.cu",
                      "sampling_gpmpc_tpu/ops/batch_linalg.py:166"),
        "batched_chol": ("csrc/batched_chol.cu",
                         "sampling_gpmpc_tpu/ops/pallas_chol.py:31"),
    }
    for name, (src, rep) in meta_linalg.items():
        rows = linalg[name]
        fs_row = max(rows, key=lambda r: r["B"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sampling_gpmpc_torch/" + src, "replaces": rep,
            "launches": launches_linalg[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: fs_row[k] for k in keys if k != "max_abs_err"},
            "shape": {k: fs_row[k] for k in ("B", "n", "m") if k in fs_row},
            "by_shape": rows})
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
