#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``sampling_gpmpc_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. build   — compile every CUDA kernel (one nvcc per source, in parallel),
             print each kernel's registers and spills and the card's name
             and power limit;
params_pendulum1D_samples (ns=70, H=17, one SQP iteration):
2. gp      — the GP-sample kernel vs its plain torch version on the inputs
             of SQP iteration 0, held by the tube criterion
             |y - mu| <= beta (sigma + sigma_n) and pointwise to the plain
             version within 1e-3 of the tube;
3. ipm     — on the first QP of that solve and on a warm-started later QP:
             the whole kernel solve vs the plain solver, the prepare
             kernel's every output and its warm/cold flag vs prepare_plain,
             and the Mehrotra kernel vs the plain loop on the same prepared
             problem; both kernels on a 16-CTA cluster, the [ipm] lines
             naming each one's branch (resident or streamed);
4. loop    — the closed loop on cuda float32 with the stored oracle's
             epistemic draws: 20 teacher-forced steps, each through the
             kernels and through their plain versions, against each other
             and against tests/goldens/oracle_pendulum1d_flagship.npz; then
             20 free-running steps (DEMPC.run, the main path) with the
             kernels' launch counters zeroed before it and read after it;
params_car (ns=20, H=15, four SQP iterations, 4 soft ellipse obstacles):
5. gp      — the GP-sample kernel at the car shape (Ht=60, R=180), each
             output alone and all three outputs in one launch (the main
             path's call), with the same two checks;
6. gp_hall — the hall-block kernels at the fills nh = 60, 120, 180 of one
             solve's iterations 1-3, each output alone (the one-output
             call) and all three outputs in one launch set (the main
             path's call), plus all three at nh = 0: against the float64
             reference posterior (tube, 0 violations), pointwise against
             the plain version of each output, and a check that the
             pointwise bar would fail a kernel that returned the mean or
             ignored eps;
7. ipm     — the three IPM checks on the car's cold step-0 QP and on the
             warm QP of SQP iteration 2, and on seeded QPs: one too wide for
             the kernels' slices to stay in shared memory (nU=20,
             m_h=52,000, m_s=512: the streamed branches; the closed loops'
             QPs take the resident ones), and two Schur matrices wider than
             the closed loops' (nU=64 resident, nU=128 streamed: the
             block-wide factor and the kernel build for up to 33 Schur
             pairs a thread);
8. loop    — 6 teacher-forced car steps (the golden's first 6 of 12)
             through the kernels and through the plain versions, against
             each other and against tests/goldens/torch_oracle_car.npz;
             then 6 free-running steps
             (DEMPC.run) with the counters zeroed before and read after,
             SQP iterations and ms per step;
the 2D pendulum's GP stages (params_pendulum: ns=20, Ht=120, R=180, hall
capacity Rh=360), seeded with the port's kernel_matrix up to the full
capacity, where the earlier kernels refused the TPU kernels' shapes:
9. f1      — the GP-sample kernel, both outputs in one launch, and the
             hall-block kernels at nh = 120 (factor tiles in shared
             memory), 240 and 360 (tiles in the global workspace), each
             against the float64 evaluation of its algorithm (tube, 0
             violations) and pointwise against its plain version, with the
             mean-only check;
10. timing — each kernel at the main paths' shapes (CUDA events around
             back-to-back warm calls queued behind a sleep kernel, median)
             beside its plain version and its bound (the IPM kernels on
             both loops' cold and warm QPs, prepare also on the three
             seeded wide QPs), and gp_sample's and gp_hall's launches per
             car MPC step;
kernels 5-7, the batched small-matrix linalg (off the closed loop):
11. linalg — their own entry point, sampling_gpmpc_torch.microbench_linalg
             (chol, tri_solve both ways, batched_cholesky(use_kernel=True)
             at the JAX microbench's shapes and the fs shape B=12000, n=50,
             m=1), counters zeroed before and read after; then each kernel
             vs its plain version there and at B=60, n=180 (the JAX tests'
             bars: 2e-4 factors, 3e-4 solves; upper triangles exactly 0),
             the NaN pattern of a failed pivot (column 17 at n = 60; 17, 32
             and 100 at n = 180), the solve's NaN pattern of a zero pivot
             and of a NaN right-hand-side entry (n = 60 and 180, both
             directions), and their timing beside the plain version,
             torch.linalg (both directions for the solve) and the bound;
params_car_residual_fs (ns=4000 value-only realizations x 50 steps):
12. fs     — forward_sample_rollout, cuda float32, replaying the
             car_residual golden's last plan and on zero inputs, each
             against the same draws in cuda float64 (at most 1 non-finite
             realization, 0.25 per realization, 0.15 on the envelope of the
             first 256, 1.2x the JAX float32 path's own envelope error on
             all 4000, inside the state box + 10x its width), and sampled
             steps/s (warm, median of 3);
the hard-constraint QP family (m_s = 0, the IPM kernels' hard-only build):
13. pend2d — params_pendulum at full width (ns=20, H=30, three SQP
             iterations, two outputs; QP nU=30, m_h=2460): golden step 5's
             solve walked through the kernels (gp_sample, gp_hall at
             nh = 120 and 240, each against the float64 posterior and the
             plain version), the three IPM checks on the cold step-0 QP and
             on the warm QP of SQP iteration 2; 10 teacher-forced steps
             through the kernels and the plain versions against
             tests/goldens/torch_oracle_pendulum.npz; 10 free-running steps
             (DEMPC.run) with the counters zeroed before and read after, ms
             per step against dt = 15 ms; the IPM kernels' timing cold and
             warm;
14. car_residual — params_car_residual at full width (ns=1, H=50, up to
             150 SQP iterations; QP nU=100, m_h=800; the oracle sample, so
             no GP stage): its one MPC step (counters zeroed before, read
             after) against tests/goldens/params_car_residual.npz, the IPM
             checks on its first and its last QP, their timing;
15. h1     — params_pendulum_samples (ns=500), params_pendulum_invariant
             and params_pendulum1D_invariant (H = 1, QP nU = 1): 4
             free-running steps each on the port's own draws (finite, the
             JAX float64 run's SQP status, every kernel of the path
             launched), and on the first stage (and the 1D config's first
             hall stage, Ht = 3) and first QP each kernel against its plain
             version; the IPM timing at nU=1, m_h=2002, cold and warm;
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
# The GP-sample kernel vs its plain version at the 2D pendulum's own
# stages (params_pendulum: noise 1e-6, three inputs with their gradient
# tasks), where the posterior variance near the data cancels to its
# float32 floor (Ktt - V'V): the plain version's own float32 draw sits
# 0.35-0.59 of the tube width from its float64 evaluation on the same
# inputs (phase pend2d prints it; the tube's sigma_n covers that floor),
# and the kernel 1.006e-3 of the tube from the plain version (output 0,
# golden step 5, on an H100), past the 1e-3 of the other stages.  Ten times
# that reading, as for GP_HALL_REL_TOL; a kernel that returned the mean
# reads 0.3 or more.
GP_PEND2D_REL_TOL = 1e-2
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
# Car steps of phase 8, teacher-forced and free-running: the golden's first
# 6 of 12, so that the hard-constraint phases (13-15) fit the script's time
CAR_LOOP_STEPS = 6
# Batched Cholesky / triangular-solve kernels vs their plain versions: the
# JAX package's own bars for its kernels (tests/test_batch_linalg.py).
LINALG_F_TOL, LINALG_S_TOL = 2e-4, 3e-4
# A seeded QP at the pendulum's width at ns=512, too wide for the Mehrotra
# kernel's G slices to stay in shared memory.
WIDE_QP = (20, 52000, 512)
# Seeded QPs whose Schur matrices are wider than the closed loops' (nU, m_h,
# m_s, G slices resident in shared memory).
WIDE_SCHUR_QPS = ((64, 4000, 400, True), (128, 20000, 1000, False))
# The 2D pendulum's GP stages (params/params_pendulum.yaml: 20 samples,
# H = 30 test points of D = 3 inputs with their gradient tasks, Ty = 4, so
# Ht = 120; 45 real points, R = 180; a hall capacity of 90 points, Rh =
# 360), where the earlier kernels refused the shapes the TPU kernels take.
# These stages are seeded, so that they reach the full hall capacity
# (nh = 360) that the closed loop's three SQP iterations do not: the blocks
# come from the port's kernel_matrix on seeded points, with the config's
# lengthscales and outputscales, the real targets drawn from the GP prior
# and the hall targets near the real-data posterior mean.  The noise is
# 1e-4 (the config's is 1e-6) so that the float32 real factor stays well
# conditioned (condition number ~2e4), as the tube criterion needs.  Phase
# pend2d runs the config's own stages.
F1_NS, F1_H, F1_D, F1_REAL, F1_HALL = 20, 30, 3, 45, 90
F1_LS = ((5.2649, 4.5967, 7.0177), (3.9696, 2.1265, 6.6749))
F1_OS, F1_NOISE, F1_BETA = (0.65, 0.55), 1e-4, 2.5
F1_FILLS = (120, 240, 360)
# The hard-constraint QP family (m_s = 0: the kernels' hard-only build).
# params_pendulum at full width against its float64 golden (10 steps,
# written by tests/make_torch_pendulum_golden.py); the stage and QP checks
# run on the solve of golden step PEND2D_STEP.
PEND2D_CONFIG = "params_pendulum"
PEND2D_GOLDEN = os.path.join(HERE, "tests", "goldens",
                             "torch_oracle_pendulum.npz")
PEND2D_STEP = 5
# Its float32 teacher-forced envelope against the golden's float64
# teacher-forced plans: the JAX package's float32 path deviates by up to
# 0.3009 in X and 3.925 in U over the 10 steps (the port's plain float32
# path 0.2998 / 3.763; measured on the CPU by tests/test_torch_pendulum.py
# ::test_f32_teacher_forced_pendulum_envelope).  Flat input directions of
# the float32 QP exit, as for the 1D pendulum and the car; the two paths
# deviate alike step by step, so the deviation is the float32 problem's,
# not either solver's.  The bar is about twice the JAX path's envelope, as
# TF_TOL_X/_U and TF_CAR_TOL_X/_U are for the other two loops.
TF_PEND_TOL_X, TF_PEND_TOL_U = 0.62, 7.9
# Kernel path vs plain path per step, on the same inputs: both float32
# solves of the same algorithm, so their difference is bounded by the
# same envelope.
TF_PEND_KP_TOL_X, TF_PEND_KP_TOL_U = TF_PEND_TOL_X, TF_PEND_TOL_U
# params_car_residual's one MPC step against tests/goldens/
# params_car_residual.npz: the JAX package's float32 path leaves that
# float64 plan by 7.33e-4 in X and 0.0176 in U (the port's plain float32
# path 6.3e-4 / 0.0052; tests/test_torch_pendulum.py::
# test_f32_car_residual_plan_envelope).  The bar is about twice the JAX
# path's error, as for the teacher-forced loops.
CAR_RES_CONFIG = "params_car_residual"
CAR_RES_TOL_X, CAR_RES_TOL_U = 1.5e-3, 3.6e-2
# The H = 1 configs and the SQP status of the JAX package's float64 run at
# every step (params_pendulum1D_invariant: 4, the reference's own).
H1_CONFIGS = (("params_pendulum_samples", 0), ("params_pendulum_invariant", 0),
              ("params_pendulum1D_invariant", 4))
H1_STEPS = 4
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
# reading, and 0.15 to the first 256, the width it was written for.
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
    saved = (gp_sample.sample_empty, gp_hall.sample_hall, ipm.run_full)
    gp_sample.sample_empty = gp_sample.sample_empty_plain_stacked
    gp_hall.sample_hall = gp_hall.sample_hall_plain_stacked
    ipm.run_full = ipm.run_full_plain
    try:
        yield
    finally:
        (gp_sample.sample_empty, gp_hall.sample_hall,
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


def kernel_name(mangled):
    """A mangled kernel name as in its source, with its template arguments
    (ipm_prepare_kernel<1,0>): the first length-prefixed name in it that
    ends in _kernel."""
    import re
    for i, ch in enumerate(mangled):
        if not ch.isdigit() or (i and mangled[i - 1].isdigit()):
            continue
        run = re.match(r"\d+", mangled[i:]).group()
        for j in range(len(run)):           # the length may be a suffix
            n, at = int(run[j:]), i + len(run)
            name = mangled[at:at + n]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*",
                                                         name):
                t = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[at + n:])
                args = re.findall(r"L[a-z](\d+)E", t.group(1)) if t else []
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_usage(log):
    """(kernel, line) for each register and spill line of nvcc's -Xptxas
    -v log (kernel_name of the function the lines belong to)."""
    import re
    fn, out = "?", []
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )(\S+?)'?"
                      r"(?: for |$)", line.strip())
        if m:
            fn = kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            out.append((fn, line.strip()))
    return out


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


def f1_stages(dev, seed=0):
    """The 2D pendulum's seeded empty-hall stage (gp_sample.sample_empty's
    arguments, both outputs stacked) and hall stages at the fills F1_FILLS
    (gp_hall.sample_hall's), float32 on ``dev``, each beside the float64
    evaluation of its algorithm: (stacked float32 inputs, mean64, var64)."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.gp import exact
    from sampling_gpmpc_torch.gp.kernel import kernel_matrix
    from sampling_gpmpc_torch.ops import gp_hall, gp_sample
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    ty = F1_D + 1
    Ht, R, Rh = F1_H * ty, F1_REAL * ty, F1_HALL * ty
    scal = dict(jitter=1e-6, beta=F1_BETA, var_zero=-1.0, rel_floor=1e-5,
                ty=ty)
    empty, hall = [], {nh: [] for nh in F1_FILLS}
    for ls_, os_ in zip(F1_LS, F1_OS):
        ls = torch.tensor(ls_, dtype=f64)
        box = lambda *shape: torch.tensor(
            rng.uniform(-3.0, 3.0, size=shape + (F1_D,)), dtype=f64) * ls
        Zr, Xt, Zh = box(F1_REAL), box(F1_NS, F1_H), box(F1_NS, F1_HALL)
        Krr = kernel_matrix(Zr, Zr, ls, os_, True) + F1_NOISE * torch.eye(
            R, dtype=f64)
        Lr = torch.linalg.cholesky(Krr)
        Linv = torch.linalg.inv(Lr)
        w_r = torch.tensor(rng.normal(size=R), dtype=f64)   # y_r = Lr w_r
        alpha = Linv.T @ w_r
        Zrb = Zr.expand((F1_NS,) + Zr.shape)
        Kall = kernel_matrix(Xt, torch.cat([Zrb, Zh, Xt], dim=1), ls, os_,
                             True)
        eps = torch.tensor(np.clip(rng.normal(size=(F1_NS, Ht)), -2.5, 2.5),
                           dtype=f64)
        pv = exact.prior_task_variances(ls, os_, ty).repeat(F1_H)
        empty.append(dict(Kxm=Kall[..., :R], Ktt=Kall[..., R + Rh:], eps=eps,
                          Linv=Linv, alpha=alpha, prior_var=pv))
        ev1 = kernel_matrix(torch.cat([Zrb, Zh], dim=1), Zh, ls, os_, True)
        yh_full = (ev1[:, :R].transpose(1, 2) @ alpha
                   + 0.01 * torch.tensor(rng.normal(size=(F1_NS, Rh)),
                                         dtype=f64))
        for nh in F1_FILLS:
            m = (torch.arange(Rh) < nh).to(f64)
            Khh = ev1[:, R:] + F1_NOISE * torch.eye(Rh, dtype=f64)
            hall[nh].append(dict(
                Kxr=Kall[..., :R], Kxh=Kall[..., R:R + Rh] * m,
                Ktt=Kall[..., R + Rh:], Arh=ev1[:, :R] * m,
                Ahh=m[:, None] * Khh * m[None, :] + torch.diag(1.0 - m),
                yh=yh_full * m, eps=eps, Linv=Linv, w_r=w_r, prior_var=pv))

    def stack(kws):
        return {k: torch.stack([kw[k] for kw in kws]) for k in kws[0]}

    def to32(st):
        return {k: v.to(device=dev, dtype=torch.float32).contiguous()
                for k, v in st.items()}

    def empty_ref(kw):
        V = kw["Linv"] @ kw["Kxm"].transpose(1, 2)
        var = (torch.diagonal(kw["Ktt"], dim1=-2, dim2=-1)
               - (V * V).sum(1))
        return (kw["Kxm"] @ kw["alpha"][:, None])[..., 0], var

    refs = [empty_ref(kw) for kw in empty]
    out = {"empty": (dict(to32(stack(empty)), **scal),
                     torch.stack([r[0] for r in refs]).to(dev),
                     torch.stack([r[1] for r in refs]).to(dev))}
    for nh in F1_FILLS:
        refs = [gp_hall.bordered_factor(
            nh, **{k: kw[k] for k in ("Kxr", "Kxh", "Ktt", "Arh", "Ahh",
                                      "yh", "Linv", "w_r")},
            jitter=scal["jitter"])[1:] for kw in hall[nh]]
        out[nh] = (dict(to32(stack(hall[nh])), nh=nh, **scal),
                   torch.stack([r[0] for r in refs]).to(dev),
                   torch.stack([r[1] for r in refs]).to(dev))
    assert set(out["empty"][0]) - {"jitter", "beta", "var_zero",
                                   "rel_floor", "ty"} <= set(gp_sample.STACKED)
    return out


def f1_tube(mean64, var64, prior_var, beta=F1_BETA):
    """beta (sigma + sigma_n) around the float64 evaluation, as
    :func:`tube_width`."""
    import torch
    sig_n = torch.sqrt(NOISE_REL * prior_var.to(torch.float64))
    return beta * (torch.sqrt(torch.clamp(var64, min=0.0)) + sig_n)


def hall_output(st, j):
    """Output j's arguments of gp_hall.sample_hall_one, from those of
    gp_hall.sample_hall (every output stacked on a leading axis)."""
    from sampling_gpmpc_torch.ops import gp_hall
    return {k: (v[j] if k in gp_hall.STACKED and v is not None else v)
            for k, v in st.items()}


def tube_width(spec, mean64, cov64, prior_var):
    """beta (sigma + sigma_n) around the float64 posterior, sigma_n the
    float32 cancellation floor of the variance."""
    import torch
    var64 = torch.clamp(torch.diagonal(cov64, dim1=-2, dim2=-1), min=0.0)
    sig_n = torch.sqrt(NOISE_REL * prior_var.to(torch.float64))
    return spec.gp.beta * (torch.sqrt(var64) + sig_n)


def as64(kw):
    """A stage's arguments with every tensor in float64."""
    import torch
    return {k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()}


def stage_walk(tag, spec, env, hyp, hyp64, ocp, gp, gp64, st, X, U, eps,
               per_output, ref64=False):
    """One teacher-forced solve walked SQP iteration by SQP iteration
    through the kernels.  Each iteration's GP stage is checked on the
    inputs the solve gives it (iteration 0 on the empty buffer, iteration
    k >= 1 at fill k H Ty) against the float64 posterior (tube, 0
    violations) and pointwise against the plain version: every output in
    one launch (set), the main path's call; with ``per_output`` also each
    output alone, and the empty buffer through the hall stage at iteration
    1; with ``ref64`` (the 2D pendulum: GP_PEND2D_REL_TOL on its empty
    stage) the plain version is also evaluated in float64 on the same
    inputs (gp_report's ``d64``).  Then the iteration runs and
    feeds the next.  Returns the stage
    inputs (``empty``: every output, ``one``: output 0 alone, ``hall``:
    {fill: every output}), ``warm``: the QP of iteration 2 with its carried
    state and flag, and the errors."""
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ops import gp_hall, gp_sample
    f64 = torch.float64
    gidx, Ty, Ht = list(spec.g_idx_inputs), spec.Ty, spec.H * spec.Ty
    gp_it, ws, wv = agent.reset_hall(gp), None, None
    out = dict(one=None, empty=None, hall={}, warm=None, gs_errs=[],
               gh_errs=[], gh_rels=[])

    def stacked_report(label, st_in, dps, d0s, tubes, means, d64s=None):
        """All outputs in one launch set (the main path's call) against
        the plain version of each output."""
        dk = gp_hall.sample_hall(**st_in)
        for j in range(spec.g_ny):
            err, rel = gp_report(
                "gp_hall", spec, f"{label}, nh={st_in['nh']}, all "
                f"{spec.g_ny} outputs in one launch set: output {j}", dk[j],
                dps[j], tubes[j], means[j], GP_HALL_REL_TOL, d0=d0s[j],
                d64=d64s[j] if d64s else None)
            out["gh_errs"].append(err)
            out["gh_rels"].append(rel)

    for it in range(spec.max_sqp_iter):
        Xt = sqp._linearization_inputs(spec, ocp, X, U)[..., gidx]
        eps_it = eps[it]
        gp64_it = gp64._replace(hall_Z=gp_it.hall_Z.to(f64),
                                hall_Y=gp_it.hall_Y.to(f64),
                                hall_n=gp_it.hall_n)
        m64r, c64r = agent._batched_posterior_real(spec, hyp64, gp64_it,
                                                   Xt.to(f64))
        if it == 0:
            m64, c64 = m64r, c64r
        else:
            m64, c64 = agent._batched_posterior_incremental(
                spec, hyp64, gp64_it, Xt.to(f64))
        dps, d0s, tubes, d64s = [], [], [], []
        for j in range(spec.g_ny):
            if it == 0:
                kw = agent.empty_stage_inputs(spec, hyp, gp_it, Xt, eps_it,
                                              j)
                dp = gp_sample.sample_empty_plain(**kw)
                if ref64:
                    d64s.append(gp_sample.sample_empty_plain(**as64(kw)))
                    d0s.append(gp_sample.sample_empty_plain(
                        **dict(kw, eps=torch.zeros_like(kw["eps"]))))
                tube = tube_width(spec, m64[:, j], c64[:, j],
                                  kw["prior_var"])
                if per_output:
                    err, _ = gp_report(
                        "gp", spec, f"{tag} ns={spec.ns} Ht={Ht} "
                        f"R={kw['Kxm'].shape[-1]} output {j} alone",
                        gp_sample.sample_empty_one(**kw), dp, tube,
                        m64[:, j], GP_REL_TOL)
                    out["gs_errs"].append(err)
                if j == 0:
                    out["one"] = kw
            else:
                kw = agent.hall_stage_inputs(spec, hyp, gp_it, Xt, eps_it, j)
                dp = gp_hall.sample_hall_plain(**kw)
                if ref64:
                    d64s.append(gp_hall.sample_hall_plain(**as64(kw)))
                d0 = gp_hall.sample_hall_plain(
                    **dict(kw, eps=torch.zeros_like(kw["eps"])))
                tube = tube_width(spec, m64[:, j], c64[:, j],
                                  kw["prior_var"])
                if per_output:
                    err, rel = gp_report(
                        "gp_hall", spec, f"{tag} SQP iteration {it}, nh="
                        f"{kw['nh']} (Rr={kw['Kxr'].shape[-1]}, Rh="
                        f"{kw['Kxh'].shape[-1]}) output {j} alone",
                        gp_hall.sample_hall_one(**kw), dp, tube, m64[:, j],
                        GP_HALL_REL_TOL, d0=d0)
                    out["gh_errs"].append(err)
                    out["gh_rels"].append(rel)
                d0s.append(d0)
            dps.append(dp)
            tubes.append(tube)
        if it == 0:
            # every output in one launch: the main path's call
            st_in = agent.empty_stage_inputs_all(spec, hyp, gp_it, Xt, eps_it)
            dk = gp_sample.sample_empty(**st_in)
            for j in range(spec.g_ny):
                err, _ = gp_report(
                    "gp", spec, f"{tag} ns={spec.ns} Ht={Ht} R="
                    f"{st_in['Kxm'].shape[-1]}, all {spec.g_ny} outputs in "
                    f"one launch: output {j}", dk[j], dps[j], tubes[j],
                    m64[:, j], GP_PEND2D_REL_TOL if ref64 else GP_REL_TOL,
                    d0=d0s[j] if ref64 else None,
                    d64=d64s[j] if ref64 else None)
                out["gs_errs"].append(err)
            out["empty"] = st_in
        else:
            st_in = agent.hall_stage_inputs_all(spec, hyp, gp_it, Xt, eps_it)
            stacked_report(f"{tag} SQP iteration {it}", st_in, dps, d0s,
                           tubes, [m64[:, j] for j in range(spec.g_ny)],
                           d64s)
            out["hall"][st_in["nh"]] = st_in
        if it == 1 and per_output:
            # the empty buffer through the hall stage: the real-data
            # posterior
            st_in = agent.hall_stage_inputs_all(
                spec, hyp, agent.reset_hall(gp_it), Xt, eps_it)
            one = [hall_output(st_in, j) for j in range(spec.g_ny)]
            stacked_report(
                f"{tag}, empty hall buffer", st_in,
                [gp_hall.sample_hall_plain(**kw) for kw in one],
                [gp_hall.sample_hall_plain(
                    **dict(kw, eps=torch.zeros_like(kw["eps"])))
                 for kw in one],
                [tube_width(spec, m64r[:, j], c64r[:, j],
                            one[j]["prior_var"])
                 for j in range(spec.g_ny)],
                [m64r[:, j] for j in range(spec.g_ny)])
            out["hall"][0] = st_in
        if it == 2:
            qp, _, _, _ = sqp.assemble_qp(spec, env, hyp, ocp, st, X, U,
                                          gp_it, eps_it)
            out["warm"] = (qp, ws, wv)
        Xn, Un, gp_it, sol = sqp.sqp_iteration(
            spec, env, hyp, ocp, st, X, U, gp_it, eps_it, qp_ws=ws,
            qp_valid=wv, hall_empty=(it == 0))
        if int(sol.status) != 0:
            fail(f"{tag} SQP iteration {it}: QP status {int(sol.status)}")
        X, U, ws, wv = Xn, Un, sol.state, sol.status == 0
    fills = sorted(out["hall"])
    if fills != [Ht * k for k in range(0 if per_output else 1,
                                       spec.max_sqp_iter)]:
        fail(f"{tag} hall fills {fills}")
    return out


def build_name(m_s):
    """The IPM kernels' build a QP runs (csrc/ipm.cu's SOFT argument)."""
    return ("soft build" if m_s else
            "hard-only build SOFT=false, library ipm_hard")


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
        and which start each took (the kernel's one-word ``warm`` flag, the
        plain version's ``warm``)."""
        import torch
        ipm, band = self.ipm, self.qp.WS_BAND
        qp_args = tuple(a.contiguous() for a in qp_args)
        d = ipm.prepare(*qp_args, ws, wv, band)
        p = ipm.prepare_plain(*qp_args, ws, wv, band)
        warm_k = bool(d.warm[0])
        warm_p = p.warm is not None and bool(p.warm)
        fields = ipm.prepared_fields(d, p)
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

    def report(self, label, qp_args, ws, wv, resident=True, status=0):
        """The three checks; ``status`` 4 for a QP that no solver can meet
        (params_pendulum1D_invariant's infeasible rows 0 <= -2.4): then the
        kernel and the plain version end with that status after the same
        iterations, at the same iterate (1e-3 of its scale), and the
        float64 solve is not a bound."""
        import torch
        f64 = torch.float64
        nU, m_h, m_s = (qp_args[1].shape[0], qp_args[3].shape[0],
                        qp_args[5].shape[0])
        lay = self.ipm.loop_layout(nU, m_h, m_s)
        play = self.ipm.prepare_layout(nU, m_h, m_s)
        n_cl = self.ipm.cluster_size(m_s)
        build = build_name(m_s)
        print(f"[ipm] {label}: prepare kernel ({build}) on a cluster of "
              f"{n_cl} CTAs, "
              f"{'resident' if play.resident else 'streamed'} branch (G "
              f"slices, row values and warm candidate "
              f"{'in shared memory' if play.resident else f'from global memory, staged {play.chunk} rows a chunk'}"
              f"; {play.smem} B of shared memory per CTA)", flush=True)
        print(f"[ipm] {label}: Mehrotra kernel ({build}) on a cluster of "
              f"{n_cl} CTAs, "
              f"G slices and state rows "
              f"{'in shared memory' if lay.resident else 'streamed from global memory'}"
              f" ({lay.smem} B of shared memory per CTA)", flush=True)
        # at the QPs checked here both kernels take the same branch
        if lay.resident != resident or play.resident != resident:
            fail(f"IPM {label}: expected the "
                 f"{'resident' if resident else 'streamed'} branch")
        k, p, ex = self.solve_pair(qp_args, ws, wv)
        du = float(torch.max(torch.abs(k.z - p.z)))
        ek = float(torch.max(torch.abs(k.z.to(f64) - ex.z)))
        ep = float(torch.max(torch.abs(p.z.to(f64) - ex.z)))
        scale = 1.0 + float(torch.max(torch.abs(ex.z)))
        # the kernel may sit anywhere in the f32 tolerance ball, but no
        # farther from the exact solution than twice the plain f32 solver
        bound = 2.0 * ep + 1e-3 * scale
        if status:
            bound = 1e-3 * (1.0 + float(torch.max(torch.abs(p.z))))
        print(f"[ipm] {label}: nU={qp_args[1].shape[0]} "
              f"m_h={qp_args[3].shape[0]} m_s={qp_args[5].shape[0]}: "
              f"|du kernel - plain|inf = {du:.3e}; |u - u_f64|inf kernel "
              f"{ek:.3e} plain {ep:.3e} (bound {bound:.3e}); status "
              f"{int(k.status)}/{int(p.status)}; kkt {float(k.gap):.3e}/"
              f"{float(p.gap):.3e}; iters {int(k.iters)}/{int(p.iters)}",
              flush=True)
        if int(k.status) != status or int(p.status) != status or (
                du if status else ek) > bound or (
                status and int(k.iters) != int(p.iters)):
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
        met = (float(rk) <= stat_tol, float(rp) <= stat_tol)
        if du_m > bound or met != ((status == 0),) * 2 or (
                status and int(ik) != int(ip)):
            fail(f"IPM Mehrotra kernel {label}")
        return rel_prep, du_m

    def timing_prepare(self, label, qpa, ws, wv):
        """Kernel and plain times of the prepare stage on one QP, with its
        bound (each input read once, each output written once; the warm
        start's three matvecs)."""
        from sampling_gpmpc_torch.microbench_linalg import cuda_ms
        ipm, band = self.ipm, self.qp.WS_BAND
        qpa = tuple(a.contiguous() for a in qpa)
        nU, m_h, m_s = qpa[1].shape[0], qpa[3].shape[0], qpa[5].shape[0]
        prep = ipm.prepare(*qpa, ws, wv, band)
        t_pk = cuda_ms(lambda: ipm.prepare(*qpa, ws, wv, band))
        t_pp = cuda_ms(lambda: ipm.prepare_plain(*qpa, ws, wv, band), n=10,
                       k=1)
        m = m_h + m_s
        pb = 4 * (nU * nU + nU + 2 * nU * m + m_h + 6 * m_s
                  + (0 if ws is None else nU + m_h + 6 * m_s)
                  + 4 * m_h + 16 * m_s + 1 + m + 1)
        pf = 4 * nU * m + (0 if ws is None else 6 * nU * m)
        bp, byp = bound_ms(pb, pf)
        lay = ipm.prepare_layout(nU, m_h, m_s)
        branch = "resident" if lay.resident else "streamed"
        warm = bool(prep.warm[0])
        print(f"[timing] ipm prepare {label} (nU={nU}, m_h={m_h}, m_s={m_s}"
              f"; {build_name(m_s)}, {branch} branch, cluster of "
              f"{ipm.cluster_size(m_s)} CTAs, "
              f"{'warm' if warm else 'cold'} start): kernel {t_pk:.4f} ms, "
              f"plain {t_pp:.4f} ms, bound {bp:.5f} ms ({byp}: {pb} B, "
              f"{pf:.3e} flop)", flush=True)
        return dict(ms=t_pk, plain_ms=t_pp, bound_ms=bp, bound_by=byp,
                    branch=branch, warm=warm), prep

    def timing(self, label, qpa, ws, wv):
        """Kernel and plain times of both IPM stages on one QP, with their
        bounds, for this QP's iteration count."""
        from sampling_gpmpc_torch.microbench_linalg import cuda_ms
        ipm, band = self.ipm, self.qp.WS_BAND
        tol, reg, consts = self.tol, self.reg, self.consts
        qpa = tuple(a.contiguous() for a in qpa)
        nU, m_h, m_s = qpa[1].shape[0], qpa[3].shape[0], qpa[5].shape[0]
        prep_t, prep = self.timing_prepare(label, qpa, ws, wv)
        t_mk = cuda_ms(lambda: ipm.mehrotra(prep, tol, reg, 150, *consts),
                       k=2)
        pp = ipm.prepare_plain(*qpa, ws, wv, band)
        t_mp = cuda_ms(lambda: ipm.mehrotra_plain(pp, tol, reg, 150, *consts),
                       n=5, warm=1, k=1)
        iters = int(ipm.mehrotra(prep, tol, reg, 150, *consts)[2])
        m = m_h + m_s
        mb = 4 * (nU * nU + nU + nU * m + 4 * m_h + 16 * m_s + 1
                  + nU + 2 * m_h + 8 * m_s + 2)
        mf = iters * (nU * (nU + 1) * m + 9 * 2 * nU * m + nU ** 3 / 3
                      + 4 * nU * nU + 60 * m)
        bm, bym = bound_ms(mb, mf)
        print(f"[timing] ipm {label} (nU={nU}, m_h={m_h}, m_s={m_s}, "
              f"{iters} iterations): prepare kernel {prep_t['ms']:.4f} ms, "
              f"plain {prep_t['plain_ms']:.4f} ms, bound "
              f"{prep_t['bound_ms']:.5f} ms ({prep_t['bound_by']}); mehrotra "
              f"kernel {t_mk:.4f} ms, plain {t_mp:.4f} ms, bound {bm:.5f} ms "
              f"({bym}: {mb} B, {mf:.3e} flop)", flush=True)
        return prep_t, dict(ms=t_mk, plain_ms=t_mp, bound_ms=bm, bound_by=bym,
                            iters=iters)


def gp_report(tag, spec, label, dk, dp, tube, mean64, rel_tol, d0=None,
              d64=None):
    """Tube violations of the kernel and the plain draws around the float64
    posterior, and the kernel's pointwise distance to the plain version as
    a share of the tube width; with ``d0`` (the plain draw at eps = 0, the
    posterior mean), also the share a kernel that returned the mean or
    ignored eps would read, which must be far above the bar.  With ``d64``
    (the plain version evaluated in float64 on the same inputs), also how
    far each float32 version is from that evaluation: the float32 rounding
    of the stage itself, against which the bar is set."""
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
    if d64 is not None:
        rel_k64 = float(torch.max(torch.abs(dk.to(f64) - d64) / tube))
        rel_p64 = float(torch.max(torch.abs(dp.to(f64) - d64) / tube))
        extra += (f"; vs the float64 evaluation of the algorithm: kernel "
                  f"{rel_k64:.3e}, plain {rel_p64:.3e} of the tube width")
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
    """A failed pivot or a NaN input: the kernel's NaN entries equal the
    plain version's and its finite entries agree to the bar."""
    import torch
    same = torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref) & torch.isfinite(got)
    err = float(torch.abs(got - ref)[fin].max()) if bool(fin.any()) else 0.0
    n_nan = int(torch.isnan(got).sum())
    print(f"[linalg] {label}: NaN pattern "
          f"{'identical' if same else 'DIFFERENT'} ({n_nan} NaN of "
          f"{got.numel()}); finite entries max|diff| {err:.3e}", flush=True)
    if not same or err > tol:
        fail(f"linalg {label}: NaN pattern")


def linalg_phase(dev):
    """Kernels 5-7 through their own entry point (the microbench of
    sampling_gpmpc_torch/microbench_linalg.py: chol, tri_solve both ways,
    batched_cholesky(use_kernel=True) at its shapes and the fs shape), with
    the launch counts zeroed before it and read after; then each kernel
    against its plain version at those shapes and at (B=60, n=180), the
    NaN patterns of failed pivots, and the timing rows."""
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
            bound_by=bt_by, library_ms=r["tri_lib_ms"],
            library_ms_transposed=r["tri_lib_t_ms"]))
        out["batched_chol"].append(dict(
            common, max_abs_err=e_b, ms=r["bchol_ms"], plain_ms=t_pb,
            bound_ms=bc_ms, bound_by=bc_by, library_ms=r["chol_lib_ms"]))
        print(f"[timing] linalg {tag} m={m}: chol kernel {r['chol_ms']:.4f} "
              f"ms, plain {t_pc:.4f}, torch.linalg {r['chol_lib_ms']:.4f}, "
              f"bound {bc_ms:.5f} ({bc_by}); tri_solve kernel "
              f"{r['tri_ms']:.4f} ms (transposed {r['tri_t_ms']:.4f}), plain "
              f"{t_pt:.4f}, torch.linalg {r['tri_lib_ms']:.4f} (transposed "
              f"{r['tri_lib_t_ms']:.4f}), bound "
              f"{bt_ms:.5f} ({bt_by}); batched_chol kernel "
              f"{r['bchol_ms']:.4f} ms, plain {t_pb:.4f}", flush=True)

    # a pivot that goes negative mid-way: NaN from that column on, in the
    # pattern of each TPU kernel (batch_linalg: rows below it NaN in every
    # lower column; pallas_chol: rows from it down NaN in every column); at
    # n = 180 inside a 32-column panel (17), on a panel's first column (32)
    # and deep in the factor (100)
    for row, j0 in ((rows[0], 17), (rows[-1], 17), (rows[-1], 32),
                    (rows[-1], 100)):
        S_bad = row["S"].clone()
        S_bad[:, j0, j0] = -1.0
        tag = f"B={row['B']} n={row['n']} pivot {j0}, indefinite input"
        nan_pattern_report(f"chol {tag}", bl.chol(S_bad),
                           bl.chol_plain(S_bad), LINALG_F_TOL)
        nan_pattern_report(f"batched_chol {tag}",
                           bc.batched_cholesky(S_bad, use_kernel=True),
                           bc.batched_cholesky_plain(S_bad), LINALG_F_TOL)
        if not (torch.triu(bl.chol(S_bad), 1) == 0).all():
            fail(f"linalg chol {tag}: non-zero upper triangle on an "
                 "indefinite input")
    # the solve: a zero pivot (every column NaN, as the TPU kernel's masked
    # update spreads it) and a NaN in one right-hand-side column (that
    # column NaN in every row), in both directions
    for row, j0 in ((rows[0], 17), (rows[-1], 100)):
        L0 = row["L"].clone()
        L0[:, j0, j0] = 0.0
        R1 = row["R"].clone()
        R1[:, j0, 0] = float("nan")
        tag = f"B={row['B']} n={row['n']} m={row['m']}"
        for tr in (False, True):
            for what, Lx, Rx in ((f"zero pivot {j0}", L0, row["R"]),
                                 (f"NaN in column 0 at row {j0}", row["L"],
                                  R1)):
                nan_pattern_report(
                    f"tri_solve{' transposed' if tr else ''} {tag} {what}",
                    bl.tri_solve(Lx, Rx, lower_factor_transposed=tr),
                    bl.tri_solve_plain(Lx, Rx, tr), LINALG_S_TOL)
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
              f"{FS_JAX_ENV[label]}; the first-256 bar {FS_ENV_TOL} would "
              f"read {'met' if env_all <= FS_ENV_TOL else 'not met'} at this "
              f"width, as the reference's own does); inside box "
              f"+ margin {inside}", flush=True)
        print(f"[fs] {FS_CONFIG} {label}: {rates[label]:.1f} sampled "
              f"steps/s (ns*T / wall, warm, median of 3 rollouts: "
              f"{[round(w, 4) for w in walls]} s); peak device memory "
              f"{peak:.3f} GiB", flush=True)
        if (n_bad > 1 or per_real > FS_REAL_TOL or env_head > FS_ENV_TOL
                or env_all > env_bar or not inside):
            fail(f"fs {label}")
    return rates


@contextlib.contextmanager
def captured_qps(out):
    """Record the QP of every ``ipm.run_full`` call (the 11 arrays, the
    carried state and its flag, cloned) into ``out``, first call first."""
    from sampling_gpmpc_torch.ops import ipm
    run = ipm.run_full

    def recording(*a, **k):
        clone = lambda t: None if t is None else t.clone()
        out.append((tuple(clone(t) for t in a[:11]),
                    None if a[11] is None else tuple(map(clone, a[11])),
                    clone(a[12])))
        return run(*a, **k)

    ipm.run_full = recording
    try:
        yield
    finally:
        ipm.run_full = run


def free_run(tag, params, spec, data, env, dev, epistemic=None):
    """DEMPC.run through the kernels, cuda float32, with the launch counts
    zeroed just before it and read just after.  Returns (out, launches,
    per-step ms); out["sqp_its"] holds each step's SQP iterations."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.dempc import DEMPC
    from sampling_gpmpc_torch.ocp import sqp
    mpc = DEMPC(params, spec, data, env, device=dev, dtype=torch.float32,
                epistemic=epistemic)
    its = []
    zero_launch_counts()
    torch.cuda.synchronize()
    with sqp_iterations(sqp, its):
        out = mpc.run()
    torch.cuda.synchronize()
    launches = launch_counts()
    out["sqp_its"] = its
    traj = np.stack(out["physical_state_traj"] + [out["final_state"]])
    step_ms = [1e3 * t for t in out["solver_time"]]
    print(f"[{tag}] free-running {spec.num_mpc_iter} steps (DEMPC.run, cuda "
          f"float32): statuses {out['sqp_status_traj']}, finite "
          f"{bool(np.isfinite(traj).all())}, final state "
          f"{out['final_state']}; SQP iterations {its}; qp iters "
          f"{out['qp_iters']}; launches {launches}", flush=True)
    if not np.isfinite(traj).all():
        fail(f"{tag} free-running closed loop: non-finite state")
    return out, launches, step_ms


def stage_ref64(st, nh=None):
    """The float64 evaluation of a GP stage's algorithm on its own
    (float32) inputs, every output: mean and variance (the empty stage's
    Kxm alpha and diag(Ktt) - |Linv Kxm'|^2; the hall stage's bordered
    factor at fill nh)."""
    import torch
    from sampling_gpmpc_torch.ops import gp_hall
    f64 = lambda k: st[k].to(torch.float64)
    if nh is None:
        V = f64("Linv")[:, None] @ f64("Kxm").transpose(-1, -2)
        var = (torch.diagonal(f64("Ktt"), dim1=-2, dim2=-1)
               - (V * V).sum(-2))
        return (f64("Kxm") @ f64("alpha")[:, None, :, None])[..., 0], var
    refs = [gp_hall.bordered_factor(
        nh, *(st[k][j].to(torch.float64) for k in (
            "Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh", "Linv", "w_r")),
        jitter=st["jitter"])[1:] for j in range(st["Kxr"].shape[0])]
    return (torch.stack([r[0] for r in refs]),
            torch.stack([r[1] for r in refs]))


def pendulum2d_phase(dev, checks, results):
    """params_pendulum at full width (ns=20, H=30, three SQP iterations,
    two outputs; QP nU=30, m_h=2460, m_s=0): one teacher-forced solve's GP
    stages (nh = 0, 120, 240) and the IPM checks on its cold step-0 QP and
    a warm QP; 10 teacher-forced steps through the kernels and the plain
    versions against tests/goldens/torch_oracle_pendulum.npz; 10
    free-running steps (DEMPC.run) with the counts zeroed before and read
    after; the IPM kernels' timing at the QP's shape.  Returns the
    free-running launches."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    f32, f64 = torch.float32, torch.float64
    T = lambda a: torch.as_tensor(a, dtype=f32, device=dev)
    g = np.load(PEND2D_GOLDEN)
    params, spec, data = load_problem(
        os.path.join(HERE, "params", PEND2D_CONFIG + ".yaml"))
    n = int(g["n_steps"])
    if (spec.ns, spec.H, spec.max_sqp_iter) != (
            int(g["ns"]), int(g["H"]), int(g["max_sqp_iter"])):
        fail("the 2D pendulum golden does not match the config")
    spec = dataclasses.replace(spec, num_mpc_iter=n)
    env = make_env(spec, params)
    ocp = make_ocp_data(spec, data, dev, f32)
    hyp = GPHyperArrays.from_spec(spec.gp, dev, f32)
    hyp64 = GPHyperArrays.from_spec(spec.gp, dev, f64)
    gp = agent.init_gp_state(spec, env, dev, f32, hyp=hyp)
    gp64 = agent.init_gp_state(spec, env, dev, f64, hyp=hyp64)
    eps = T(g["eps"])
    phys, sX, sU = (g["physical_state_traj"], g["start_X_traj"],
                    g["start_U_traj"])

    m = PEND2D_STEP
    walk = stage_walk("2D pendulum", spec, env, hyp, hyp64, ocp, gp, gp64,
                      T(phys[m]), T(sX[m]), T(sU[m]), eps[m],
                      per_output=False, ref64=True)
    if sorted(walk["hall"]) != [120, 240]:
        fail(f"2D pendulum hall fills {sorted(walk['hall'])}")
    results["gp_sample"]["max_abs_err_pendulum_2d_stage"] = max(
        walk["gs_errs"])
    results["gp_hall"]["max_abs_err_pendulum_2d_stage"] = max(
        walk["gh_errs"])
    qp0, _, _, _ = sqp.assemble_qp(spec, env, hyp, ocp, T(phys[0]), T(sX[0]),
                                   T(sU[0]), agent.reset_hall(gp), eps[0, 0],
                                   hall_empty=True)
    qpw, wsw, wvw = walk["warm"]
    errs = [checks.report("2D pendulum cold, step 0", qp0, None, None),
            checks.report(f"2D pendulum warm, step {m} SQP iteration 2",
                          qpw, wsw, wvw)]

    ex, eu, kx, ku = [], [], [], []
    for m in range(n):
        start = (T(phys[m]), T(sX[m]), T(sU[m]))
        st = sqp.solve(spec, env, hyp, ocp, *start, gp, eps[m])
        with plain_route():
            sp = sqp.solve(spec, env, hyp, ocp, *start, gp, eps[m])
        if int(st.status) != 0 or int(sp.status) != 0:
            fail(f"2D pendulum teacher-forced step {m}: status "
                 f"{int(st.status)} (plain {int(sp.status)})")
        ex.append(float(np.max(np.abs(st.X.cpu().numpy() - g["tf_X_traj"][m]))))
        eu.append(float(np.max(np.abs(st.U.cpu().numpy() - g["tf_U_traj"][m]))))
        kx.append(float(torch.max(torch.abs(st.X - sp.X))))
        ku.append(float(torch.max(torch.abs(st.U - sp.U))))
    print(f"[loop] 2D pendulum teacher-forced {n} steps vs the f64 golden: "
          f"status 0 all; max|dX| {max(ex):.3e} (tol {TF_PEND_TOL_X}), "
          f"max|dU| {max(eu):.3e} (tol {TF_PEND_TOL_U}); per step dX "
          f"{[round(v, 4) for v in ex]}, dU {[round(v, 4) for v in eu]}",
          flush=True)
    print(f"[loop] 2D pendulum teacher-forced {n} steps, kernels vs plain "
          f"versions: max|dX| {max(kx):.3e} (tol {TF_PEND_KP_TOL_X}), "
          f"max|dU| {max(ku):.3e} (tol {TF_PEND_KP_TOL_U}); per step dX "
          f"{[f'{v:.2e}' for v in kx]}, dU {[f'{v:.2e}' for v in ku]}",
          flush=True)
    if max(ex) > TF_PEND_TOL_X or max(eu) > TF_PEND_TOL_U:
        fail("2D pendulum teacher-forced steps outside the JAX float32 "
             "envelope")
    if max(kx) > TF_PEND_KP_TOL_X or max(ku) > TF_PEND_KP_TOL_U:
        fail("2D pendulum teacher-forced kernel path disagrees with the "
             "plain path")

    out, launches, step_ms = free_run("loop", params, spec, data, env, dev,
                                      epistemic=g["eps"])
    window = sum(step_ms[1:]) / (len(step_ms) - 1)
    print(f"[loop] 2D pendulum ms per MPC step over steps 1..{n - 1}: mean "
          f"{window} (median {statistics.median(step_ms[1:])}, max "
          f"{max(step_ms[1:])}) against dt = {1e3 * spec.dt:.1f} ms; first "
          f"step {step_ms[0]}; per step {[round(v, 3) for v in step_ms]}",
          flush=True)
    if set(out["sqp_status_traj"]) != {0}:
        fail("2D pendulum free-running closed loop: status")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the 2D pendulum path was not launched: {launches}")

    cold = checks.timing("2D pendulum cold", qp0, None, None)
    warm = checks.timing("2D pendulum warm", qpw, wsw, wvw)
    return dict(launches=launches, errs=errs, timing=(cold, warm),
                ms_per_step=window, dt_ms=1e3 * spec.dt)


def car_residual_phase(dev, checks):
    """params_car_residual at full width (ns=1, H=50, up to 150 SQP
    iterations; QP nU=100, m_h=800, m_s=0; the oracle sample, so no GP
    stage): its one MPC step (DEMPC.run, the counts zeroed before and read
    after) against tests/goldens/params_car_residual.npz, the IPM checks
    on its first and its last QP, and their timing."""
    import numpy as np
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    g = np.load(FS_GOLDEN)
    params, spec, data = load_problem(
        os.path.join(HERE, "params", CAR_RES_CONFIG + ".yaml"))
    env = make_env(spec, params)
    qps = []
    with captured_qps(qps):
        out, launches, step_ms = free_run("car_residual", params, spec, data,
                                          env, dev)
    dX = float(np.abs(out["state_traj"][-1] - g["last_plan_X"]).max())
    dU = float(np.abs(out["input_traj"][-1] - g["last_plan_U"]).max())
    print(f"[car_residual] one MPC step, {out['sqp_iters']} SQP iterations "
          f"({len(qps)} QPs, m_s = 0) in {step_ms[0]:.1f} ms: plan vs the "
          f"float64 golden max|dX| {dX:.3e} (tol {CAR_RES_TOL_X}), max|dU| "
          f"{dU:.3e} (tol {CAR_RES_TOL_U}; the JAX float32 path reads "
          f"7.33e-4 / 1.76e-2); launches {launches}", flush=True)
    if out["sqp_status_traj"] != [0] or dX > CAR_RES_TOL_X \
            or dU > CAR_RES_TOL_U:
        fail("params_car_residual plan")
    if launches["ipm_prepare"] != len(qps) or \
            launches["ipm_mehrotra"] != len(qps) or \
            launches["gp_sample"] or launches["gp_hall"]:
        fail(f"params_car_residual launches {launches} for {len(qps)} QPs")
    (qa, _, _), (qz, wsz, wvz) = qps[0], qps[-1]
    errs = [checks.report("car_residual cold, SQP iteration 0", qa, None,
                          None),
            checks.report(f"car_residual warm, SQP iteration {len(qps) - 1}",
                          qz, wsz, wvz)]
    cold = checks.timing("car_residual cold", qa, None, None)
    warm = checks.timing("car_residual warm", qz, wsz, wvz)
    return dict(launches=launches, errs=errs, timing=(cold, warm),
                plan_err=(dX, dU), sqp_iters=out["sqp_iters"])


def h1_phase(dev, checks):
    """The three H = 1 configs (QP nU = 1, m_s = 0): H1_STEPS free-running
    steps each on the port's own draws (counts zeroed before, read after),
    each step finite with the JAX float64 run's SQP status; on the first
    stage and first QP each kernel against its plain version.  Returns
    per config the launches and, for params_pendulum_samples, the IPM
    timing cold (step 0) and warm (step 1)."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    from sampling_gpmpc_torch.ops import gp_hall, gp_sample
    f32 = torch.float32
    res = {}
    for name, status in H1_CONFIGS:
        params, spec, data = load_problem(
            os.path.join(HERE, "params", name + ".yaml"))
        spec = dataclasses.replace(spec, num_mpc_iter=H1_STEPS)
        env = make_env(spec, params)
        qps = []
        with captured_qps(qps):
            out, launches, step_ms = free_run(name, params, spec, data, env,
                                              dev)
        # the hall stage runs from SQP iteration 1, which a failed QP at
        # iteration 0 ends before (params_pendulum1D_invariant, as in the
        # JAX package: one SQP iteration a step)
        need = ["gp_sample", "ipm_prepare", "ipm_mehrotra"] + (
            ["gp_hall"] if max(out["sqp_its"]) > 1 else [])
        print(f"[{name}] SQP statuses {out['sqp_status_traj']} (the JAX "
              f"float64 run's: {status} at every step); ms per step "
              f"{[round(v, 2) for v in step_ms]}", flush=True)
        if out["sqp_status_traj"] != [status] * H1_STEPS:
            fail(f"{name}: SQP statuses {out['sqp_status_traj']}")
        if min(launches[k] for k in need) <= 0:
            fail(f"{name}: a kernel of its path was not launched: {launches}")

        # the first stage (and, with more SQP iterations, the first hall
        # stage) and the first QP, kernel against plain
        ocp = make_ocp_data(spec, data, dev, f32)
        hyp = GPHyperArrays.from_spec(spec.gp, dev, f32)
        gp = agent.reset_hall(agent.init_gp_state(spec, env, dev, f32,
                                                  hyp=hyp))
        eps = agent.make_epistemic(spec, torch.Generator().manual_seed(1),
                                   dev, f32)[0]
        st = torch.as_tensor(data.start, dtype=f32, device=dev)
        X, U = sqp.init_iterate(spec, dev, f32, data.start)
        Xt = sqp._linearization_inputs(spec, ocp, X, U)[
            ..., list(spec.g_idx_inputs)]
        stages = [(None, agent.empty_stage_inputs_all(spec, hyp, gp, Xt,
                                                      eps[0]))]
        if spec.max_sqp_iter > 1:
            X1, U1, gp1, _ = sqp.sqp_iteration(spec, env, hyp, ocp, st, X, U,
                                               gp, eps[0], hall_empty=True)
            Xt1 = sqp._linearization_inputs(spec, ocp, X1, U1)[
                ..., list(spec.g_idx_inputs)]
            hall = agent.hall_stage_inputs_all(spec, hyp, gp1, Xt1, eps[1])
            stages.append((hall["nh"], hall))
        for nh, kw in stages:
            empty = nh is None
            dk = (gp_sample.sample_empty if empty else gp_hall.sample_hall)(**kw)
            plain = (gp_sample.sample_empty_plain_stacked if empty
                     else gp_hall.sample_hall_plain_stacked)
            dps = plain(**kw)
            d0s = plain(**dict(kw, eps=torch.zeros_like(kw["eps"])))
            d64s = plain(**as64(kw))
            m64, v64 = stage_ref64(kw, nh)
            for j in range(dk.shape[0]):
                gp_report("gp" if empty else "gp_hall", None,
                          f"{name} {'gp_sample' if empty else 'gp_hall'} "
                          f"ns={spec.ns} Ht={kw['Ktt'].shape[-1]}"
                          f"{'' if empty else f' nh={nh}'} output {j}", dk[j],
                          dps[j], f1_tube(m64[j], v64[j], kw["prior_var"][j],
                                          spec.gp.beta),
                          m64[j], GP_REL_TOL if empty else GP_HALL_REL_TOL,
                          d0=d0s[j], d64=d64s[j])
        (qa, _, _) = qps[0]
        err = checks.report(f"{name} cold, step 0", qa, None, None,
                            status=status)
        res[name] = dict(launches=launches, err=err)
        if name == "params_pendulum_samples":
            qb, wsb, wvb = qps[1]
            res[name]["timing"] = (
                checks.timing(f"{name} cold", qa, None, None),
                checks.timing(f"{name} warm, step 1", qb, wsb, wvb))
    return res


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
    from sampling_gpmpc_torch.ops import build, gp_hall, gp_sample, ipm

    dev = setup.resolve_device("cuda")
    f32, f64 = torch.float32, torch.float64
    T = lambda a: torch.as_tensor(a, dtype=f32, device=dev)
    results = {"gp_sample": {}, "gp_hall": {}, "ipm_prepare": {},
               "ipm_mehrotra": {}}
    checks = IPMChecks()
    t_start = time.perf_counter()

    def phase(name):
        print(f"[phase] {name} from {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    card = gpu_line()
    print(f"[build] {len(logs)} sources ({', '.join(logs)}) in {build_s:.1f}"
          f" s (nvcc {' '.join(build.FLAGS)})", flush=True)
    for name, log in logs.items():
        for fn, line in ptxas_usage(log):
            print(f"[build] {name} {fn}: {line}", flush=True)
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
    phase("gp")
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
    phase("ipm")
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
    phase("loop")
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
    n_car = min(int(gc["n_steps"]), CAR_LOOP_STEPS)
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

    # ---- 5.-7. one solve's GP stages and QPs, iteration by iteration ----
    phase("car gp, gp_hall, ipm")
    # golden step CAR_STEP, teacher-forced: each SQP iteration's GP stage
    # is checked on the inputs the solve gives it (iteration 0 on the
    # empty buffer, iterations 1-3 at fills 60, 120, 180), then the
    # iteration runs through the kernels and feeds the next
    walk = stage_walk("car", spec_c, env_c, hyp_c, hyp_c64, ocp_c, gp_c,
                      gp_c64, T(cphys[CAR_STEP]), T(cX[CAR_STEP - 1]),
                      T(cU[CAR_STEP - 1]), eps_c[CAR_STEP], per_output=True)
    car_gp_in, car_empty_in = walk["one"], walk["empty"]
    hall_in = walk["hall"]
    qp_warm_c, ws_warm_c, wv_warm_c = walk["warm"]
    results["gp_sample"]["max_abs_err_car"] = max(walk["gs_errs"])
    results["gp_hall"].update(max_abs_err=max(walk["gh_errs"]),
                              max_rel_tube=max(walk["gh_rels"]))

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
    qp_wide = ipm.seeded_qp(*WIDE_QP, 3, dev)
    p, d = checks.report(f"wide seeded QP (nU, m_h, m_s) = {WIDE_QP}",
                         qp_wide, None, None, resident=False)
    prep_errs.append(p)
    mehr_errs.append(d)
    for nU, m_h, m_s, resident in WIDE_SCHUR_QPS:
        p, d = checks.report(
            f"wide Schur seeded QP (nU, m_h, m_s) = {(nU, m_h, m_s)}",
            ipm.seeded_qp(nU, m_h, m_s, 3, dev), None, None,
            resident=resident)
        prep_errs.append(p)
        mehr_errs.append(d)
    results["ipm_prepare"].update(max_abs_err=max(prep_errs),
                                  err_relative_to="each field's max |plain|")
    results["ipm_mehrotra"]["max_abs_err"] = max(mehr_errs)

    # ---- 8. car closed loop ---------------------------------------------
    phase("car loop")
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

    # ---- 9. the 2D pendulum's GP stages, seeded ------------------------
    phase("f1")
    f1 = f1_stages(dev)
    f1_errs = []
    st, m64, v64 = f1["empty"]
    no1, _, Ht1, R1 = st["Kxm"].shape
    lay = gp_sample.sample_layout(Ht1)
    dk = gp_sample.sample_empty(**st)
    dps = gp_sample.sample_empty_plain_stacked(**st)
    d0s = gp_sample.sample_empty_plain_stacked(
        **dict(st, eps=torch.zeros_like(st["eps"])))
    for j in range(no1):
        err, _ = gp_report(
            "f1", None, f"2D pendulum gp_sample ns={F1_NS} Ht={Ht1} R={R1} "
            f"({lay[0]} B of shared memory; rows, V' block, tiles in the "
            f"workspace: {lay[2]}), all {no1} outputs in one launch: output "
            f"{j}", dk[j], dps[j], f1_tube(m64[j], v64[j], st["prior_var"][j]),
            m64[j], GP_REL_TOL, d0=d0s[j])
        f1_errs.append(err)
    for nh in F1_FILLS:
        st, m64, v64 = f1[nh]
        dk = gp_hall.sample_hall(**st)
        dps = gp_hall.sample_hall_plain_stacked(**st)
        d0s = gp_hall.sample_hall_plain_stacked(
            **dict(st, eps=torch.zeros_like(st["eps"])))
        branch = ("global" if gp_hall.factor_tiles_global(Ht1, nh)
                  else "shared")
        for j in range(no1):
            err, _ = gp_report(
                "f1", None, f"2D pendulum gp_hall nh={nh} (Rr={R1}, Rh="
                f"{st['Kxh'].shape[-1]}; factor tiles in {branch} memory), "
                f"all {no1} outputs in one launch set: output {j}", dk[j],
                dps[j], f1_tube(m64[j], v64[j], st["prior_var"][j]), m64[j],
                GP_HALL_REL_TOL, d0=d0s[j])
            f1_errs.append(err)
    results["gp_sample"]["max_abs_err_pendulum_2d"] = max(f1_errs[:no1])
    results["gp_hall"]["max_abs_err_pendulum_2d"] = max(f1_errs[no1:])

    # ---- 10. timing at the main paths' shapes ---------------------------
    phase("timing")
    def time_gp_sample(label, st):
        """The every-output call (the main path's) on stacked inputs."""
        no, ns, Ht, R = st["Kxm"].shape
        t_k = cuda_ms(lambda: gp_sample.sample_empty(**st))
        t_p = cuda_ms(lambda: gp_sample.sample_empty_plain_stacked(**st),
                      n=5, warm=1, k=1)
        cov_batch = (st["Ktt"].reshape(no * ns, Ht, Ht)
                     + 1e-3 * torch.eye(Ht, device=dev)).contiguous()
        t_chol = cuda_ms(lambda: torch.linalg.cholesky(cov_batch))
        nb, fl = gp_sample_bound(ns, Ht, R)
        b, by = bound_ms(no * nb, no * fl)
        print(f"[timing] gp_sample {label} (no={no}, ns={ns}, Ht={Ht}, R={R}"
              f"): all {no} outputs in one launch {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {b:.5f} ms ({by}: {no * nb} B, "
              f"{no * fl:.3e} flop); partial yardstick torch.linalg.cholesky "
              f"of the ({no * ns},{Ht},{Ht}) covariance batch {t_chol:.4f} "
              f"ms (only the factorization)", flush=True)
        return dict(ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
                    partial_library_ms=t_chol)

    stack1 = {k: (v[None] if k in gp_sample.STACKED and v is not None
                  else v) for k, v in gp_in.items()}
    results["gp_sample"].update(time_gp_sample("pendulum", stack1),
                                library_ms=None)
    results["gp_sample"]["car"] = time_gp_sample("car", car_empty_in)
    t_1 = cuda_ms(lambda: gp_sample.sample_empty_one(**car_gp_in))
    results["gp_sample"]["car"]["ms_one_output"] = t_1
    results["gp_sample"]["pendulum_2d"] = time_gp_sample(
        "2D pendulum, seeded", f1["empty"][0])
    per_step_gs = launches_car["gp_sample"] / n_car
    results["gp_sample"]["launches_per_car_mpc_step"] = per_step_gs
    print(f"[timing] gp_sample car one output alone {t_1:.4f} ms; launches "
          f"per car MPC step {per_step_gs} (one call per stage, all "
          f"{spec_c.g_ny} outputs)", flush=True)

    hall_rows = []
    for nh, st in sorted(hall_in.items()):
        no, ns, Ht, Rr = st["Kxr"].shape
        kw0 = hall_output(st, 0)
        t_k = cuda_ms(lambda: gp_hall.sample_hall(**st))
        t_1 = cuda_ms(lambda: gp_hall.sample_hall_one(**kw0))
        t_p = cuda_ms(lambda: gp_hall.sample_hall_plain_stacked(**st), n=5,
                      warm=1, k=1)
        C = st["Linv"][:, None] @ st["Arh"][..., :nh]
        S = (st["Ahh"][..., :nh, :nh] - C.transpose(-1, -2) @ C
             + st["jitter"] * torch.eye(nh, device=dev)).contiguous()
        t_chol = cuda_ms(lambda: torch.linalg.cholesky(S)) if nh else None
        nb, fl = gp_hall_bound(ns, Ht, Rr, nh)
        b1, by1 = bound_ms(nb, fl)
        b, by = bound_ms(no * nb, no * fl)
        print(f"[timing] gp_hall nh={nh} (ns={ns}, Ht={Ht}, Rr={Rr}, Rh="
              f"{st['Kxh'].shape[-1]}): all {no} outputs in one launch set "
              f"{t_k:.4f} ms (bound {b:.5f} ms, {by}: {no * nb} B, "
              f"{no * fl:.3e} flop), plain {t_p:.4f} ms; one output "
              f"{t_1:.4f} ms (bound {b1:.5f} ms); partial yardstick "
              f"torch.linalg.cholesky of "
              f"the ({no * ns},{nh},{nh}) Schur batch "
              f"{'-' if t_chol is None else f'{t_chol:.4f} ms'} (only the "
              f"factorization)", flush=True)
        hall_rows.append(dict(nh=nh, ms=t_k, ms_one_output=t_1,
                              plain_ms=t_p, bound_ms=b, bound_by=by,
                              bound_ms_one_output=b1,
                              partial_library_ms=t_chol))
    f1_hall = []
    for nh in F1_FILLS:
        st = f1[nh][0]
        no, ns, Ht, Rr = st["Kxr"].shape
        t_k = cuda_ms(lambda: gp_hall.sample_hall(**st))
        t_p = cuda_ms(lambda: gp_hall.sample_hall_plain_stacked(**st), n=3,
                      warm=1, k=1)
        nb, fl = gp_hall_bound(ns, Ht, Rr, nh)
        b, by = bound_ms(no * nb, no * fl)
        branch = "global" if gp_hall.factor_tiles_global(Ht, nh) else "shared"
        print(f"[timing] gp_hall 2D pendulum, seeded, nh={nh} (no={no}, "
              f"ns={ns}, Ht={Ht}, Rr={Rr}, Rh={st['Kxh'].shape[-1]}; factor "
              f"tiles in {branch} memory): all {no} outputs in one launch set "
              f"{t_k:.4f} ms (bound {b:.5f} ms, {by}), plain {t_p:.4f} ms",
              flush=True)
        f1_hall.append(dict(nh=nh, tiles=branch, ms=t_k, plain_ms=t_p,
                            bound_ms=b, bound_by=by))
    per_step = launches_car["gp_hall"] / n_car
    hall_its = sum(k - 1 for k in sqp_its) / n_car
    print(f"[timing] gp_hall launches per car MPC step {per_step} (one stage "
          f"call per hall iteration, all {spec_c.g_ny} outputs: "
          f"{hall_its} hall iterations per step in this run)", flush=True)
    top = hall_rows[-1]
    results["gp_hall"].update(
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None,
        ms_one_output=top["ms_one_output"],
        partial_library_ms=top["partial_library_ms"], nh=top["nh"],
        by_fill=hall_rows, pendulum_2d_by_fill=f1_hall,
        launches_per_mpc_step=per_step)

    prep_t, mehr_t = checks.timing("pendulum cold", qp0, None, None)
    results["ipm_prepare"].update(prep_t, library_ms=None)
    results["ipm_mehrotra"].update(mehr_t, library_ms=None)
    pend_warm_prep, pend_warm_mehr = checks.timing(
        "pendulum warm", qpm, sa.qp_ws, sa.qp_valid)
    results["ipm_mehrotra"]["pendulum_warm"] = pend_warm_mehr
    car_prep, car_mehr = checks.timing("car cold", qp0_c, None, None)
    results["ipm_prepare"]["car"] = car_prep
    results["ipm_mehrotra"]["car"] = car_mehr
    car_warm_prep, car_warm_mehr = checks.timing(
        "car warm", qp_warm_c, ws_warm_c, wv_warm_c)
    wide_prep, wide_mehr = checks.timing("wide seeded QP, streamed", qp_wide,
                                         None, None)
    results["ipm_mehrotra"].update(car_warm=car_warm_mehr,
                                   wide_streamed=wide_mehr)
    results["ipm_prepare"].update(pendulum_warm=pend_warm_prep,
                                  car_warm=car_warm_prep,
                                  wide_streamed=wide_prep)
    for nU, m_h, m_s, _ in WIDE_SCHUR_QPS:
        prep_t, _ = checks.timing_prepare(
            f"wide Schur seeded QP (nU, m_h, m_s) = {(nU, m_h, m_s)}",
            ipm.seeded_qp(nU, m_h, m_s, 3, dev), None, None)
        results["ipm_prepare"][f"wide_schur_nU{nU}"] = prep_t

    # ---- 11. kernels 5-7 through their own entry point ------------------
    phase("linalg")
    linalg, launches_linalg = linalg_phase(dev)

    # ---- 12. forward-sampling reachability at full width ----------------
    phase("fs")
    fs_phase(dev)

    # ==== the hard-constraint QP family (m_s = 0) =========================
    # ---- 13. params_pendulum at full width ------------------------------
    phase("pend2d")
    pend2d = pendulum2d_phase(dev, checks, results)
    # ---- 14. params_car_residual at full width --------------------------
    phase("car_residual")
    car_res = car_residual_phase(dev, checks)
    # ---- 15. the H = 1 configs ------------------------------------------
    phase("h1")
    h1 = h1_phase(dev, checks)
    prep_errs += [e[0] for e in pend2d["errs"] + car_res["errs"]] + [
        r["err"][0] for r in h1.values()]
    mehr_errs += [e[1] for e in pend2d["errs"] + car_res["errs"]] + [
        r["err"][1] for r in h1.values()]
    results["ipm_prepare"]["max_abs_err"] = max(prep_errs)
    results["ipm_mehrotra"]["max_abs_err"] = max(mehr_errs)
    hard_shapes = (("pendulum_2d", pend2d["timing"]),
                   ("car_residual", car_res["timing"]),
                   ("pendulum_samples", h1["params_pendulum_samples"]["timing"]))
    for key, (cold, warm) in hard_shapes:
        results["ipm_prepare"][f"hard_only_{key}"] = cold[0]
        results["ipm_prepare"][f"hard_only_{key}_warm"] = warm[0]
        results["ipm_mehrotra"][f"hard_only_{key}"] = cold[1]
        results["ipm_mehrotra"][f"hard_only_{key}_warm"] = warm[1]

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
            # the car loop's main path runs all four kernels
            "launches": launches_car[name],
            "launches_pendulum": launches_pend[name],
            "launches_pendulum_2d": pend2d["launches"][name],
            "launches_car_residual": car_res["launches"][name],
            **{f"launches_{c[7:]}": r["launches"][name]
               for c, r in h1.items()},
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
