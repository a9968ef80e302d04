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
the wide QPs (128 < nU <= 256, the IPM kernels' wide builds: the Schur
matrix in 32x32 tiles):
16. wide   — seeded QPs at nU = 129, 200 (m_h=400, m_s=5010), 240
             (hard-only, m_h=840) and 256 (soft and hard-only), cold, and
             warm at 200 and 240: the three IPM checks, the kernels taking
             as many Mehrotra iterations as the plain versions; their
             timing;
17. qp_car_h100 — params_car_samples' committed QP in float32, ill-
             conditioned in the reference itself: the kernels and the plain
             version on the card reach the same status, their best KKT
             residual and objective excess over the float64 optimum within
             10x of each other, beside the plain version on the CPU and
             the 3.45 distance from float64 that the JAX package reads too;
18. car_samples — params_car_samples at full width (ns=10, H=100, four
             SQP iterations; GP Ht=400, R=448; QP nU=200): the golden step's
             solve walked through the kernels (gp_sample, gp_hall at
             nh = 400, 800 and 1200, each against the float64 posterior and
             the plain version), the IPM checks on its cold and warm QPs;
             its one MPC step (DEMPC.run, counters zeroed before and read
             after, every kernel and the wide builds launched) and the same
             step through the plain versions on the card against
             tests/goldens/torch_oracle_car_samples.npz within twice the
             JAX float32 path's own distance from it; the timing of the
             four kernels at its shapes;
19. drone  — params_drone_obstacles_approx (sampling_gpmpc_torch.approx):
             10 pessimistic (QP nU=60, soft build) and 10 optimistic steps
             (nU=240, the wide hard-only build) of
             tests/goldens/torch_oracle_drone.npz, teacher-forced through
             the kernels and through the plain versions, within twice the
             JAX float32 path's envelope and with no more status-4 steps;
             the IPM checks on each planner's first QP; each planner's
             closed loop (ApproxMPC.run, counters zeroed before and read
             after) and its ms per step against dt = 100 ms;
the debug path and the design tools:
20. debug  — params_car at full width, its golden's first 3 steps teacher-
             forced: sqp.solve and sqp.solve_recorded (counters zeroed
             before and read after each) bit-identical in X, U, X_prev,
             U_prev, SQP and QP iterations and status, with the same
             launches of every loop kernel; the recorded solve's posterior
             value moments (float32 on the card) against their float64
             evaluation on the CPU on the same gp state; ms per step of
             both routes;
21. tools  — params_pendulum1D_samples' published settings, float64 on the
             card against the CPU: the Adam fit (100 steps to 1e-8
             relative; the published 300 within ten times the fit's own
             float64 sensitivity; ms per step), the Lipschitz constant and both
             terminal sets (1e-9 relative), the small-ball deviations on
             20,000 injected CPU draws per grid size (1e-10), and
             num_of_samples.run on each device's own 200,000 draws per grid
             size (p_ball within 5 binomial standard deviations; draws per
             second, p_ball and N(delta));
the sample-sharded solve (sampling_gpmpc_torch/parallel/):
22. shard  — float32 on the card, SHARD_BLOCKS blocks of one process (one
             thread and CUDA stream each, ordered sums): params_pendulum1D_
             samples at ns = 64 (the JAX dry run's flagship shape), one RTI
             iteration and three forced ones (hall fill 51), against the
             one-device kernel solve and the float64 CPU solve on the same
             draws (pendulum caps); params_car over 4 blocks of 5 on its
             golden's first 3 teacher-forced steps against the one-device
             solve and the golden (car caps); a 3-step sharded closed loop
             against the one-device loop; forward sampling at 4000 x 50
             over 4 blocks against the one-device rollout on the same draws
             (the fs criteria); the train-axis posterior in float64 (1024
             points, D = 2, with gradients) against the dense Cholesky
             posterior at 1e-8; 4 worker processes
             (sampling_gpmpc_torch.parallel.worker) over gloo sharing the
             card against the blocked solve (and an NCCL group where there
             are two cards or more); per block and step the gp_sample and
             gp_hall launches and the QP routes (the IPM kernels stay off
             under the group, as the JAX gate has it), ms per solve of
             every route;
the evaluation side:
23. gt     — the Monte-Carlo ground truth (sampling_gpmpc_torch.
             simulate_true_reachable_set) of params_pendulum1D_samples'
             step-0 plan: 1000 repeats x 70 realizations x 17 steps in one
             float32 rollout, its sampled steps/s and peak device memory;
             the first 256 realizations against float64 on the same draws
             (the fs bars); the plan's coverage and hull-volume ratio per
             stage, and on the first 100 repeats against float64 on the
             CPU on the same draws;
24. baselines — B5 (linearization_baseline) and B6 (robust_tube_baseline)
             on params_car_residual over 30 steps, float64 on the card
             against the CPU to 1e-9 and float32 within twice the JAX
             package's own float32 envelope; E7 and E10 (examples/) on the
             card against the CPU;
25. band   — the float32 status band (status_band) of params_pendulum1D_
             samples (55 steps), params_pendulum (40) and params_car (50 of
             its 130, as the JAX table) through sqp.solve_recorded: each config's band table, every QP through
             the IPM kernels and every GP stage through gp_sample/gp_hall
             (launches per config, the QP routes);
26. mean   — params_car with mean_as_dyn_sample: its GP stage on the card
             (the reference body, the JAX gate's rule) against float64 on
             the CPU by the tube criterion, and one solve with no GP kernel
             and both IPM kernels launched;
27. xqp    — the generic solve_qp on qp_car_h100.npz's canonical form
             (assemble_canonical) in float64 on the card against the
             float64 optimum, and the kernel route of solve_qp_soft
             against it;
28. traffic — collective_traffic: the blocked route and 4 processes over
             gloo count the same collective rounds and bytes, by reducer
             and scope, with the one-device compute per SQP iteration;
the port's bench (sampling_gpmpc_torch.bench):
29. bench  — its rows at full width with short windows, without the CPU
             baselines: params_pendulum1D_samples at ns = 64 and 512 (H =
             20, one RTI iteration; QP nU = 20, m_h = 7,720 / 61,480, m_s =
             64 / 512), 3 + 20 steps each, params_car 3 + 10, one forward-
             sampling rollout at 4000 x 50; QP status 0 and finite states at
             every step (the rows raise otherwise), 1 gp_sample, 1 glue,
             1 prepare and 1 Mehrotra launch a step at both widths, the car's
             launches by its SQP iterations, the idle share of 5 traced
             steps, its kernel-against-plain checks at the bars of phases
             4 and 6; its JSON line as a [bench] line; the ns = 512 chain of
             tests/goldens/torch_oracle_bench_ns512.npz teacher-forced
             through the kernels and the plain versions within twice the
             JAX float32 path's distance from it; the three IPM checks and
             the timing of kernels 1-3 at ns = 64 (resident) and 512 (the
             streamed branches), cold and warm;
the condensing and assembly kernel (csrc/glue.cu):
30. glue   — the kernel against its plain version (ops/glue.py) on every
             output (the QP tuple, T, Gamma; GLUE_RTOL of each output's
             largest entry, the 1e8 bounds exactly) at the published shapes
             of every config that reaches sqp._assemble on the card, in the
             branch the shape picks and, where it fits, the other one, two
             launches bit for bit; one launch per SQP iteration in 5
             params_pendulum1D_samples steps and a params_car solve, and a
             Gram launch per iteration in a params_car_residual solve only;
             at every shape the device time of both branches beside the
             bound (bytes) and the plain version's; the wrapper's host time
             a call;
the step's consumption (csrc/glue.cu, glue_advance_kernel):
31. advance — the kernel against the torch chain it replaces (ocp/sqp.py::
             consume_step on the candidate) at the same shapes, a solve's
             first step and a stalled one: counters, alpha, done, qp_valid
             and qp_iters equal, X and U within two dot products' float32
             bound (gamma_nU) of their terms' magnitude, the norms within
             ADVANCE_NORM_RTOL, two launches bit for
             bit; one launch per SQP iteration in phase 30's solves and none
             under plain_route(glue=True); at every shape its device time
             beside the bound (bytes), sqp._advance's on the kernel route
             and the torch chain's; the wrapper's host time a call;
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
# The IPM kernels' wide builds (128 < nU <= 256).  Seeded QPs (nU, m_h,
# m_s) of the kernels' family, well conditioned: the narrowest wide QP,
# params_car_samples' row counts, the drone's optimistic planner's
# (hard-only), the widest soft and hard-only; those in WIDE_WARM also
# warm started (a plain solve carried to g moved by 1e-3).
WIDE_BUILD_QPS = ((129, 600, 300), (200, 400, 5010), (240, 840, 0),
                  (256, 1000, 400), (256, 1000, 0))
WIDE_WARM = ((200, 400, 5010), (240, 840, 0))
# Warm, the loop kernel alone on its prepared problem may stop one
# Mehrotra iteration apart from the plain loop: at (240, 840, 0) an H100
# read 5 against 6, the kernel's best KKT residual (2.27e-5) under the
# 3e-5 exit where the plain loop's was not, float32 rounding in another
# summation order (the whole solves took 5 and 5).
WIDE_WARM_ITERS_SLACK = 1
# params_car_samples' committed QP (tests/goldens/qp_car_h100.npz: nU=200,
# m_h=400, m_s=5010) in float32.  It is ill-conditioned in the reference
# itself: the JAX package's float32 solve and the port's plain float32
# solve both end with status 0 after 18 iterations 3.45 from the float64
# solution (on the CPU: JAX 3.4506, the port 3.4507; its objective 2.0e-4
# above the float64 optimum), so the kernel is held to the plain version
# on the card: the same status, its best KKT residual and its objective's
# excess over the float64 optimum each within QP_CAR_FACTOR of the plain
# version's.  A wrong factor or step is orders of magnitude off both.
QP_CAR_GOLDEN = os.path.join(HERE, "tests", "goldens", "qp_car_h100.npz")
QP_CAR_FACTOR = 10.0
# params_car_samples (H = 100, ns = 10, four SQP iterations; GP Ht = 400,
# R = 448, hall fills 400 / 800 / 1200; QP nU = 200): its one MPC step on
# the draws of tests/goldens/torch_oracle_car_samples.npz (written by
# tests/make_torch_car_samples_golden.py).  The plan is held to
# ENV_FACTOR times the JAX float32 path's own distance from the float64
# plan, read from the golden.
CAR_SAMPLES_CONFIG = "params_car_samples"
CAR_SAMPLES_GOLDEN = os.path.join(HERE, "tests", "goldens",
                                  "torch_oracle_car_samples.npz")
ENV_FACTOR = 2.0
# The approximate drone MPC (params_drone_obstacles_approx): teacher-forced
# pessimistic (QP nU = 60, m_h = 482, m_s = 124: the soft build) and
# optimistic (nU = 240, m_h = 840, m_s = 0: the wide hard-only build) steps
# of tests/goldens/torch_oracle_drone.npz (tests/make_torch_drone_golden.py)
# held to ENV_FACTOR times the JAX float32 path's envelope in the golden.
# Phase debug: the recorded SQP solve (sqp.solve_recorded) against sqp.solve
# on params_car's first DEBUG_STEPS golden steps.  Its posterior value
# moments (plain torch, float32 on the card) are held to their float64
# evaluation on the same gp state on the CPU, as a share of the tube width
# beta (sigma + sigma_n) of that stage: DEBUG_MOMENT_TOL at iteration 0
# (the empty buffer: 2.1e-4 measured on the CPU in float32, the JAX
# package's own float32 evaluation 2.0e-4, 1.9e-4 on an H100),
# DEBUG_HALL_MOMENT_TOL at iterations >= 1, where the hall rows'
# conditioning leaves float32 1.04e-3 of the tube from float64 in the JAX
# package's own evaluation, 1.7e-3 in the port's on the CPU and 1.214e-3
# on an H100 (steps 0-2, the same states): about 2.4 times the largest of
# those floors.  A probe that returned the prior reads O(1).
DEBUG_STEPS = 3
DEBUG_MOMENT_TOL, DEBUG_HALL_MOMENT_TOL = 1e-3, 4e-3
# Phase tools at params_pendulum1D_samples' settings, float64 on the card
# against the CPU: the Adam fit to TOOLS_FIT_RTOL after 100 steps (read
# 1.99e-12 on an H100).  After the published 300 steps the fit is that
# sensitive no more: its task noise runs down to the 1e-10 jitter, where
# the NLL is flat (inputs moved by 1e-15 relative move the CPU fit 1e-13
# after 50 steps, 1e-12 after 100, 1e-9 after 200 and 7.7e-8 after 300;
# the JAX package's fit differs from the port's on the CPU by 9.9e-8, the
# card's from the CPU's by 1.34e-7 on an H100), so there it is held to
# TOOLS_FIT_LONG_RTOL, about seven times the largest of those.  The Lipschitz
# constant and the terminal sets to 1e-9 relative, the small-ball
# deviations on injected draws to 1e-10, and p_ball on each device's own
# 200,000 draws within 5 binomial standard deviations.
TOOLS_CONFIG = "params_pendulum1D_samples"
TOOLS_FIT_SHORT, TOOLS_FIT_ITERS = 100, 300
TOOLS_FIT_RTOL, TOOLS_FIT_LONG_RTOL = 1e-8, 1e-6
TOOLS_RTOL, TOOLS_DEV_TOL = 1e-9, 1e-10
TOOLS_INJECTED, TOOLS_N_MC, TOOLS_SIGMAS = 20_000, 200_000, 5.0
# Phase shard, the sample-sharded solve on one card.  The flagship shape of
# the JAX package's multichip dry run (__graft_entry__.py:158): the 1D
# pendulum at ns = 64 over 4 blocks of 16, one RTI iteration and three
# forced SQP iterations (hall fill 3 H = 51); params_car over 4 blocks of 5
# on its golden's first SHARD_CAR_STEPS teacher-forced steps; a
# SHARD_LOOP_STEPS-step closed loop; forward sampling over 4 blocks; the
# train-axis posterior in float64 (1024 points, D = 2, with gradients:
# 3072 rows; CG capped at the row count, CG's exact-arithmetic bound) at
# the JAX test's 1e-8; and SHARD_PROCS worker processes over gloo.  Bars:
# the loops' float32 caps (TF_TOL_X/_U, TF_CAR_TOL_X/_U) and the fs
# criteria.
SHARD_NS, SHARD_BLOCKS, SHARD_ITERS = 64, 4, 3
SHARD_CAR_STEPS, SHARD_LOOP_STEPS = 3, 3
SHARD_POST_PTS, SHARD_POST_D, SHARD_POST_M, SHARD_POST_TOL = 1024, 2, 5, 1e-8
SHARD_PROCS, SHARD_REPEATS, SHARD_PROC_TIMEOUT = 4, 2, 300
DRONE_CONFIG = os.path.join(HERE, "params",
                            "params_drone_obstacles_approx.yaml")
DRONE_GOLDEN = os.path.join(HERE, "tests", "goldens", "torch_oracle_drone.npz")
# The evaluation side (phases gt, baselines, band, mean, xqp, traffic).
# Phase gt: the Monte-Carlo ground truth (B1) of params_pendulum1D_samples'
# step-0 plan (tests/goldens/oracle_pendulum1d_flagship.npz: plan_U_traj[0]
# from physical_state_traj[0]), GT_REPEATS repeats of its ns = 70
# realizations over H = 17 steps in one rollout, float32, on chunk 0's
# draws.  Its first GT_F64_NS realizations are held against float64 on the
# card on the same draws by the forward-sampling bars (FS_REAL_TOL,
# FS_ENV_TOL, at most one non-finite realization in 4000).  The plan's
# coverage of the truth and its hull-volume ratio are printed per stage,
# and on the first GT_CPU_REPEATS repeats held against float64 on the CPU
# on the same draws: on the stages whose truth hull has a volume, coverage
# within GT_COV_TOL and the volume ratio within GT_VOL_RTOL relative.  The
# CPU's float32 against its float64 reads 0 and 6.0e-4 there
# (tests/test_torch_reach_gt.py::test_f32_coverage_bar, 7000 truth points
# a stage), so the bars are 35 of 7000 points and about 17 times the
# ratio's reading.  A degenerate truth (stage 1: the shared start moves
# deterministically) scores by the bounding interval, whose 1e-9 pad lies
# below float32's resolution: it reads 0 in float32 against 1 in float64,
# and is printed, not held.
GT_CONFIG = "params_pendulum1D_samples"
GT_REPEATS, GT_F64_NS, GT_CPU_REPEATS = 1000, 256, 100
GT_COV_TOL, GT_VOL_RTOL = 0.005, 0.01
# Phase baselines: B5 and B6 on params_car_residual over BASE_STEPS steps
# of the golden plan's inputs (tests/goldens/params_car_residual.npz),
# float32 and float64 on the card against float64 on the CPU.  In float64
# the card holds to BASE_F64_RTOL relative, and the tube's shapes (up to
# the freeze) to BASE_TUBE_RTOL: the recursion grows them by 1e3-1e5 a
# step, so the shapes of the CPU's own float64 tube move 3.38e-8 relative
# when the start moves by 1e-15 relative (tests/test_torch_baselines.py::
# test_tube_float64_floor); the bar is about ten times that floor.  Float32 is the reference's own
# weak point: the JAX package's float32 path leaves its float64 path by
# 6.12e-2 (B5 means), 1.31e-1 (B5 covariances), 8.61e-2 (l_mu), 1.79e-1
# (l_sigma) and 1.68e-1 (tube centers), relative to each quantity's
# largest magnitude, and its tube overflows float32 and freezes at step 7
# where float64's freezes at step 10 (tests/test_torch_baselines.py::
# test_f32_envelope_vs_jax, on the CPU).  The card's float32 is held to
# ENV_FACTOR times those readings; its tube's shapes only to be finite
# and frozen.  E7 and E10 run on the card in float64: E7's draws at the
# points to 1e-10 and on the grid to E7_GRID_TOL against the CPU's (the
# grid draws' own float64 floor is 4.9e-9, tests/test_torch_examples.py),
# E10's two assertions and its gain to 1e-10 relative.
BASE_CONFIG, BASE_STEPS, BASE_F64_RTOL = "params_car_residual", 30, 1e-9
BASE_TUBE_RTOL = 3e-7
BASE_JAX_F32 = {"means": 6.12e-2, "covs": 1.31e-1, "l_mu": 8.61e-2,
                "l_sig": 1.79e-1, "centers": 1.68e-1}
E7_GRID_TOL = 5e-8
# Phase mean: params_car (ns = 20) with mean_as_dyn_sample, golden step
# CAR_STEP's iterate and draws: the GP stage on the card (the reference
# body, float32) against the same stage in float64 on the CPU, SQP
# iteration 0 and iteration 1 (the card's hall rows): the mean sample
# within DEBUG_MOMENT_TOL / DEBUG_HALL_MOMENT_TOL of the tube width from
# the float64 posterior mean (the CPU's float32 reads 4.4e-5 and 6.7e-5),
# no draw outside the tube, and every draw within MEAN_REL_TOL of the tube
# width from its float64 evaluation: the float32 draws pass through the
# Cholesky factor of the float32 posterior covariance, which leaves them
# 0.280 and 0.303 of the tube from float64 on the CPU (tests/
# test_torch_mean_route.py::test_f32_mean_route_bar; phase pend2d reads
# 0.35-0.59 for its own stages), so the bar is one tube width, whose
# sigma_n covers that floor.  Then one solve with the counters zeroed: no
# GP kernel, both IPM kernels.
MEAN_REL_TOL = 1.0
# Phase xqp: the generic solve_qp (ocp/qp.py, plain torch) on the card on
# tests/goldens/qp_car_h100.npz's canonical form (assemble_canonical:
# nz = 10220, 20440 rows), float64, XQP_ITERS iterations: its objective
# within XQP_OBJ_RTOL of the stored float64 optimum's, no hard row
# violated.  Its status is printed, not held: the generic IPM (the JAX
# package's algorithm, which returns its last iterate and has no
# best-iterate tracking) reaches the optimum's objective on this 1e6-penalty
# QP but its KKT measure wanders above the 1e-8 exit (the JAX package's own
# solve_qp reads status 4 after 150 iterations on the golden's first 300
# and 1200 soft rows, 2.4e-10 from the port's, on the CPU).  On all 5010
# rows this phase read on an H100, with XQP_ITERS at 70, 100 and 150, an
# objective 3.4e-2 above the stored optimum's (not yet there, status 4),
# 1.9e-7 below it (status 0) and 1.9e-7 below it (status 4): XQP_ITERS is
# 100, about 15 s.  Against it, the kernel route of solve_qp_soft
# (float32): its objective excess within XQP_KERNEL_EXCESS, ten times the
# 2.0e-4 that the JAX package's float32 solve and the plain version read
# (phase qp_car_h100).
XQP_ITERS, XQP_OBJ_RTOL, XQP_KERNEL_EXCESS = 100, 1e-6, 2e-3
# Phase band: the status band's closed loops, each its config's whole loop
# but params_car's, cut to the 50 steps of the JAX package's own table
# (BENCH_NOTES.md, "f32 status-0 acceptance band").
BAND_STEPS = {"params_car": 50}
# Phase traffic: collective_traffic's table on the card: the blocked route
# (SHARD_BLOCKS blocks) and SHARD_PROCS processes over gloo at ns =
# SHARD_NS, 3 forced SQP iterations, counting the same rounds and bytes.
# Phase bench: the port's bench (sampling_gpmpc_torch.bench) at full width
# with short windows (BENCH_SIZES: ns = 64 and ns = 512 3 + 20 steps, the
# car 3 + 10, one forward-sampling rollout) and no CPU baseline; its rows
# raise on a QP status other than 0 or a non-finite state.  Its three
# kernel-against-plain checks are held to the bars above: the GP and IPM
# swaps of the ns = 64 solve to TF_KP_TOL_X/_U, the hall stage to
# GP_HALL_REL_TOL of the tube with no excursion past it.  Then the ns = 512
# chain of tests/goldens/torch_oracle_bench_ns512.npz (written by
# tests/make_torch_bench_golden.py: JAX float64 on the CPU), teacher-forced
# through the kernels and through the plain versions, each within
# ENV_FACTOR times the JAX float32 path's own teacher-forced distance from
# it, stored in the golden (0.0345 in X, 0.813 in U over its 10 steps), and
# against each other within the same bar.
BENCH_SIZES = dict(loop=(3, 20), loop_large=(3, 20), car=(3, 10),
                   fs_runs=(0, 1))
BENCH_GOLDEN = os.path.join(HERE, "tests", "goldens",
                            "torch_oracle_bench_ns512.npz")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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


def not_launched(launches) -> bool:
    """Whether a loop kernel every SQP iteration takes was not launched
    (the glue's Gram launch, ``glue_gram``, runs past ops/glue.py's
    GRAM_NU only; ``gp_hall_global`` counts the hall launches whose factor
    keeps its tiles in global memory and ``gp_hall_panels`` their panel
    steps, none at the car's fills)."""
    return min(v for k, v in launches.items()
               if k not in ("glue_gram", "gp_hall_global",
                            "gp_hall_panels")) <= 0


def bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


HALL_BLOCK_ARGS = ("real_Z", "m_r", "hall_Z", "hall_Y", "Xt", "eps",
                   "lengthscale", "outputscale", "noise_diag")
HALL_BLOCKS_REL_TOL = 1e-5     # expf's and the sum's rounding, of a block's max


def hall_blocks_report(label, pts):
    """hall_blocks_kernel's blocks from the points ``pts`` (the arguments
    of gp_hall.sample_hall_points) against their plain version on the same
    float32 points: each block within HALL_BLOCKS_REL_TOL of its largest
    entry, the eps rows, prior_var and yh exactly.  Returns the kernel's
    blocks."""
    import torch
    from sampling_gpmpc_torch.ops import gp_hall
    args = [pts[k] for k in HALL_BLOCK_ARGS]
    kb = gp_hall.hall_blocks(pts["nh"], *args, ty=pts["ty"])
    ref = gp_hall.hall_blocks_plain(pts["nh"], *args, pts["ty"])
    worst = 0.0
    for k, v in ref.items():
        if k in ("eps", "prior_var", "yh"):
            if not torch.equal(kb[k], v):
                fail(f"gp_hall {label}: hall_blocks_kernel's {k} differs")
        elif v.numel():
            worst = max(worst, float((kb[k] - v).abs().max() / v.abs().max()))
    print(f"[gp_hall] {label}, nh={pts['nh']}: hall_blocks_kernel against "
          f"its plain version: {worst:.3e} of a block's largest entry (tol "
          f"{HALL_BLOCKS_REL_TOL})", flush=True)
    if worst > HALL_BLOCKS_REL_TOL:
        fail(f"gp_hall {label}: hall_blocks_kernel disagrees with its plain "
             "version")
    return kb


def hall_blocks_bytes(pts):
    """Bytes of one hall_blocks_kernel launch: the points, masks and draws
    it reads, once each, and the blocks it writes."""
    from sampling_gpmpc_torch.ops import gp_hall
    no, Rr = pts["m_r"].shape
    ns, H, D = pts["Xt"].shape
    ty, nh = pts["ty"], pts["nh"]
    hn = nh // ty
    read = (pts["real_Z"].numel() + no * Rr + ns * no * hn * (D + ty)
            + ns * H * D + pts["eps"].numel() + no * D + no + ty)
    return 4 * (read + gp_hall.blocks_floats(no, ns, H * ty, Rr, nh))


def gp_sample_bound(ns, Ht, R):
    """Bytes and float32 operations of one gp_sample launch."""
    nbytes = 4 * (ns * Ht * R + ns * Ht * Ht + ns * Ht + R * R + R + Ht
                  + ns * Ht)
    flops = ns * (2 * R * R * Ht + 2 * R * Ht + R * Ht * (Ht + 1)
                  + Ht ** 3 / 3 + Ht * Ht)
    return nbytes, flops


# the hall stage's kernels (csrc/gp_hall.cu): the blocks, the products, the
# shared-memory factor, and the global-tile factor's fill, panel steps,
# trailing updates and finish
HALL_KERNELS = ("hall_blocks_kernel", "hall_gemm_kernel",
                "gp_hall_factor_kernel", "gp_hall_fill_kernel",
                "gp_hall_panel_kernel", "gp_hall_update_kernel",
                "gp_hall_finish_kernel")


def hall_kernel_ms(fn, n=3) -> dict:
    """Device ms per fn() call of each hall-stage kernel that fn launches,
    summed over its launches, under torch.profiler over n warm calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0.0))
        for name in HALL_KERNELS:
            if us and (name + "(" in e.key or name + "<" in e.key):
                out[name] = out.get(name, 0.0) + us / n / 1e3
    return {k: round(v, 4) for k, v in out.items()}


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


def time_gp_sample(label, st):
    """gp_sample's every-output call (the main path's) on stacked inputs,
    beside its plain version, its bound and torch.linalg.cholesky of the
    covariance batch (a partial yardstick)."""
    import torch
    from sampling_gpmpc_torch.microbench_linalg import cuda_ms
    from sampling_gpmpc_torch.ops import gp_sample
    no, ns, Ht, R = st["Kxm"].shape
    t_k = cuda_ms(lambda: gp_sample.sample_empty(**st))
    t_p = cuda_ms(lambda: gp_sample.sample_empty_plain_stacked(**st),
                  n=5, warm=1, k=1)
    cov_batch = (st["Ktt"].reshape(no * ns, Ht, Ht)
                 + 1e-3 * torch.eye(Ht, device=st["Ktt"].device)).contiguous()
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
                                      "yh", "Linv", "w_r", "prior_var")},
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
               per_output, ref64=False, empty_rel_tol=None):
    """One teacher-forced solve walked SQP iteration by SQP iteration
    through the kernels.  Each iteration's GP stage is checked on the
    inputs the solve gives it (iteration 0 on the empty buffer, iteration
    k >= 1 at fill k H Ty) against the float64 posterior (tube, 0
    violations) and pointwise against the plain version: every output in
    one launch (set), the main path's call; with ``per_output`` also each
    output alone, and the empty buffer through the hall stage at iteration
    1; with ``ref64`` (the 2D pendulum: GP_PEND2D_REL_TOL on its empty
    stage) the plain version is also evaluated in float64 on the same
    inputs (gp_report's ``d64``); ``empty_rel_tol`` overrides the empty
    stage's bar.  Then the iteration runs and feeds the next.  Returns the stage
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
    out = dict(one=None, empty=None, hall={}, points={}, warm=None,
               gs_errs=[],
               gh_errs=[], gh_rels=[])

    def stacked_report(label, st_in, dps, d0s, tubes, means, d64s=None,
                       dk=None, how="one launch set"):
        """All outputs in one launch set (from the blocks ``st_in``, or
        ``dk`` drawn otherwise) against the plain version of each
        output."""
        if dk is None:
            dk = gp_hall.sample_hall(**st_in)
        for j in range(spec.g_ny):
            err, rel = gp_report(
                "gp_hall", spec, f"{label}, nh={st_in['nh']}, all "
                f"{spec.g_ny} outputs in {how}: output {j}", dk[j],
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
                    m64[:, j], empty_rel_tol or (
                        GP_PEND2D_REL_TOL if ref64 else GP_REL_TOL),
                    d0=d0s[j] if ref64 else None,
                    d64=d64s[j] if ref64 else None)
                out["gs_errs"].append(err)
            out["empty"] = st_in
        else:
            st_in = agent.hall_stage_inputs_all(spec, hyp, gp_it, Xt, eps_it)
            stacked_report(f"{tag} SQP iteration {it}", st_in, dps, d0s,
                           tubes, [m64[:, j] for j in range(spec.g_ny)],
                           d64s)
            # the main path's call: the blocks from the points on the card.
            # Its blocks against their plain version (HALL_BLOCKS_REL_TOL),
            # then its draws against the plain factor on the blocks the
            # kernel wrote: an ulp in a block moves the car's float32 draws
            # by up to ~0.4 of the tube width (cancellation), so the
            # pointwise bar holds the factor on equal blocks
            pts = agent.hall_point_inputs(spec, hyp, gp_it, Xt, eps_it)
            kb = hall_blocks_report(f"{tag} SQP iteration {it}", pts)
            on_kb = dict(kb, Linv=pts["Linv"], w_r=pts["w_r"],
                         **{k: pts[k] for k in ("nh", "jitter", "beta",
                                                "var_zero", "rel_floor",
                                                "ty")})
            stacked_report(
                f"{tag} SQP iteration {it}", st_in,
                gp_hall.sample_hall_plain_stacked(**on_kb),
                gp_hall.sample_hall_plain_stacked(
                    **dict(on_kb, eps=torch.zeros_like(kb["eps"]))), tubes,
                [m64[:, j] for j in range(spec.g_ny)],
                dk=gp_hall.sample_hall_points(**pts),
                how="one call from the points (plain: on its blocks)")
            out["hall"][st_in["nh"]] = st_in
            out["points"][st_in["nh"]] = pts
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


def build_name(m_s, nU):
    """The IPM kernels' build a QP runs (csrc/ipm.cu's SOFT and WIDE
    arguments) and its library."""
    from sampling_gpmpc_torch.ops import ipm
    return (("soft build" if m_s else "hard-only build SOFT=false")
            + (", wide (IPM_WIDE=1)" if nU > ipm.NU_NARROW else "")
            + f", library {ipm._library(m_s, nU)}")


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

    def report(self, label, qp_args, ws, wv, resident=True, status=0,
               prep_resident=None, iters_slack=None):
        """The three checks; ``status`` 4 for a QP that no solver can meet
        (params_pendulum1D_invariant's infeasible rows 0 <= -2.4): then the
        kernel and the plain version end with that status after the same
        iterations, at the same iterate (1e-3 of its scale), and the
        float64 solve is not a bound.  ``prep_resident``: the prepare
        kernel's branch where it differs from the loop kernel's (a wide
        QP's loop kernel always streams); ``iters_slack``: the kernels take
        as many Mehrotra iterations as the plain versions, the loop kernel
        alone on the prepared problem up to ``iters_slack`` more or fewer
        (the wide seeded QPs)."""
        import torch
        f64 = torch.float64
        nU, m_h, m_s = (qp_args[1].shape[0], qp_args[3].shape[0],
                        qp_args[5].shape[0])
        lay = self.ipm.loop_layout(nU, m_h, m_s)
        play = self.ipm.prepare_layout(nU, m_h, m_s)
        n_cl = self.ipm.cluster_size(m_s, nU)
        build = build_name(m_s, nU)
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
        # at the QPs checked here both kernels take the same branch, but
        # for the wide QPs whose prepare slices fit shared memory
        prep_resident = resident if prep_resident is None else prep_resident
        if lay.resident != resident or play.resident != prep_resident:
            fail(f"IPM {label}: expected the "
                 f"{'resident' if resident else 'streamed'} branch")
        if lay.group:
            t = -(-nU // 32)
            print(f"[ipm] {label}: wide build, the Schur matrix in "
                  f"{t * (t + 1) // 2} lower 32x32 tiles formed {lay.group} "
                  f"at a time, G staged {lay.chunk} rows a step", flush=True)
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
                (status or iters_slack is not None)
                and int(k.iters) != int(p.iters)):
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
        slack = 0 if status else iters_slack
        if du_m > bound or met != ((status == 0),) * 2 or (
                slack is not None and abs(int(ik) - int(ip)) > slack):
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
              f"; {build_name(m_s, nU)}, {branch} branch, cluster of "
              f"{ipm.cluster_size(m_s, nU)} CTAs, "
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
            "Kxr", "Kxh", "Ktt", "Arh", "Ahh", "yh", "Linv", "w_r",
            "prior_var")), jitter=st["jitter"])[1:]
        for j in range(st["Kxr"].shape[0])]
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
    if not_launched(launches):
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


def wide_phase(dev, checks):
    """The IPM kernels' wide builds on WIDE_BUILD_QPS: the three IPM checks
    cold (and warm for WIDE_WARM), the kernels taking as many Mehrotra
    iterations as the plain versions, and their timing."""
    import torch
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    from sampling_gpmpc_torch.ops import ipm
    errs, timing = [], {}
    valid = torch.ones((), dtype=torch.bool, device=dev)
    kw = (checks.tol, checks.reg, 150, *checks.consts, qp_mod.WS_BAND)
    for shape in WIDE_BUILD_QPS:
        nU, m_h, m_s = shape
        qp = ipm.seeded_qp(*shape, 3, dev)
        prep_res = ipm.prepare_layout(*shape).resident
        errs.append(checks.report(f"wide build, seeded QP {shape} cold", qp,
                                  None, None, resident=False,
                                  prep_resident=prep_res, iters_slack=0))
        timing[f"nU{nU}_{m_h}_{m_s}"] = checks.timing(
            f"wide build {shape} cold", qp, None, None)
        if shape in WIDE_WARM:
            sol = qp_mod._finish(*ipm.run_full_plain(*qp, None, None, *kw),
                                 checks.tol)
            moved = list(qp)
            moved[1] = qp[1] + 1e-3
            errs.append(checks.report(
                f"wide build, seeded QP {shape} warm", moved, sol.state,
                valid, resident=False, prep_resident=prep_res,
                iters_slack=WIDE_WARM_ITERS_SLACK))
            timing[f"nU{nU}_{m_h}_{m_s}_warm"] = checks.timing(
                f"wide build {shape} warm", moved, sol.state, valid)
    return dict(errs=errs, timing=timing)


def qp_objective(qp, u):
    """The soft QP's objective at u in float64, with each soft row's slacks
    at their optimum for u (max(0, lo - G_s u), max(0, G_s u - hi)), and
    its largest hard-row violation."""
    import torch
    H, g, Gh, dh, Gs, lo, hi, zl, zu, Zl, Zu = (a.double() for a in qp)
    u = u.double()
    gs = Gs @ u
    sl = torch.clamp(lo - gs, min=0.0)
    su = torch.clamp(gs - hi, min=0.0)
    f = (0.5 * u @ H @ u + g @ u
         + (zl * sl + 0.5 * Zl * sl * sl + zu * su + 0.5 * Zu * su * su).sum())
    return float(f), float(torch.clamp(Gh @ u - dh, min=0.0).max())


def qp_car_phase(dev, checks):
    """tests/goldens/qp_car_h100.npz in float32 (QP_CAR_FACTOR): the kernels
    and the plain version on the card, beside the plain version on the CPU
    and the float64 solution u_ref."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    from sampling_gpmpc_torch.ops import ipm
    g = np.load(QP_CAR_GOLDEN)
    names = ("H", "g", "Gh", "dh", "Gs", "lo", "hi", "zl", "zu", "Zl", "Zu")
    qp = tuple(torch.as_tensor(g[k], dtype=torch.float32, device=dev)
               for k in names)
    qp_cpu = tuple(a.cpu() for a in qp)
    u_ref = torch.as_tensor(g["u_ref"], dtype=torch.float64)
    f_ref, _ = qp_objective(qp_cpu, u_ref)
    kw = (checks.tol, checks.reg, 150, *checks.consts, qp_mod.WS_BAND)
    rel_prep, _ = checks.prepare_report("qp_car_h100", qp, None, None)
    sols = {"kernel": qp_mod._finish(*ipm.run_full(*qp, None, None, *kw),
                                     checks.tol),
            "plain on the card": qp_mod._finish(
                *ipm.run_full_plain(*qp, None, None, *kw), checks.tol),
            "plain on the CPU": qp_mod._finish(
                *ipm.run_full_plain(*qp_cpu, None, None, *kw), checks.tol)}
    read = {}
    for name, sol in sols.items():
        u = sol.z.cpu().double()
        f, viol = qp_objective(qp_cpu, u)
        read[name] = dict(status=int(sol.status), iters=int(sol.iters),
                          kkt=float(sol.gap),
                          dist_f64=float(torch.max(torch.abs(u - u_ref))),
                          excess=(f - f_ref) / abs(f_ref), hard_viol=viol)
        print(f"[qp_car_h100] {name}: status {read[name]['status']}, "
              f"{read[name]['iters']} iterations, best KKT "
              f"{read[name]['kkt']:.4e}, |u - u_f64|inf "
              f"{read[name]['dist_f64']:.4f} (the JAX float32 path on the "
              f"CPU: 3.4506), objective {read[name]['excess']:.4e} above "
              f"the float64 optimum (relative), hard rows violated by "
              f"{viol:.3e}", flush=True)
    k, p = read["kernel"], read["plain on the card"]
    spread = abs(p["dist_f64"] - read["plain on the CPU"]["dist_f64"])
    print(f"[qp_car_h100] the plain version's own float32 spread between the "
          f"CPU and the card: {spread:.4e} in |u - u_f64|; bars: the same "
          f"status, best KKT and objective excess within {QP_CAR_FACTOR}x "
          f"the plain version's on the card", flush=True)
    if k["status"] != p["status"] or \
            k["kkt"] > QP_CAR_FACTOR * p["kkt"] or \
            k["excess"] > QP_CAR_FACTOR * max(p["excess"], 1e-7):
        fail("qp_car_h100: the kernels' float32 solve against the plain "
             "version's")
    return dict(read=read, rel_prep=rel_prep)


def plan_err(X, U, gX, gU):
    import numpy as np
    X = X.cpu().numpy() if hasattr(X, "cpu") else np.asarray(X)
    U = U.cpu().numpy() if hasattr(U, "cpu") else np.asarray(U)
    return float(np.abs(X - gX).max()), float(np.abs(U - gU).max())


def car_samples_phase(dev, checks):
    """params_car_samples at full width (ns=10, H=100, four SQP iterations,
    three outputs; QP nU=200, m_h=400, m_s=5010): the golden step's solve
    walked stage by stage (gp_sample, gp_hall at nh = 400, 800, 1200, each
    against the float64 posterior and its plain version), the IPM checks
    on its cold and warm QPs; the one MPC step (DEMPC.run, the counts zeroed
    before and read after) and the same step through the plain versions on
    the card, each plan against the float64 golden; the kernels' timing at
    its shapes."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.microbench_linalg import cuda_ms
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    from sampling_gpmpc_torch.ops import gp_hall
    f32, f64 = torch.float32, torch.float64
    T = lambda a: torch.as_tensor(a, dtype=f32, device=dev)
    g = np.load(CAR_SAMPLES_GOLDEN)
    params, spec, data = load_problem(
        os.path.join(HERE, "params", CAR_SAMPLES_CONFIG + ".yaml"))
    if (spec.ns, spec.H, spec.max_sqp_iter, spec.num_mpc_iter) != (
            int(g["ns"]), int(g["H"]), int(g["max_sqp_iter"]), 1):
        fail("the car_samples golden does not match the config")
    env = make_env(spec, params)
    ocp = make_ocp_data(spec, data, dev, f32)
    hyp = GPHyperArrays.from_spec(spec.gp, dev, f32)
    hyp64 = GPHyperArrays.from_spec(spec.gp, dev, f64)
    gp = agent.init_gp_state(spec, env, dev, f32, hyp=hyp)
    gp64 = agent.init_gp_state(spec, env, dev, f64, hyp=hyp64)
    eps = T(g["eps"])[0]
    st, X0, U0 = T(g["x0"]), T(g["X0"]), T(g["U0"])
    k = spec.max_sqp_iter
    gX, gU = g[f"plan_X_{k}"], g[f"plan_U_{k}"]
    env_x, env_u = plan_err(g[f"f32_plan_X_{k}"], g[f"f32_plan_U_{k}"], gX,
                            gU)
    tol_x, tol_u = ENV_FACTOR * env_x, ENV_FACTOR * env_u

    walk = stage_walk("car_samples", spec, env, hyp, hyp64, ocp, gp, gp64,
                      st, X0, U0, eps, per_output=False, ref64=True,
                      empty_rel_tol=GP_REL_TOL)
    qp0, _, _, _ = sqp.assemble_qp(spec, env, hyp, ocp, st, X0, U0,
                                   agent.reset_hall(gp), eps[0],
                                   hall_empty=True)
    qpw, wsw, wvw = walk["warm"]
    errs = [checks.report("car_samples cold, SQP iteration 0", qp0, None,
                          None, resident=False),
            checks.report("car_samples warm, SQP iteration 2", qpw, wsw, wvw,
                          resident=False)]

    qps = []
    with captured_qps(qps):
        out, launches, _ = free_run("car_samples", params, spec, data, env,
                                    dev, epistemic=g["eps"])
    wide = wide_launch_counts()
    dx, du = plan_err(out["state_traj"][-1], out["input_traj"][-1], gX, gU)
    with plain_route():
        sp = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    px, pu = plan_err(sp.X, sp.U, gX, gU)
    kx, ku = plan_err(out["state_traj"][-1], out["input_traj"][-1],
                      sp.X.cpu().numpy(), sp.U.cpu().numpy())
    _, _, step_ms = free_run("car_samples", params, spec, data, env, dev,
                             epistemic=g["eps"])
    print(f"[car_samples] one MPC step, {out['sqp_its']} SQP iterations, "
          f"status {out['sqp_status_traj']}, {len(qps)} QPs: plan vs the "
          f"float64 golden max|dX| {dx:.4e} (tol {tol_x:.4f}), max|dU| "
          f"{du:.4e} (tol {tol_u:.4f}; the JAX float32 path reads "
          f"{env_x:.4e} / {env_u:.4e}); the plain versions on the card "
          f"{px:.4e} / {pu:.4e}; kernels vs plain {kx:.4e} / {ku:.4e}; "
          f"{step_ms[0]:.1f} ms (a second run, warm); launches {launches}, "
          f"of them in the wide builds {wide}", flush=True)
    if out["sqp_status_traj"] != [0] or dx > tol_x or du > tol_u \
            or kx > tol_x or ku > tol_u:
        fail("params_car_samples plan")
    Ht = spec.H * spec.Ty
    panels = sum(gp_hall.hall_panels(Ht, nh) for nh in walk["hall"])
    print(f"[car_samples] hall factor: {launches['gp_hall_global']} launch "
          f"sets on the global-tile branch, {launches['gp_hall_panels']} "
          f"panel steps of {32 * gp_hall.GLOBAL_PANEL_TILES} columns "
          f"(from the shapes: {panels} at fills {sorted(walk['hall'])})",
          flush=True)
    if min(launches.values()) <= 0 or min(wide.values()) <= 0 or \
            wide["ipm_mehrotra"] != len(qps) or \
            launches["gp_hall_global"] != launches["gp_hall"] or \
            launches["gp_hall_panels"] != panels:
        fail(f"params_car_samples launches {launches} (wide {wide}) for "
             f"{len(qps)} QPs")

    res = {"gp_sample": time_gp_sample("car_samples", walk["empty"])}
    rows = []
    for nh, st_in in sorted(walk["hall"].items()):
        no, ns, Ht, Rr = st_in["Kxr"].shape
        t_k = cuda_ms(lambda: gp_hall.sample_hall(**st_in), n=5, warm=1, k=1)
        t_p = cuda_ms(lambda: gp_hall.sample_hall_plain_stacked(**st_in),
                      n=3, warm=1, k=1)
        nb, fl = gp_hall_bound(ns, Ht, Rr, nh)
        b, by = bound_ms(no * nb, no * fl)
        branch = "global" if gp_hall.factor_tiles_global(Ht, nh) else "shared"
        dev_ms = hall_kernel_ms(lambda: gp_hall.sample_hall(**st_in))
        print(f"[timing] gp_hall car_samples nh={nh} (no={no}, ns={ns}, "
              f"Ht={Ht}, Rr={Rr}, Rh={st_in['Kxh'].shape[-1]}; factor tiles "
              f"in {branch} memory, {gp_hall.hall_panels(Ht, nh)} panel "
              f"steps): all {no} outputs in one launch set {t_k:.4f} ms "
              f"(bound {b:.5f} ms, {by}), plain {t_p:.4f} ms; device ms by "
              f"kernel {dev_ms}", flush=True)
        rows.append(dict(nh=nh, tiles=branch, ms=t_k, plain_ms=t_p,
                         bound_ms=b, bound_by=by, kernel_ms=dev_ms,
                         panels=gp_hall.hall_panels(Ht, nh)))
    res["gp_hall"] = rows
    res["ipm"] = (checks.timing("car_samples cold", qp0, None, None),
                  checks.timing("car_samples warm", qpw, wsw, wvw))
    return dict(launches=launches, wide=wide, errs=errs, timing=res,
                plan_err=(dx, du), ms=step_ms[0])


def drone_phase(dev, checks):
    """params_drone_obstacles_approx on the card, float32: the golden's
    pessimistic and optimistic steps teacher-forced through the kernels and
    through the plain versions, each plan against the float64 golden; the
    IPM checks on each planner's first QP; then each planner's closed loop
    (ApproxMPC.run on the golden's draws, the counts zeroed before and read
    after) and its ms per step against dt."""
    import copy
    import numpy as np
    import torch
    import yaml
    from sampling_gpmpc_torch.approx.solver import ApproxMPC
    f32 = torch.float32
    T = lambda a: torch.as_tensor(a, dtype=f32, device=dev)
    g = np.load(DRONE_GOLDEN)
    with open(DRONE_CONFIG) as fh:
        params = yaml.safe_load(fh)
    p_opt = copy.deepcopy(params)
    p_opt["agent"]["run"]["optimistic"] = True
    p_opt["agent"]["run"]["pessimistic"] = False
    dt_ms = 1e3 * params["optimizer"]["dt"]
    res = {}
    for tag, prm, n in (("pessimistic", params, int(g["n_pess"])),
                        ("optimistic", p_opt, int(g["n_opt"]))):
        key = "pess" if tag == "pessimistic" else "opt"
        mpc = ApproxMPC(prm, device=dev, dtype=f32)
        env_x, env_u = plan_err(g[f"{key}_f32_X"], g[f"{key}_f32_U"],
                                g[f"{key}_X"], g[f"{key}_U"])
        tol_x, tol_u = ENV_FACTOR * env_x, ENV_FACTOR * env_u

        def step(m):
            wpath = T(mpc.model.path_generator(m))
            x = T(g[f"{key}_x"][m])
            if key == "pess":
                d = mpc._tightening(x, T(g["pess_U0"][m]), T(g["pess_z"][m]),
                                    mpc.post, mpc.W_nominal)
                X, U, s = mpc._sqp_solve(x, T(g["pess_X0"][m]),
                                         T(g["pess_U0"][m]), wpath, d,
                                         mpc.W_nominal)
                return X, U, int(s)
            X0 = U0 = None
            if m:
                X0, U0 = (np.concatenate([g[k][m - 1][1:], g[k][m - 1][-1:]])
                          for k in ("opt_X", "opt_U"))
            return mpc.solve_optimistic(x, wpath=wpath, X0=X0, U0=U0)

        ex, eu, kx, ku, stat = [], [], [], [], []
        qps = []
        for m in range(n):
            with captured_qps(qps):
                X, U, s = step(m)
            with plain_route():
                Xp, Up, sp = step(m)
            e = plan_err(X, U, g[f"{key}_X"][m], g[f"{key}_U"][m])
            c = plan_err(X, U, Xp.cpu().numpy(), Up.cpu().numpy())
            ex.append(e[0])
            eu.append(e[1])
            kx.append(c[0])
            ku.append(c[1])
            stat.append((s, sp))
        jax_stat = [int(v) for v in g[f"{key}_f32_status"]]
        n4, n4_jax = sum(a == 4 for a, _ in stat), sum(v == 4 for v in jax_stat)
        print(f"[drone] {tag} teacher-forced {n} steps vs the f64 golden: "
              f"max|dX| {max(ex):.4e} (tol {tol_x:.4f}), max|dU| "
              f"{max(eu):.4e} (tol {tol_u:.4f}; the JAX float32 path reads "
              f"{env_x:.4e} / {env_u:.4e}); kernels vs plain versions "
              f"{max(kx):.4e} / {max(ku):.4e}; statuses kernel/plain "
              f"{stat}, the JAX float32 path's {jax_stat}", flush=True)
        if max(ex) > tol_x or max(eu) > tol_u or max(kx) > tol_x \
                or max(ku) > tol_u or n4 > n4_jax:
            fail(f"drone {tag} teacher-forced steps")
        # the first QP of the first step: in float32 the pessimistic one
        # ends with status 4 (as the JAX float32 path's step 0), so the
        # kernels are held to the plain version's status
        (qa, _, _) = qps[0]
        shape = tuple(qa[i].shape[0] for i in (1, 3, 5))
        plain = checks.qp._finish(*checks.ipm.run_full_plain(
            *qa, None, None, checks.tol, checks.reg, 150, *checks.consts,
            checks.qp.WS_BAND), checks.tol)
        errs = [checks.report(
            f"drone {tag}, step 0 QP (nU, m_h, m_s) = {shape}", qa, None,
            None, resident=checks.ipm.loop_layout(*shape).resident,
            prep_resident=checks.ipm.prepare_layout(*shape).resident,
            status=int(plain.status))]
        timing = checks.timing(f"drone {tag}, step 0 QP", qa, None, None)

        mpc = ApproxMPC(prm, device=dev, dtype=f32)
        zero_launch_counts()
        torch.cuda.synchronize()
        out = mpc.run(num_iters=n, draws=g["pess_z"])
        torch.cuda.synchronize()
        launches, wide = launch_counts(), wide_launch_counts()
        ms = [1e3 * t for t in out["solver_time"]]
        window = sum(ms[1:]) / (len(ms) - 1)
        traj = np.stack(out["physical_state_traj"] + [out["final_state"]])
        print(f"[drone] {tag} closed loop, {n} steps (ApproxMPC.run, cuda "
              f"float32): status {out['status']}, finite "
              f"{bool(np.isfinite(traj).all())}; ms per MPC step over steps "
              f"1..{n - 1}: mean {window} (median {statistics.median(ms[1:])}"
              f", max {max(ms[1:])}) against dt = {dt_ms:.0f} ms; first step "
              f"{ms[0]:.1f}; launches {launches}, of them in the wide builds "
              f"{wide}", flush=True)
        need_wide = tag == "optimistic"
        if not np.isfinite(traj).all() or launches["ipm_prepare"] <= 0 or \
                launches["ipm_mehrotra"] <= 0 or \
                (min(wide.values()) > 0) != need_wide:
            fail(f"drone {tag} closed loop")
        res[tag] = dict(launches=launches, wide=wide, errs=errs,
                        timing=timing, ms_per_step=window, dt_ms=dt_ms,
                        plan_err=(max(ex), max(eu)))
    return res


def debug_phase(dev):
    """params_car at full width (ns=20, H=15, four SQP iterations, three
    outputs), its golden's first DEBUG_STEPS steps teacher-forced on the
    golden's draws: sqp.solve and sqp.solve_recorded on identical inputs
    must give bit-identical X, U, X_prev, U_prev, iterations, status and
    QP iterations, with the same launches of each loop kernel; the
    recorded solve's posterior value moments (float32 on the card) against
    their float64 evaluation on the CPU on the same gp state; ms per step
    of both routes."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp import exact
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    gc = np.load(CAR_GOLDEN)
    params, spec, data = load_problem(
        os.path.join(HERE, "params", CAR_CONFIG + ".yaml"))
    env = make_env(spec, params)
    ocp = make_ocp_data(spec, data, dev, f32)
    hyp = GPHyperArrays.from_spec(spec.gp, dev, f32)
    gp = agent.init_gp_state(spec, env, dev, f32, hyp=hyp)
    hyp64 = GPHyperArrays.from_spec(spec.gp, cpu, f64)
    gp64 = agent.init_gp_state(spec, env, cpu, f64, hyp=hyp64)
    sig_n = torch.stack([torch.sqrt(NOISE_REL * exact.prior_task_variances(
        hyp64.lengthscale[j], hyp64.outputscale[j], spec.Ty)[0])
        for j in range(spec.g_ny)])[None, :, None]
    T = lambda a: torch.as_tensor(a, dtype=f32, device=dev)
    eps = T(gc["eps"])
    cX, cU, cphys = (gc["plan_X_traj"], gc["plan_U_traj"],
                     gc["physical_state_traj"])
    keys = ("X", "U", "X_prev", "U_prev", "status", "qp_iters")
    ms = {"solve": [], "solve_recorded": []}
    launches = {"solve": [], "solve_recorded": []}
    worst = {0: 0.0, 1: 0.0}          # moments: iteration 0, iterations >= 1
    its = []
    for m in range(DEBUG_STEPS):
        if m == 0:
            Xs, Us = sqp.init_iterate(spec, dev, f32, data.start)
        else:                                   # shift_soln: False
            Xs, Us = T(cX[m - 1]), T(cU[m - 1])
        args = (spec, env, hyp, ocp, T(cphys[m]), Xs, Us, gp, eps[m])
        probes = []

        def probe(g, Xt):
            mv = agent.posterior_value_moments(spec, hyp, g, Xt)
            probes.append((g, Xt, mv))
            return mv

        out = {}
        for route in ("solve", "solve_recorded"):
            zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "solve":
                st = sqp.solve(*args)
            else:
                st, recs = sqp.solve_recorded(*args, probe_fn=probe)
            int(st.status)
            torch.cuda.synchronize()
            ms[route].append(1e3 * (time.perf_counter() - t0))
            launches[route].append(launch_counts())
            out[route] = st
        a, b = out["solve"], out["solve_recorded"]
        its.append(a.it)
        if a.it != b.it or len(recs) != b.it:
            fail(f"debug step {m}: SQP iterations {a.it} (solve) against "
                 f"{b.it} (solve_recorded, {len(recs)} records)")
        for k in keys:
            if not torch.equal(getattr(a, k), getattr(b, k)):
                fail(f"debug step {m}: {k} of solve_recorded differs from "
                     f"solve's (max |d| "
                     f"{float((getattr(a, k) - getattr(b, k)).abs().max())})")
        if launches["solve"][-1] != launches["solve_recorded"][-1]:
            fail(f"debug step {m}: launches {launches['solve'][-1]} (solve) "
                 f"against {launches['solve_recorded'][-1]} (recorded)")
        if not_launched(launches["solve"][-1]):
            fail(f"debug step {m}: a loop kernel was not launched: "
                 f"{launches['solve'][-1]}")
        for it, (g, Xt, (mu, sd)) in enumerate(probes):
            g64 = gp64._replace(hall_Z=g.hall_Z.to(cpu, f64),
                                hall_Y=g.hall_Y.to(cpu, f64),
                                hall_n=g.hall_n)
            mu64, sd64 = agent.posterior_value_moments(spec, hyp64, g64,
                                                       Xt.to(cpu, f64))
            tube = spec.gp.beta * (sd64 + sig_n)    # as tube_width
            e = max(float(((mu.to(cpu, f64) - mu64).abs() / tube).max()),
                    float(((sd.to(cpu, f64) - sd64).abs() / tube).max()))
            worst[min(it, 1)] = max(worst[min(it, 1)], e)
    print(f"[debug] params_car steps 0-{DEBUG_STEPS - 1} teacher-forced (ns="
          f"{spec.ns}, H={spec.H}, {spec.max_sqp_iter} SQP iterations, "
          f"{spec.g_ny} outputs): solve_recorded bit-identical to solve in "
          f"{', '.join(keys)} and SQP iterations ({its}); launches per step "
          f"equal on both routes: {launches['solve']}", flush=True)
    print(f"[debug] posterior_value_moments float32 on the card vs float64 "
          f"on the CPU, same gp state, max |d| / tube width: iteration 0 "
          f"{worst[0]:.3e} (tol {DEBUG_MOMENT_TOL}), iterations >= 1 "
          f"{worst[1]:.3e} (tol {DEBUG_HALL_MOMENT_TOL})", flush=True)
    print(f"[debug] ms per step: solve {[round(v, 3) for v in ms['solve']]},"
          f" solve_recorded {[round(v, 3) for v in ms['solve_recorded']]}"
          f" (steps 1-{DEBUG_STEPS - 1} mean: solve "
          f"{statistics.mean(ms['solve'][1:])}, solve_recorded "
          f"{statistics.mean(ms['solve_recorded'][1:])})", flush=True)
    if worst[0] > DEBUG_MOMENT_TOL or worst[1] > DEBUG_HALL_MOMENT_TOL:
        fail("posterior_value_moments on the card disagrees with float64")
    total = {k: sum(c[k] for c in launches["solve_recorded"])
             for k in launches["solve_recorded"][0]}
    return dict(ms=ms, launches=total, moments=worst)


def tools_phase(dev):
    """The design tools at params_pendulum1D_samples' settings, float64 on
    the card against the CPU: the Adam fit (TOOLS_FIT_ITERS steps, ms per
    step), the Lipschitz constant, both terminal-set syntheses, the
    small-ball deviations on TOOLS_INJECTED injected CPU draws per grid
    size and num_of_samples.run on each device's own TOOLS_N_MC draws per
    grid size (p_ball within TOOLS_SIGMAS binomial standard deviations;
    draws per second, p_ball and N(delta))."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.tools import lipschitz, mle, num_of_samples
    from sampling_gpmpc_torch.tools import sample_complexity as sc
    from sampling_gpmpc_torch.tools import terminal_set
    cpu = torch.device("cpu")
    params, spec, data = load_problem(
        os.path.join(HERE, "params", TOOLS_CONFIG + ".yaml"))
    env = make_env(spec, params)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    # the Adam fit of output 0's hyperparameters: TOOLS_FIT_SHORT steps to
    # TOOLS_FIT_RTOL, TOOLS_FIT_ITERS steps to TOOLS_FIT_LONG_RTOL
    X, Y = env.training_grid()
    fits, wall = {}, {}
    for d in (dev, cpu):
        for iters in (TOOLS_FIT_SHORT, TOOLS_FIT_ITERS):
            t0 = time.perf_counter()
            fits[d.type, iters] = mle.fit_gp_hyperparameters(
                X, Y[0], iters=iters, device=d)
            wall[d.type, iters] = time.perf_counter() - t0
    hp = ("lengthscale", "outputscale", "task_noises")
    fit_rel = lambda a, b: max(rel(a[k], b[k]) for k in hp)
    e_short = fit_rel(fits["cuda", TOOLS_FIT_SHORT],
                      fits["cpu", TOOLS_FIT_SHORT])
    e_fit = fit_rel(fits["cuda", TOOLS_FIT_ITERS],
                    fits["cpu", TOOLS_FIT_ITERS])
    f300 = fits["cuda", TOOLS_FIT_ITERS]
    ms_step = 1e3 * wall["cuda", TOOLS_FIT_ITERS] / TOOLS_FIT_ITERS
    print(f"[tools] fit_gp_hyperparameters, float64 (M={X.shape[0]}, with "
          f"gradient tasks), max rel. diff card/CPU: {TOOLS_FIT_SHORT} Adam "
          f"steps {e_short:.3e} (tol {TOOLS_FIT_RTOL}), {TOOLS_FIT_ITERS} "
          f"steps {e_fit:.3e} (tol {TOOLS_FIT_LONG_RTOL}); {ms_step:.3f} "
          f"ms per Adam step on "
          f"the card ("
          f"{1e3 * wall['cpu', TOOLS_FIT_ITERS] / TOOLS_FIT_ITERS:.3f} on "
          f"the CPU); lengthscale {f300['lengthscale']}, outputscale "
          f"{f300['outputscale']}, task noises {f300['task_noises']}, nll "
          f"{f300['nll']}", flush=True)
    if not (e_short <= TOOLS_FIT_RTOL and e_fit <= TOOLS_FIT_LONG_RTOL):
        fail("the Adam fit on the card disagrees with the CPU")

    # Lipschitz constant and terminal sets
    grid = lipschitz.grid_around([2.1, -2.5, -5.0], [3.6, 2.5, 5.0], 7)
    lip = {d.type: lipschitz.estimate_lipschitz(
        env, data.P_term, data.K_fb, grid[:, :2], grid[:, 2:], device=d)
        for d in (dev, cpu)}
    x_eq, u_eq = data.goal, np.zeros(spec.nu)
    pts = (np.concatenate([x_eq, u_eq])[None] + 0.1 * np.random.default_rng(
        0).normal(size=(12, spec.nx + spec.nu)))
    box = (data.x_min, data.x_max, data.u_min, data.u_max)
    ric, lmi = {}, {}
    for d in (dev, cpu):
        ric[d.type] = terminal_set.synthesize(
            env, x_eq, u_eq, np.diag([10.0, 15.0]), np.diag([0.9]), *box,
            vertices=pts, device=d)
        lmi[d.type] = terminal_set.synthesize_lmi(
            env, x_eq, u_eq, 0.995, *box, vertices=pts, device=d)
    e_term = {"lipschitz": rel(lip["cuda"], lip["cpu"])}
    for name, ts in (("synthesize", ric), ("synthesize_lmi", lmi)):
        for k in ("P", "K", "rho"):
            e_term[f"{name} {k}"] = rel(getattr(ts["cuda"], k),
                                        getattr(ts["cpu"], k))
    print(f"[tools] Lipschitz constant {lip['cuda']} ({grid.shape[0]} grid "
          f"points), Riccati rho {ric['cuda'].rho}, LMI rho "
          f"{lmi['cuda'].rho}; max rel. diff card/CPU "
          f"{ {k: float(f'{v:.3e}') for k, v in e_term.items()} } "
          f"(tol {TOOLS_RTOL})", flush=True)
    if not max(e_term.values()) <= TOOLS_RTOL:
        fail("a Lipschitz or terminal-set result on the card disagrees "
             "with the CPU")

    # the small-ball deviations on injected draws, every grid size
    hyp = spec.gp
    Z, y = num_of_samples._train_values(params, spec, 0)
    ls, os_, lam = np.asarray(hyp.lengthscale[0]), hyp.outputscale[0], \
        hyp.noise
    gen = torch.Generator().manual_seed(11)
    e_dev, n_draws = 0.0, 0
    for n in range(1, 9):
        g = sc.gp_input_grid(spec, data, n)
        eps = torch.randn((TOOLS_INJECTED, g.shape[0]), generator=gen,
                          dtype=torch.float64)
        dk = sc.max_deviation_samples_chunked(Z, y, g, ls, os_, lam,
                                              TOOLS_INJECTED, eps=eps,
                                              device=dev)
        dc = sc.max_deviation_samples_chunked(Z, y, g, ls, os_, lam,
                                              TOOLS_INJECTED, eps=eps,
                                              device=cpu)
        e_dev = max(e_dev, float(np.max(np.abs(dk - dc))))
        n_draws += TOOLS_INJECTED
    print(f"[tools] small-ball deviations on {TOOLS_INJECTED} injected CPU "
          f"draws per grid size (n_grid 1-8): max |d| card/CPU {e_dev:.3e} "
          f"(tol {TOOLS_DEV_TOL})", flush=True)
    if not e_dev <= TOOLS_DEV_TOL:
        fail("small-ball deviations on the card disagree with the CPU")

    # num_of_samples.run on each device's own draws
    res, wall = {}, {}
    for d in (dev, cpu):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[d.type] = num_of_samples.run(params, spec, data,
                                         n_mc=TOOLS_N_MC, device=d)
        wall[d.type] = time.perf_counter() - t0
    pk, pc = res["cuda"]["p_ball"], res["cpu"]["p_ball"]
    sd = np.sqrt((pk * (1 - pk) + pc * (1 - pc)) / TOOLS_N_MC)
    n_grids = len(res["cuda"]["grids"])
    rate = n_grids * TOOLS_N_MC / wall["cuda"]
    print(f"[tools] num_of_samples.run, {n_grids} grid sizes x "
          f"{TOOLS_N_MC} draws, float64: card {wall['cuda']:.3f} s "
          f"({rate:.0f} draws/s, the set-up included), CPU "
          f"{wall['cpu']:.3f} s; p_ball card {pk} CPU {pc} (|d| "
          f"{abs(pk - pc) / max(sd, 1e-300):.2f} binomial sd, tol "
          f"{TOOLS_SIGMAS}); C_D {res['cuda']['Cd']['Cd']}; N(delta="
          f"{res['cuda']['delta']}) card {res['cuda']['num_samples']} CPU "
          f"{res['cpu']['num_samples']}", flush=True)
    if not abs(pk - pc) <= TOOLS_SIGMAS * sd:
        fail("p_ball on the card is not within the binomial spread of the "
             "CPU's")
    return dict(fit_ms_per_step=ms_step, draws_per_s=rate, p_ball=pk,
                num_samples=res["cuda"]["num_samples"])


def shard_phase(dev):
    """The sample-sharded solve (sampling_gpmpc_torch/parallel/) on the
    card, float32, at full width; see the SHARD_* constants.  The blocked
    route runs SHARD_BLOCKS threads of one process, each on its own CUDA
    stream, with the ordered sums; its GP stages go through gp_sample and
    gp_hall per block on the local ns, its QPs through the plain body
    under the group (the JAX gate keeps the IPM kernels off under a sample
    axis).  Returns the blocked flagship's launches per kernel."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent, setup
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import shift_solution
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.gp.kernel import kernel_matrix
    from sampling_gpmpc_torch.gp.train_sharded import sharded_posterior_fn
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    from sampling_gpmpc_torch.parallel import sharded
    from sampling_gpmpc_torch.parallel.collectives import BlockGroup, split
    from sampling_gpmpc_torch.parallel.worker import COUNTERS, problem
    from sampling_gpmpc_torch.reachability import forward_sample_rollout
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    nb = SHARD_BLOCKS
    card = setup.card_line()
    keys = ("gp_sample", "gp_hall", "ipm_prepare", "ipm_mehrotra", "group",
            "run_full")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def blocks(group):
        return [{k: d.get(k, 0) for k in keys} for d in group.launches]

    def check_blocks(tag, per_block, hall):
        if any(b["gp_sample"] < 1 or (hall and b["gp_hall"] < 1)
               or b["ipm_prepare"] or b["ipm_mehrotra"] or b["run_full"]
               or b["group"] < 1 for b in per_block):
            fail(f"shard {tag}: a block's launches or QP routes are not "
                 f"those of the sharded path: {per_block}")
        if launch_counts()["ipm_prepare"] or launch_counts()["ipm_mehrotra"]:
            fail(f"shard {tag}: an IPM kernel ran under the group")

    def errs(a, b):
        return (float((a.X.to(f64).cpu() - b.X.to(f64).cpu()).abs().max()),
                float((a.U.to(f64).cpu() - b.U.to(f64).cpu()).abs().max()))

    # ---- the flagship: one RTI iteration, then three forced ------------
    flag = {}
    for iters in (1, SHARD_ITERS):
        spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
            CONFIG, SHARD_NS, iters, dev, f32)
        args = (st, X0, U0, gp, eps)
        blocked = sharded.make_blocked_solve(spec, env, hyp, ocp, nb)
        ref, ms_one = timed(lambda: sqp.solve(spec, env, hyp, ocp, *args))
        ref, ms_one = timed(lambda: sqp.solve(spec, env, hyp, ocp, *args))
        zero_launch_counts()
        out, ms_blk = timed(lambda: blocked(*args))
        per_block = blocks(blocked.group)
        check_blocks(f"flagship {iters} iterations", per_block, iters > 1)
        (spec64, env64, hyp64, ocp64, gp64, X64, U64, st64,
         eps64) = problem(CONFIG, SHARD_NS, iters, cpu, f64)
        ref64 = sqp.solve(spec64, env64, hyp64, ocp64, st64, X64, U64, gp64,
                          eps64)
        ok = (int(ref.status) == int(out.status) == 0 and out.it == ref.it
              == iters and (iters == 1 or out.gp.hall_n == iters * spec.H)
              and bool(torch.isfinite(out.X).all())
              and bool(torch.isfinite(out.U).all()))
        e_kb, e_b64, e_k64 = errs(out, ref), errs(out, ref64), \
            errs(ref, ref64)
        print(f"[shard] {CONFIG} ns={spec.ns} H={spec.H} over {nb} blocks "
              f"of {spec.ns // nb}, {iters} SQP iteration(s)"
              f"{' (tol_nlp = 0)' if iters > 1 else ''}: status blocked "
              f"{int(out.status)}, one-device {int(ref.status)}, float64 "
              f"CPU {int(ref64.status)}; iterations {out.it}/{ref.it}; hall "
              f"fill {out.gp.hall_n}; blocked vs one-device card max|dX| "
              f"{e_kb[0]:.3e} max|dU| {e_kb[1]:.3e}; blocked vs float64 "
              f"CPU {e_b64[0]:.3e} / {e_b64[1]:.3e}; one-device vs float64 "
              f"{e_k64[0]:.3e} / {e_k64[1]:.3e} (caps {TF_TOL_X} / "
              f"{TF_TOL_U})", flush=True)
        print(f"[shard] flagship {iters} iteration(s): launches per block "
              f"(gp kernels and QP routes) {per_block}; ms per solve: "
              f"one-device kernel route {ms_one:.3f}, blocked {ms_blk:.3f} "
              f"({card})", flush=True)
        if not ok or max(e_kb[0], e_b64[0], e_k64[0]) > TF_TOL_X or max(
                e_kb[1], e_b64[1], e_k64[1]) > TF_TOL_U:
            fail(f"shard flagship at {iters} SQP iteration(s)")
        flag[iters] = dict(out=out, per_block=per_block, args=args,
                           ms=(ms_one, ms_blk))
    launches = {k: sum(b[k] for b in flag[SHARD_ITERS]["per_block"])
                for k in ("gp_sample", "gp_hall", "ipm_prepare",
                          "ipm_mehrotra")}

    # ---- params_car over 4 blocks of 5, teacher-forced -----------------
    gc = np.load(CAR_GOLDEN)
    params_c, spec_c, data_c = load_problem(
        os.path.join(HERE, "params", CAR_CONFIG + ".yaml"))
    env_c = make_env(spec_c, params_c)
    ocp_c = make_ocp_data(spec_c, data_c, dev, f32)
    hyp_c = GPHyperArrays.from_spec(spec_c.gp, dev, f32)
    gp_c = agent.init_gp_state(spec_c, env_c, dev, f32, hyp=hyp_c)
    Tc = lambda a: torch.as_tensor(a, dtype=f32, device=dev)  # noqa: E731
    eps_c = Tc(gc["eps"])
    blocked_c = sharded.make_blocked_solve(spec_c, env_c, hyp_c, ocp_c, nb)
    rows, car_blocks, car_ms = [], [], []
    for m in range(SHARD_CAR_STEPS):
        if m == 0:
            Xs, Us = sqp.init_iterate(spec_c, dev, f32, data_c.start)
        else:                                   # shift_soln: False
            Xs, Us = Tc(gc["plan_X_traj"][m - 1]), Tc(gc["plan_U_traj"][m - 1])
        a = (Tc(gc["physical_state_traj"][m]), Xs, Us, gp_c, eps_c[m])
        ref, ms_one = timed(lambda: sqp.solve(spec_c, env_c, hyp_c, ocp_c,
                                              *a))
        zero_launch_counts()
        out, ms_blk = timed(lambda: blocked_c(*a))
        car_blocks.append(blocks(blocked_c.group))
        check_blocks(f"car step {m}", car_blocks[-1], True)
        car_ms.append((ms_one, ms_blk))
        gX, gU = gc["tf_X_traj"][m], gc["tf_U_traj"][m]
        rows.append((int(out.status), int(ref.status), out.it, ref.it,
                     errs(out, ref), plan_err(out.X, out.U, gX, gU),
                     plan_err(ref.X, ref.U, gX, gU)))
    print(f"[shard] {CAR_CONFIG} ns={spec_c.ns} over {nb} blocks of "
          f"{spec_c.ns // nb}, {spec_c.max_sqp_iter} SQP iterations, golden "
          f"steps 0-{SHARD_CAR_STEPS - 1} teacher-forced: (status blocked, "
          f"one-device, iterations blocked, one-device, blocked vs "
          f"one-device (dX, dU), blocked vs golden, one-device vs golden) "
          f"{rows} (caps {TF_CAR_TOL_X} / {TF_CAR_TOL_U})", flush=True)
    print(f"[shard] car launches per block and step {car_blocks}; ms per "
          f"step (one-device, blocked) "
          f"{[(round(a, 3), round(b, 3)) for a, b in car_ms]} ({card})",
          flush=True)
    for r in rows:
        if r[0] != 0 or r[1] != 0 or max(r[4][0], r[5][0], r[6][0]) > \
                TF_CAR_TOL_X or max(r[4][1], r[5][1], r[6][1]) > TF_CAR_TOL_U:
            fail("shard car teacher-forced steps")

    # ---- a 3-step sharded closed loop on the flagship ------------------
    spec, env, hyp, ocp, gp, X0, U0, st, _ = problem(CONFIG, SHARD_NS, 1,
                                                     dev, f32)
    spec = dataclasses.replace(spec, num_mpc_iter=SHARD_LOOP_STEPS)
    eps_w = agent.make_epistemic(spec, None, dev, f32)
    grp = BlockGroup(nb)
    loop = sharded.make_sharded_closed_loop(spec, env, hyp, ocp, grp,
                                            ordered=True)
    outs, ms_loop = timed(lambda: grp.run(loop, st, X0, U0, gp, eps_w))
    x_w, U_w = outs[0][0], outs[0][2]
    X_w = torch.cat([o[1] for o in outs], dim=1)

    def one_device_loop():
        x, X, U, g = st, X0, U0, gp
        ws, wv = sqp.init_qp_ws(spec, dev, f32), torch.zeros(
            (), dtype=torch.bool, device=dev)
        for k in range(SHARD_LOOP_STEPS):
            s = sqp.solve(spec, env, hyp, ocp, x, X, U, g, eps_w[k], ws, wv)
            if int(s.status) != 0:
                fail(f"shard closed loop: one-device step {k} status "
                     f"{int(s.status)}")
            X, U, g, ws, wv = s.X, s.U, s.gp, s.qp_ws, s.qp_valid
            u0 = U[0]
            if spec.use_feedback:
                u0 = u0 - (ocp.x_eq - X[0, 0]) @ ocp.K_fb.T
            x = env.discrete_dyn(X[0, 0], u0).reshape(-1)
            if spec.shift_soln:
                X, U = shift_solution(X, U)
        return x, X, U

    (x_r, X_r, U_r), ms_loop1 = timed(one_device_loop)
    ex = float((x_w - x_r).abs().max())
    eX, eU = float((X_w - X_r).abs().max()), float((U_w - U_r).abs().max())
    print(f"[shard] {SHARD_LOOP_STEPS}-step sharded closed loop ({CONFIG} "
          f"ns={spec.ns} over {nb} blocks, ordered) vs the one-device card "
          f"loop: max|dx| {ex:.3e}, plan max|dX| {eX:.3e} (cap {TF_TOL_X}), "
          f"max|dU| {eU:.3e} (cap {TF_TOL_U}); final x {x_w.tolist()}; ms "
          f"per step: blocked {ms_loop / SHARD_LOOP_STEPS:.3f}, one-device "
          f"{ms_loop1 / SHARD_LOOP_STEPS:.3f} ({card})", flush=True)
    if (not bool(torch.isfinite(X_w).all()) or max(ex, eX) > TF_TOL_X
            or eU > TF_TOL_U or outs[0][3].hall_n != spec.H):
        fail("shard closed loop")

    # ---- forward sampling over 4 blocks --------------------------------
    params_f, spec_f, data_f = load_problem(
        os.path.join(HERE, "params", FS_CONFIG + ".yaml"))
    env_f = make_env(spec_f, params_f)
    Tf = spec_f.num_mpc_iter
    hyp_f = GPHyperArrays.from_spec(spec_f.gp, dev, f32)
    gp_f = agent.init_gp_state(spec_f, env_f, dev, f32, capacity=Tf,
                               hyp=hyp_f)
    fb = {"K": data_f.K_fb, "x_eq": data_f.goal}
    eps_f = agent.truncated_normal((Tf, spec_f.ns, spec_f.g_ny, 1, spec_f.Ty),
                                   spec_f.gp.beta,
                                   torch.Generator().manual_seed(spec_f.seed),
                                   dev, f32)
    U_f = np.load(FS_GOLDEN)["last_plan_U"][:Tf]
    grp_f = BlockGroup(nb)
    roll = sharded.make_sharded_rollout(spec_f, env_f, hyp_f, grp_f,
                                        use_feedback=fb)
    outs_f, ms_roll = timed(lambda: grp_f.run(roll, gp_f, data_f.start, U_f,
                                              None, eps_f))
    X_b = torch.cat([o[0] for o in outs_f], dim=1).double().cpu().numpy()
    X_1, ms_roll1 = timed(lambda: forward_sample_rollout(
        spec_f, env_f, hyp_f, gp_f, data_f.start, U_f, use_feedback=fb,
        eps=eps_f)[0])
    X_1 = X_1.double().cpu().numpy()
    alive_b = np.isfinite(X_b).all(axis=(0, 2))
    alive = alive_b & np.isfinite(X_1).all(axis=(0, 2))

    def env_err(keep):
        e_b = np.stack([X_b[:, keep].min(1), X_b[:, keep].max(1)])
        e_1 = np.stack([X_1[:, keep].min(1), X_1[:, keep].max(1)])
        return float(np.abs(e_b - e_1).max())

    per_real = float(np.abs(X_b[:, alive] - X_1[:, alive]).max())
    env_head = env_err(alive & (np.arange(spec_f.ns) < FS_ENV_NS))
    env_all = env_err(alive)
    env_bar = FS_JAX_ENV_FACTOR * FS_JAX_ENV["replay of the golden plan"]
    print(f"[shard] {FS_CONFIG} ns={spec_f.ns} x T={Tf} over {nb} blocks vs "
          f"the one-device rollout on the same draws (float32): non-finite "
          f"realizations {int((~alive_b).sum())} (bar 1); per-realization "
          f"max|d| {per_real:.4e} (bar {FS_REAL_TOL}); envelope over the "
          f"first {FS_ENV_NS} {env_head:.4e} (bar {FS_ENV_TOL}), over all "
          f"{env_all:.4e} (bar {env_bar:.4f}); ms per rollout: blocked "
          f"{ms_roll:.3f}, one-device {ms_roll1:.3f} ({card})", flush=True)
    if (int((~alive_b).sum()) > 1 or per_real > FS_REAL_TOL
            or env_head > FS_ENV_TOL or env_all > env_bar):
        fail("shard rollout")

    # ---- the train-axis-sharded posterior in float64 -------------------
    rng = np.random.default_rng(0)
    n, D, M = SHARD_POST_PTS, SHARD_POST_D, SHARD_POST_M
    T64 = lambda a: torch.as_tensor(a, dtype=f64, device=dev)  # noqa: E731
    Z, Xq = T64(rng.uniform(-2, 2, (n, D))), T64(rng.uniform(-2, 2, (M, D)))
    y = T64(rng.normal(size=n * (1 + D)))
    noise = T64(rng.uniform(1e-3, 1e-2, n * (1 + D)))
    ls, os_ = np.full(D, 0.9), 0.7
    grp_p = BlockGroup(nb)
    post = sharded_posterior_fn(grp_p, ls, os_, True,
                                max_iter=n * (1 + D))
    outs_p, ms_post = timed(lambda: grp_p.run(lambda: post(
        split(Z, grp_p, 0), split(y, grp_p, 0), split(noise, grp_p, 0), Xq)))
    K = kernel_matrix(Z, Z, ls, os_, True) + torch.diag(noise)
    L = torch.linalg.cholesky(K)
    Kxz = kernel_matrix(Xq, Z, ls, os_, True)
    mean_d = Kxz @ torch.cholesky_solve(y[:, None], L)[:, 0]
    cov_d = kernel_matrix(Xq, Xq, ls, os_, True) - Kxz @ torch.cholesky_solve(
        Kxz.T, L)
    cov_d = 0.5 * (cov_d + cov_d.T)
    em = float((outs_p[0][0] - mean_d).abs().max())
    ec = float((outs_p[0][1] - cov_d).abs().max())
    print(f"[shard] train-axis posterior, float64 on the card over {nb} "
          f"blocks ({n} points, D={D}, with gradients: {n * (1 + D)} rows, "
          f"{M} query points) vs the dense Cholesky posterior: max|d mean| "
          f"{em:.3e}, max|d cov| {ec:.3e} (tol {SHARD_POST_TOL}); "
          f"{ms_post:.1f} ms ({card})", flush=True)
    if max(em, ec) > SHARD_POST_TOL:
        fail("shard train-axis posterior")

    # ---- SHARD_PROCS worker processes on this card over gloo -----------
    def workers(world, backend, out):
        port = free_port()
        env_w = {**os.environ, "PYTHONPATH": HERE}
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sampling_gpmpc_torch.parallel.worker",
             "--rank", str(r), "--world", str(world), "--port", str(port),
             "--out", out, "--device", "cuda", "--backend", backend,
             "--ns", str(SHARD_NS), "--max-sqp", str(SHARD_ITERS),
             "--ordered", "--repeats", str(SHARD_REPEATS)], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env_w) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SHARD_PROC_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"shard worker rank {r} ({backend}) exited "
                     f"{p.returncode}:\n{log[-3000:]}")
        return np.load(out)

    ref3 = flag[SHARD_ITERS]["out"]
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    runs = [("gloo", SHARD_PROCS)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", min(SHARD_PROCS, torch.cuda.device_count())))
    for backend, world in runs:
        got, ms_all = timed(lambda: workers(
            world, backend, os.path.join(out_dir, f"shard_{backend}.npz")))
        d = {k: float(np.nanmax(np.abs(got[k] - v.cpu().numpy())))
             for k, v in (("U", ref3.U), ("X", ref3.X),
                          ("hall_Y", ref3.gp.hall_Y))}
        same = all(np.array_equal(got[k], v.cpu().numpy(), equal_nan=True)
                   for k, v in (("U", ref3.U), ("X", ref3.X),
                                ("hall_Y", ref3.gp.hall_Y)))
        per_rank = [dict(zip(COUNTERS, map(int, r))) for r in got["launches"]]
        print(f"[shard] {world} worker processes ({backend}, one card "
              f"{'shared' if world > torch.cuda.device_count() else 'each'}"
              f", ordered, {SHARD_ITERS} SQP iterations, ns={SHARD_NS}) vs "
              f"the in-process blocked solve: bit-identical {same}; max|d| "
              f"U {d['U']:.3e}, X {d['X']:.3e}, hall_Y {d['hall_Y']:.3e} "
              f"(caps {TF_TOL_X} / {TF_TOL_U}); status {int(got['status'])},"
              f" iterations {int(got['it'])}; launches per rank {per_rank}; "
              f"ms per solve {[round(float(v), 3) for v in got['ms']]} "
              f"(first includes the ranks' warm-up; in-process blocked "
              f"{flag[SHARD_ITERS]['ms'][1]:.3f}, one-device "
              f"{flag[SHARD_ITERS]['ms'][0]:.3f}); {ms_all / 1e3:.1f} s with "
              f"start-up ({card})", flush=True)
        if (int(got["status"]) != 0 or int(got["it"]) != SHARD_ITERS
                or max(d["X"], d["hall_Y"]) > TF_TOL_X or d["U"] > TF_TOL_U
                or any(r["gp_sample"] < 1 or r["gp_hall"] < 1
                       or r["ipm_prepare"] or r["ipm_mehrotra"]
                       or r["qp_group"] != SHARD_ITERS for r in per_rank)):
            fail(f"shard worker processes ({backend})")
    if len(runs) == 1:
        print(f"[shard] NCCL group not run: {torch.cuda.device_count()} "
              f"card(s); NCCL takes one rank per card", flush=True)
    return launches


def gt_draws(spec, T, repeats):
    """Chunk 0's draws of the ground truth CLI, float64 on the CPU."""
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.simulate_true_reachable_set import \
        chunk_generator
    return agent.truncated_normal(
        (T, repeats * spec.ns, spec.g_ny, 1, spec.Ty), spec.gp.beta,
        chunk_generator(spec.seed, 0), torch.device("cpu"), torch.float64)


def gt_rollout(spec, env, data, U, x0, eps, repeats, dev, dtype):
    """The ground truth's batched rollout: (repeats, T+1, ns, nx)."""
    import dataclasses as dc
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch import simulate_true_reachable_set as gt
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    hyp = GPHyperArrays.from_spec(spec.gp, dev, dtype)
    gp0 = agent.init_gp_state(dc.replace(spec, ns=repeats * spec.ns), env,
                              dev, dtype, capacity=len(U), hyp=hyp)
    return gt.batch_rollout(spec, env, hyp, gp0, x0, U, repeats,
                            use_feedback=gt.feedback(spec, data),
                            eps=eps.to(dev, dtype))


def gt_coverage_compare(pred, X_a, X_b, nx):
    """Coverage tables of the plan ``pred`` (T+1, ns, nx) against two
    ground truths (repeats, T+1, ns, nx) and their largest differences on
    the stages whose truth hull has a volume: (rows_a, rows_b, d_cov,
    d_vol_rel, degenerate stages)."""
    import numpy as np
    from sampling_gpmpc_torch.reachable_set_coverage import coverage_table
    st = lambda X: np.transpose(X, (1, 0, 2, 3)).reshape(  # noqa: E731
        X.shape[1], -1, nx)
    ra, rb = coverage_table(pred, st(X_a)), coverage_table(pred, st(X_b))
    d_cov = d_vol = 0.0
    degenerate = []
    for a, b in zip(ra, rb):
        if a["vol_ratio"] is None or b["vol_ratio"] is None:
            degenerate.append(a["stage"])
            continue
        d_cov = max(d_cov, abs(a["coverage"] - b["coverage"]))
        d_vol = max(d_vol, abs(a["vol_ratio"] - b["vol_ratio"])
                    / b["vol_ratio"])
    return ra, rb, d_cov, d_vol, degenerate


def gt_phase(dev):
    """The Monte-Carlo ground truth (B1) at full width on the card."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.reachability import forward_sample_rollout
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch import simulate_true_reachable_set as gtm
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    g = np.load(GOLDEN)
    params, spec, data = load_problem(
        os.path.join(HERE, "params", GT_CONFIG + ".yaml"))
    env = make_env(spec, params)
    U, x0, pred = g["plan_U_traj"][0], g["physical_state_traj"][0], \
        g["plan_X_traj"][0]
    T, R, ns = len(U), GT_REPEATS, spec.ns
    eps = gt_draws(spec, T, R)
    walls = []
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):                      # the second run warm
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        X32 = gt_rollout(spec, env, data, U, x0, eps, R, dev, f32)
        X32 = X32.cpu().numpy()              # waits for the device
        walls.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    rate = R * ns * T / walls[1]
    # the first GT_F64_NS realizations in float64 on the card, same draws
    spec64 = dataclasses.replace(spec, ns=GT_F64_NS)
    hyp64 = GPHyperArrays.from_spec(spec.gp, dev, f64)
    gp64 = agent.init_gp_state(spec64, env, dev, f64, capacity=T, hyp=hyp64)
    X64, _ = forward_sample_rollout(
        spec64, env, hyp64, gp64, x0, U, use_feedback=gtm.feedback(spec,
                                                                    data),
        eps=eps[:, :GT_F64_NS].to(dev))
    X64 = X64.cpu().numpy()
    flat = np.transpose(X32, (1, 0, 2, 3)).reshape(T + 1, R * ns, spec.nx)
    head = flat[:, :GT_F64_NS]
    ok = np.isfinite(head).all(axis=(0, 2))
    per_real = float(np.max(np.abs(head[:, ok] - X64[:, ok])))
    env_err = float(max(np.max(np.abs(head[:, ok].max(1) - X64.max(1))),
                        np.max(np.abs(head[:, ok].min(1) - X64.min(1)))))
    nonfinite = int((~np.isfinite(flat).all(axis=(0, 2))).sum())
    print(f"[gt] {GT_CONFIG} step-0 plan: {R} repeats x {ns} realizations x "
          f"{T} steps in one rollout, float32: {walls[1]:.3f} s warm "
          f"({walls[0]:.3f} s first), {rate:.0f} sampled steps/s, peak "
          f"device memory {peak:.3f} GiB above the phase's start, "
          f"non-finite realizations "
          f"{nonfinite} of {R * ns}", flush=True)
    print(f"[gt] first {GT_F64_NS} realizations vs float64 on the card, same "
          f"draws: {per_real:.3e} per realization (tol {FS_REAL_TOL}), "
          f"envelope {env_err:.3e} (tol {FS_ENV_TOL})", flush=True)
    if (nonfinite > R * ns // 4000 or per_real > FS_REAL_TOL
            or env_err > FS_ENV_TOL):
        fail("gt: the float32 ground truth leaves float64")
    # coverage of the plan: the card's whole truth, and its first
    # GT_CPU_REPEATS repeats against float64 on the CPU on the same draws
    t0 = time.perf_counter()
    Xc = gt_rollout(spec, env, data, U, x0, eps[:, :GT_CPU_REPEATS * ns],
                    GT_CPU_REPEATS, cpu, f64).numpy()
    cpu_s = time.perf_counter() - t0
    full = gt_coverage_compare(pred, X32, X32, spec.nx)[0]
    ra, rb, d_cov, d_vol, degen = gt_coverage_compare(
        pred, X32[:GT_CPU_REPEATS], Xc, spec.nx)
    fmt = lambda v: "-" if v is None else f"{v:.4f}"  # noqa: E731
    print("[gt] stage: coverage / volume ratio of the plan, card float32 "
          f"{R} repeats | card float32 {GT_CPU_REPEATS} repeats | CPU "
          f"float64 {GT_CPU_REPEATS} repeats ({cpu_s:.1f} s)", flush=True)
    for f, a, b in zip(full, ra, rb):
        print(f"[gt]   {f['stage']:2d}: {f['coverage']:.4f} / "
              f"{fmt(f['vol_ratio'])} | {a['coverage']:.4f} / "
              f"{fmt(a['vol_ratio'])} | {b['coverage']:.4f} / "
              f"{fmt(b['vol_ratio'])}", flush=True)
    print(f"[gt] card vs CPU on {GT_CPU_REPEATS} repeats, stages with a "
          f"truth volume: coverage {d_cov:.4f} (tol {GT_COV_TOL}), volume "
          f"ratio {d_vol:.3e} relative (tol {GT_VOL_RTOL}); degenerate "
          f"stages {degen} printed, not held", flush=True)
    if d_cov > GT_COV_TOL or d_vol > GT_VOL_RTOL:
        fail("gt: the card's coverage disagrees with the CPU's float64")
    return dict(rate=rate, wall=walls[1], peak=peak, coverage=full)


def _rel(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def baseline_run(dev, dtype):
    """B5 and B6 on BASE_CONFIG: {name: numpy float64 array}."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch import linearization_baseline as lin
    from sampling_gpmpc_torch import robust_tube_baseline as rtb
    _, spec, data, env, hyp, gp = lin.one_sample_problem(BASE_CONFIG, dev,
                                                         dtype)
    t_ = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                   device=dev)
    U = t_(np.load(FS_GOLDEN)["last_plan_U"][:BASE_STEPS])
    x0, goal, k = t_(data.start), t_(data.goal), np.asarray(data.K_fb)
    mus, Ps = lin.propagate(spec, env, hyp, gp, x0, U)
    X = rtb.true_rollout(env, x0, U, k, goal)
    Z, Y = agent.full_train_set(spec, gp)
    l_mu, l_sig = rtb.estimate_lipschitz_from_traj(spec, env, hyp, Z, Y, X,
                                                   U)
    cs, Qs, _ = rtb.propagate_tube(spec, env, hyp, gp, x0, U, k, goal, l_mu,
                                   l_sig, spec.gp.beta)
    out = dict(means=mus, covs=Ps, l_mu=l_mu, l_sig=l_sig, centers=cs,
               shapes=Qs)
    return {n: v.detach().cpu().double().numpy() for n, v in out.items()}


def frozen_step(Qs):
    """The first step whose tube repeats the previous one (0: none)."""
    import numpy as np
    tr = np.trace(Qs, axis1=1, axis2=2)
    same = np.nonzero(tr[1:] == tr[:-1])[0]
    return int(same[0]) + 1 if same.size else 0


def baselines_phase(dev):
    """B5 and B6 float32 and float64 on the card against float64 on the
    CPU; E7 and E10 on the card."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.examples import gp_conditioning_demo as e7
    from sampling_gpmpc_torch.examples import lqr_sanity as e10
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    ref = baseline_run(cpu, f64)
    t0 = time.perf_counter()
    c64 = baseline_run(dev, f64)
    ms64 = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    c32 = baseline_run(dev, f32)
    ms32 = 1e3 * (time.perf_counter() - t0)
    fz = frozen_step(ref["shapes"])
    e64 = {n: _rel(c64[n][:fz] if n == "shapes" else c64[n],
                   ref[n][:fz] if n == "shapes" else ref[n]) for n in ref}
    e32 = {n: _rel(c32[n], ref[n]) for n in BASE_JAX_F32}
    fz32 = frozen_step(c32["shapes"])
    print(f"[baselines] {BASE_CONFIG}, {BASE_STEPS} steps: B5+B6 {ms64:.1f} "
          f"ms float64, {ms32:.1f} ms float32 on the card", flush=True)
    print("[baselines] card float64 vs CPU float64, relative: " + ", ".join(
        f"{n} {v:.2e}" for n, v in e64.items())
        + f" (tol {BASE_F64_RTOL}, shapes {BASE_TUBE_RTOL} up to the freeze "
        f"at step {fz}, the card's at {frozen_step(c64['shapes'])})",
        flush=True)
    print("[baselines] card float32 vs CPU float64, relative: " + ", ".join(
        f"{n} {v:.3e} (tol {ENV_FACTOR * BASE_JAX_F32[n]:.3e})"
        for n, v in e32.items())
        + f"; float32 tube frozen at step {fz32}, finite "
        f"{bool(np.isfinite(c32['shapes']).all())}", flush=True)
    if (max(v for n, v in e64.items() if n != "shapes") > BASE_F64_RTOL
            or e64["shapes"] > BASE_TUBE_RTOL
            or frozen_step(c64["shapes"]) != fz):
        fail("baselines: the card's float64 disagrees with the CPU's")
    if any(v > ENV_FACTOR * BASE_JAX_F32[n] for n, v in e32.items()):
        fail("baselines: the card's float32 leaves the reference's envelope")
    if not (np.isfinite(c32["shapes"]).all() and fz32 > 0):
        fail("baselines: the float32 tube is not finite and frozen")
    # E7 and E10 on the card, float64
    eps_p, eps_g = e7.draws(torch.Generator().manual_seed(0))
    r_card, r_cpu = e7.run(eps_p, eps_g, dev), e7.run(eps_p, eps_g, cpu)
    d_pts = float(np.abs(r_card["samples"] - r_cpu["samples"]).max())
    d_grid = float(np.abs(r_card["draws"] - r_cpu["draws"]).max())
    ts, V = e10.run(dev)
    ts_c, _ = e10.run(cpu)
    e10.check(V)
    d_gain = _rel(ts.K, ts_c.K)
    print(f"[baselines] E7 on the card vs the CPU: draws at the points "
          f"{d_pts:.2e} (tol 1e-10), on the grid {d_grid:.2e} (tol "
          f"{E7_GRID_TOL}), pinned within {e7.pinning_error(r_card):.2e}; "
          f"E10: V {V[0]:.4f} -> {V[-1]:.3e} in {len(V)} steps, decreasing, "
          f"gain {d_gain:.1e} from the CPU's", flush=True)
    if d_pts > 1e-10 or d_grid > E7_GRID_TOL or d_gain > 1e-10:
        fail("baselines: E7 or E10 on the card disagrees with the CPU")
    return dict(ms64=ms64, ms32=ms32, e64=e64, e32=e32)


def band_phase(dev):
    """The float32 status band of the three configs on the card."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import status_band
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    print(f"[band] float32 on the card: tol={qp_mod.TOL[torch.float32]:g}, "
          f"STATUS_RTOL band (tol, {qp_mod.STATUS_RTOL:g}*tol]", flush=True)
    total = {k: 0 for k in ("gp_sample", "gp_hall", "ipm_prepare",
                            "ipm_mehrotra")}
    rows = {}
    for config in status_band.CONFIGS:
        t0 = time.perf_counter()
        r = status_band.run_config(config, BAND_STEPS.get(config), dev,
                                   torch.float32)
        wall = time.perf_counter() - t0
        hist = status_band.report(config, r)
        n_qp, steps = len(r["statuses"]), len(r["X"])
        la = r["launches"]
        print(f"[band] {config}: {steps} steps in {wall:.2f} s, {n_qp} QPs",
              flush=True)
        if (r["routes"]["run_full"] != n_qp or r["routes"]["group"]
                or la["ipm_prepare"] != n_qp or la["ipm_mehrotra"] != n_qp
                or la["gp_sample"] != steps
                or la["gp_hall"] != n_qp - steps):
            fail(f"band {config}: a QP or GP stage left the kernels: {la}, "
                 f"{r['routes']}")
        if not (np.isfinite(r["X"]).all() and np.isfinite(r["U"]).all()):
            fail(f"band {config}: non-finite plan")
        rows[config] = dict(hist=hist.tolist(), launches=la,
                            consumed=int((r["statuses"] == 0).sum()),
                            max_ratio=float(np.max(r["gaps"][
                                r["statuses"] == 0] / r["tol"])))
        for k in total:
            total[k] += la[k]
    if min(total.values()) <= 0:
        fail(f"band: a kernel of the path was never launched: {total}")
    print(f"[band] launches over the three loops: {total}", flush=True)
    return dict(rows=rows, launches=total)


def mean_problem(dev, dtype):
    """params_car with mean_as_dyn_sample on ``dev``: (spec, env, hyp, gp,
    ocp)."""
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    params, spec, data = load_problem(
        os.path.join(HERE, "params", CAR_CONFIG + ".yaml"))
    spec = dataclasses.replace(spec, mean_as_dyn_sample=True)
    env = make_env(spec, params)
    hyp = GPHyperArrays.from_spec(spec.gp, dev, dtype)
    return (spec, env, hyp, agent.init_gp_state(spec, env, dev, dtype,
                                                hyp=hyp),
            make_ocp_data(spec, data, dev, dtype))


def mean_route_readings(dev, dtype):
    """The GP stage of ``mean_problem`` on ``dev`` in ``dtype`` at golden
    step CAR_STEP (its teacher-forced iterate and draws), SQP iterations 0
    and 1, against the same stage in float64 on the CPU on the same inputs
    (iteration 1 on the first's hall rows).  Returns per iteration the
    mean sample's distance from the float64 posterior mean and every
    draw's from its float64 evaluation, as shares of the tube width, the
    draws' tube violations and finiteness."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.gp import exact
    from sampling_gpmpc_torch.ocp import sqp
    f64, cpu = torch.float64, torch.device("cpu")
    gc = np.load(CAR_GOLDEN)
    spec, env, hyp, gp, ocp = mean_problem(dev, dtype)
    _, _, hyp64, gp64, _ = mean_problem(cpu, f64)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    m = CAR_STEP                               # shift_soln: False
    Xt = sqp._linearization_inputs(
        spec, ocp, T(gc["tf_X_traj"][m - 1]), T(gc["tf_U_traj"][m - 1]))[
        ..., list(spec.g_idx_inputs)]
    pv = torch.stack([exact.prior_task_variances(
        hyp64.lengthscale[j], hyp64.outputscale[j], spec.Ty).repeat(spec.H)
        for j in range(spec.g_ny)])
    sh = (spec.ns, spec.g_ny, spec.H * spec.Ty)
    out = []
    for it in range(2):
        eps = T(gc["eps"][m, it])
        g64 = gp64._replace(hall_Z=gp.hall_Z.to(cpu, f64),
                            hall_Y=gp.hall_Y.to(cpu, f64), hall_n=gp.hall_n)
        dg, gp = agent.sample_dynamics(spec, env, hyp, gp, Xt, eps,
                                       hall_empty=it == 0)
        dg64, _ = agent.sample_dynamics(spec, env, hyp64, g64,
                                        Xt.to(cpu, f64), eps.to(cpu, f64),
                                        hall_empty=it == 0)
        post = (agent._batched_posterior_real if it == 0 else
                agent._batched_posterior_incremental)
        mean64, cov64 = post(spec, hyp64, g64, Xt.to(cpu, f64))
        tube = tube_width(spec, mean64, cov64, pv)      # (ns, g_ny, Ht)
        dgc = dg.to(cpu, f64).reshape(sh)
        out.append(dict(
            mean=float(((dgc[0] - mean64[0]).abs() / tube[0]).max()),
            draws=float(((dgc - dg64.reshape(sh)).abs() / tube).max()),
            violations=int(((dgc - mean64).abs() > tube).sum()),
            finite=bool(torch.isfinite(dgc).all())))
    return out


def mean_phase(dev):
    """The mean route on the card (mean_as_dyn_sample): the reference body,
    as JAX's gate has it, with the IPM kernels."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.ocp import sqp
    f32 = torch.float32
    reads = mean_route_readings(dev, f32)
    for it, r in enumerate(reads):
        tol = DEBUG_MOMENT_TOL if it == 0 else DEBUG_HALL_MOMENT_TOL
        print(f"[mean] params_car, mean_as_dyn_sample, golden step "
              f"{CAR_STEP}, SQP iteration {it}: mean sample {r['mean']:.3e} "
              f"of the tube from the float64 mean (tol {tol}), every draw "
              f"{r['draws']:.3e} from its float64 evaluation (tol "
              f"{MEAN_REL_TOL}), tube violations {r['violations']}, finite "
              f"{r['finite']}", flush=True)
        if (r["mean"] > tol or r["draws"] > MEAN_REL_TOL or r["violations"]
                or not r["finite"]):
            fail(f"mean: iteration {it} on the card disagrees with float64")
    gc = np.load(CAR_GOLDEN)
    spec, env, hyp, gp, ocp = mean_problem(dev, f32)
    T = lambda a: torch.as_tensor(a, dtype=f32, device=dev)  # noqa: E731
    m = CAR_STEP
    zero_launch_counts()
    st = sqp.solve(spec, env, hyp, ocp, T(gc["physical_state_traj"][m]),
                   T(gc["tf_X_traj"][m - 1]), T(gc["tf_U_traj"][m - 1]), gp,
                   T(gc["eps"][m]))
    la = launch_counts()
    print(f"[mean] its solve on the card: status {int(st.status)}, {st.it} "
          f"SQP iterations, launches {la}", flush=True)
    if (int(st.status) != 0 or la["gp_sample"] or la["gp_hall"]
            or la["ipm_prepare"] != st.it or la["ipm_mehrotra"] != st.it):
        fail("mean: the mean route's solve took a GP kernel or left the "
             "IPM kernels")
    return dict(reads=reads, launches=la)


def xqp_phase(dev):
    """The generic solve_qp on the card on qp_car_h100.npz's canonical
    form in float64, against the stored float64 solution and the kernel
    route of solve_qp_soft."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch.ocp import assemble
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    f32, f64 = torch.float32, torch.float64
    g = np.load(QP_CAR_GOLDEN)
    names = ("H", "g", "Gh", "dh", "Gs", "lo", "hi", "zl", "zu", "Zl", "Zu")
    qp64 = tuple(torch.as_tensor(g[k], dtype=f64, device=dev) for k in names)
    H, gv, Gh, dh, Gs, lo, hi, zl, zu, Zl, Zu = qp64
    nh, nU = Gh.shape[0] // 2, gv.shape[0]
    if not torch.equal(Gh[:nh], -Gh[nh:]):
        fail("xqp: the golden's hard rows are not a two-sided box")
    canon = assemble.assemble_canonical(
        H, gv, assemble.Rows(Gh[:nh], -dh[nh:], dh[:nh]),
        assemble.Rows(Gs, lo, hi), (zl, zu, Zl, Zu))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    sol = qp_mod.solve_qp(*canon, max_iter=XQP_ITERS)
    status = int(sol.status)
    wall = time.perf_counter() - t0
    qp_cpu = tuple(a.cpu() for a in qp64)
    u_ref = torch.as_tensor(g["u_ref"], dtype=f64)
    u = sol.z[:nU].cpu()
    f_ref, _ = qp_objective(qp_cpu, u_ref)
    f_gen, viol = qp_objective(qp_cpu, u)
    scale = max(1.0, float(u_ref.abs().max()))
    dist = float((u - u_ref).abs().max())
    zero_launch_counts()
    ker = qp_mod.solve_qp_soft(*(a.to(f32) for a in qp64))
    la = launch_counts()
    f_k, _ = qp_objective(qp_cpu, ker.z.cpu())
    gap = (f_gen - f_ref) / abs(f_ref)
    print(f"[xqp] qp_car_h100 canonical (nz={canon[0].shape[0]}, "
          f"{canon[2].shape[0]} rows) through solve_qp in float64 on the "
          f"card: status {status}, {int(sol.iters)} iterations, KKT "
          f"{float(sol.gap):.3e}, {wall:.2f} s; objective {gap:.3e} from "
          f"the float64 optimum (relative, tol {XQP_OBJ_RTOL}), |u - "
          f"u_f64|inf {dist:.3e} (scale {scale:.3f}), hard rows violated "
          f"by {viol:.3e}", flush=True)
    excess = (f_k - f_gen) / abs(f_gen)
    print(f"[xqp] the kernel route of solve_qp_soft (float32, launches "
          f"{la['ipm_prepare']} prepare, {la['ipm_mehrotra']} Mehrotra): "
          f"status {int(ker.status)}, objective {excess:.3e} above "
          f"solve_qp's (relative, tol {XQP_KERNEL_EXCESS}), |u_kernel - u|inf "
          f"{float((ker.z.cpu().double() - u).abs().max()):.4f}",
          flush=True)
    if (abs(gap) > XQP_OBJ_RTOL or viol > 1e-9 * scale
            or not bool(torch.isfinite(sol.z).all())):
        fail("xqp: solve_qp on the card misses the float64 optimum")
    if int(ker.status) != 0 or excess > XQP_KERNEL_EXCESS:
        fail("xqp: the kernel route leaves solve_qp's optimum")
    if not la["ipm_prepare"] or not la["ipm_mehrotra"]:
        fail("xqp: the kernel route did not launch the IPM kernels")
    return dict(status=status, iters=int(sol.iters), wall=wall, dist=dist,
                kernel_excess=excess)


def traffic_phase(dev):
    """collective_traffic's table on the card: the blocked route and
    SHARD_PROCS processes over gloo count the same rounds and bytes."""
    import torch
    from sampling_gpmpc_torch import collective_traffic as ct
    print(f"[traffic] {ct.CONFIG} at ns={SHARD_NS}, 3 forced SQP "
          f"iterations, float32 on the card", flush=True)
    try:
        return ct.traffic(SHARD_NS, SHARD_BLOCKS, SHARD_PROCS, dev,
                          torch.float32)
    except RuntimeError as e:
        fail(f"traffic: {e}")


def bench_gp_stage(tag, spec, env, loop, dev, Xin, Uin, eps):
    """The GP-sample kernel against its plain version and the float64
    posterior's tube on one bench stage (iteration 0 at the iterate Xin,
    Uin), and its timing beside the plain version and the bound."""
    import torch
    from sampling_gpmpc_torch import agent
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ops import gp_sample
    f64 = torch.float64
    xu = sqp._linearization_inputs(spec, loop.ocp, Xin, Uin)
    Xt = xu[..., list(spec.g_idx_inputs)]
    st = agent.empty_stage_inputs(spec, loop.hyp, agent.reset_hall(loop.gp),
                                  Xt, eps, 0)
    dk = gp_sample.sample_empty_one(**st)
    dp = gp_sample.sample_empty_plain(**st)
    hyp64 = GPHyperArrays.from_spec(spec.gp, dev, f64)
    gp64 = agent.init_gp_state(spec, env, dev, f64, hyp=hyp64)
    mean64, cov64 = agent._batched_posterior_real(spec, hyp64, gp64,
                                                  Xt.to(f64))
    Ht, R = st["Kxm"].shape[1:]
    gp_report("bench", spec, f"{tag} gp_sample ns={spec.ns} Ht={Ht} R={R}",
              dk, dp, tube_width(spec, mean64[:, 0], cov64[:, 0],
                                 st["prior_var"]), mean64[:, 0], GP_REL_TOL)
    stacked = {k: (v[None] if k in gp_sample.STACKED and v is not None
                   else v) for k, v in st.items()}
    return time_gp_sample(f"bench {tag}", stacked)


def bench_phase(dev, checks, results):
    """The port's bench at full width with short windows, its rows' checks
    and launches per step; the ns = 512 chain teacher-forced on its golden
    through the kernels and the plain versions; the IPM checks and the
    timing of kernels 1-3 at ns = 64 and 512 (H = 20).  Returns the
    launches per step of each row."""
    import numpy as np
    import torch
    from sampling_gpmpc_torch import bench
    from sampling_gpmpc_torch.dempc import shift_solution
    try:
        record, rows = bench.run(dev, sizes=bench.Sizes(**BENCH_SIZES),
                                 baselines=False,
                                 trace_dir=os.path.join(HERE, "build"))
    except RuntimeError as e:
        fail(f"bench: {e}")
    print(f"[bench] line {json.dumps(record)}", flush=True)
    for name in ("ns64", "ns512", "car"):
        r = rows[name]
        print(f"[bench] {name}: {r['value']:.3f} solves/s, ms per step mean "
              f"{r['mean_ms']:.4f} median {r['median_ms']:.4f} p90 "
              f"{r['p90_ms']:.4f} over {r['steps']} steps (cold step 0 "
              f"{r['cold_ms']:.3f}); QP (nU, m_h, m_s) {r['qp_shape']}; "
              f"Mehrotra iterations per step {r['qp_iters']}; SQP "
              f"iterations {sorted(set(r['sqp_iters']))}; launches per step "
              f"{r['launches_per_step']}", flush=True)
    one = {"gp_sample": 1.0, "gp_hall": 0.0, "gp_hall_blocks": 0.0,
           "gp_hall_global": 0.0, "gp_hall_panels": 0.0, "ipm_prepare": 1.0,
           "ipm_mehrotra": 1.0, "glue_condense": 1.0, "glue_gram": 0.0,
           "glue_advance": 1.0}
    for name in ("ns64", "ns512"):
        if rows[name]["launches_per_step"] != one:
            fail(f"bench {name}: launches per step "
                 f"{rows[name]['launches_per_step']}, expected {one}")
    car = rows["car"]
    its = car["sqp_iters"][-car["steps"]:]
    want = {"gp_sample": car["steps"], "gp_hall": sum(its) - len(its),
            "gp_hall_blocks": sum(its) - len(its), "gp_hall_global": 0,
            "gp_hall_panels": 0,
            "ipm_prepare": sum(its), "ipm_mehrotra": sum(its),
            "glue_condense": sum(its), "glue_gram": 0,
            "glue_advance": sum(its)}
    if car["launches"] != want:
        fail(f"bench car: launches {car['launches']}, expected {want}")
    print(f"[bench] idle share (ns=64, 5 traced steps, busy over their "
          f"wall): {record['idle_share']}, {record['kernels_per_step']} "
          f"kernels per step", flush=True)
    if record["idle_share"] is None:
        fail("bench: no idle share")
    (gx, gu), (ix, iu) = rows["equiv"]["gp"], rows["equiv"]["ipm"]
    hall = rows["hall"]
    print(f"[bench] kernels vs plain on the ns=64 solve: GP swap max|dX| "
          f"{gx:.3e} max|dU| {gu:.3e}, glue + IPM swap {ix:.3e} / {iu:.3e} "
          f"(tol "
          f"{TF_KP_TOL_X} / {TF_KP_TOL_U}); hall stage max|dg| "
          f"{hall['dg']:.3e} = {hall['rel']:.3e} of the tube (tol "
          f"{GP_HALL_REL_TOL}), tube violation {hall['viol']:.3e}; fs "
          f"{rows['fs']['value']:.1f} sampled steps/s, non-finite "
          f"realizations {rows['fs']['nonfinite_realizations']}", flush=True)
    if max(gx, ix) > TF_KP_TOL_X or max(gu, iu) > TF_KP_TOL_U:
        fail("bench: a kernel route disagrees with the plain route")
    if hall["rel"] > GP_HALL_REL_TOL or hall["viol"] > 0.0:
        fail("bench: the hall kernel against its plain version")
    if rows["fs"]["nonfinite_realizations"] > 1:
        fail("bench: forward sampling")

    # the ns = 512 chain, teacher-forced on its golden
    g = np.load(BENCH_GOLDEN)
    n = int(g["steps"])
    _, spec, data, env = bench.build(dict(ns=int(g["ns"]), H=int(g["H"])))
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    loops = {r: bench.ClosedLoop(spec, data, env, dev)
             for r in ("kernels", "plain")}
    X0, U0 = loops["kernels"].X, loops["kernels"].U
    bar = (ENV_FACTOR * float(g["f32_dX"].max()),
           ENV_FACTOR * float(g["f32_dU"].max()))
    dev_err = {r: [] for r in loops}
    kp, qps = [], []
    for m in range(n):
        Xin, Uin = (X0, U0) if m == 0 else shift_solution(
            T(g["X"][m - 1]), T(g["U"][m - 1]))
        sts = {}
        for route, loop in loops.items():
            loop.x, loop.X, loop.U = T(g["x"][m]), Xin, Uin
            with (plain_route() if route == "plain" else
                  captured_qps(qps)):
                sts[route] = st = loop.step(T(g["eps"][m]))
            try:
                loop.check(st, f"bench ns=512 teacher-forced step {m} "
                               f"({route})")
            except RuntimeError as e:
                fail(str(e))
            dev_err[route].append(
                (float(np.abs(st.X.cpu().numpy() - g["X"][m]).max()),
                 float(np.abs(st.U.cpu().numpy() - g["U"][m]).max())))
        kp.append((float(torch.max(torch.abs(sts["kernels"].X
                                             - sts["plain"].X))),
                   float(torch.max(torch.abs(sts["kernels"].U
                                             - sts["plain"].U)))))
    for route, e in dev_err.items():
        print(f"[bench] ns=512 teacher-forced {n} steps ({route}) vs the "
              f"float64 golden: max|dX| {max(v[0] for v in e):.4e} max|dU| "
              f"{max(v[1] for v in e):.4e} (bars {bar[0]:.4f} / {bar[1]:.4f}"
              f" = {ENV_FACTOR} x the JAX float32 path's); per step "
              f"{[(f'{a:.1e}', f'{b:.1e}') for a, b in e]}", flush=True)
    print(f"[bench] ns=512 teacher-forced, kernels vs plain: max|dX| "
          f"{max(v[0] for v in kp):.4e} max|dU| {max(v[1] for v in kp):.4e}"
          f"; per step {[(f'{a:.1e}', f'{b:.1e}') for a, b in kp]}",
          flush=True)
    for e in list(dev_err.values()) + [kp]:
        if max(v[0] for v in e) > bar[0] or max(v[1] for v in e) > bar[1]:
            fail("bench ns=512 teacher-forced chain outside its bar")

    # the IPM checks and kernels 1-3 at ns = 64 and 512, cold and warm
    _, spec64, data64, env64 = bench.build()
    loop64 = bench.ClosedLoop(spec64, data64, env64, dev)
    eps64 = bench.draws(spec64, 6, spec64.seed, dev)
    qps64 = []
    with captured_qps(qps64):
        for m in range(6):
            loop64.check(loop64.step(eps64[m]), f"bench ns=64 step {m}")
    shapes = (("ns64", qps64, True), ("ns512", qps, False))
    for tag, qs, resident in shapes:
        for label, (qa, ws, wv) in (("cold, step 0", qs[0]),
                                    ("warm, step 5", qs[5])):
            p, d = checks.report(f"bench {tag} {label}", qa, ws, wv,
                                 resident=resident)
            results["ipm_prepare"]["max_abs_err"] = max(
                results["ipm_prepare"]["max_abs_err"], p)
            results["ipm_mehrotra"]["max_abs_err"] = max(
                results["ipm_mehrotra"]["max_abs_err"], d)
            prep_t, mehr_t = checks.timing(f"bench {tag} {label}", qa, ws,
                                           wv)
            key = f"bench_{tag}" + ("_warm" if label.startswith("w") else "")
            results["ipm_prepare"][key] = prep_t
            results["ipm_mehrotra"][key] = mehr_t
    Xw, Uw = shift_solution(T(g["X"][4]), T(g["U"][4]))
    results["gp_sample"]["bench_ns512"] = bench_gp_stage(
        "ns512", spec, env, loops["kernels"], dev, Xw, Uw, T(g["eps"][5, 0]))
    results["gp_sample"]["bench_ns64"] = bench_gp_stage(
        "ns64", spec64, env64, loop64, dev, loop64.X, loop64.U, eps64[5, 0])
    return {name: rows[name]["launches_per_step"]
            for name in ("ns64", "ns512", "car")}


# the glue kernel against its plain version: float32 rounding of the
# condensing's sums of products in two association orders (stage by stage
# against prefix compositions) and of the cost's sums in two orders
GLUE_RTOL = 1e-4
# every config whose solve reaches sqp._assemble on the card, as published
GLUE_CONFIGS = (("params_pendulum1D_samples", 70), ("params_pendulum", 20),
                ("params_car", 20), ("params_car_residual", 1),
                ("params_car_samples", 10), ("params_pendulum_samples", 500))


def glue_bound(spec):
    """Bytes and float32 operations of one glue launch: the rows, the
    iterate and the OCP data read once, the QP tuple, T and Gamma written
    once (the workspace stays out: it is the kernel's own); the
    condensing's, the cost's and the rows' products."""
    from sampling_gpmpc_torch.ocp.assemble import row_counts
    from sampling_gpmpc_torch.ops import glue
    ns, H, nx, nu = spec.ns, spec.H, spec.nx, spec.nu
    nU = H * nu
    shapes = glue.layout(spec, row_counts(spec))[2][:13]
    out = sum(glue._numel(s) for s in shapes)
    inp = (ns * H * nx * (1 + nx + nu) + (H + 1) * ns * nx + H * nu + nx
           + 3 * nx * nx + nu * nu + 4 * (H + 1) * nx + 2 * H * nu + ns
           + nu * nx + 5 * spec.n_ellipses)
    flops = 0
    for k in range(H + 1):
        kn = k * nu
        flops += ns * (2 * nx * nx * (kn + nu + 1)      # the recursion
                       + 2 * nx * nx * kn                # Hx Gamma
                       + nx * kn * (kn + 1)              # Gamma' Hx Gamma
                       + 2 * nx * nu * nU)               # feedback rows
    return 4 * (inp + out), flops


def glue_phase(dev):
    """Phase 30 (module docstring).  Returns the kernel's results for the
    report."""
    import torch
    from sampling_gpmpc_torch import bench
    from sampling_gpmpc_torch.microbench_linalg import cuda_ms
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.assemble import (assemble_iteration,
                                                   condensed_qp, row_counts)
    from sampling_gpmpc_torch.ops import glue
    from sampling_gpmpc_torch.parallel.worker import glue_inputs, problem
    names = sqp.QP_KEYS + ("T", "Gamma")

    def rel_err(got, ref, config, branch):
        errs = {}
        for name, a, b in zip(names, (*got[0], *got[1:]),
                              (*ref[0], *ref[1:])):
            big = b.abs() >= 1e7
            if not torch.isfinite(a).all() or not torch.equal(a[big],
                                                              b[big]):
                fail(f"glue {config} ({branch}): {name} non-finite or its "
                     "1e8 bounds differ")
            if (~big).any():
                errs[name] = float((a - b)[~big].abs().max()) / max(
                    float(b[~big].abs().max()), 1e-30)
        worst = max(errs, key=errs.get)
        if errs[worst] > GLUE_RTOL:
            fail(f"glue {config} ({branch}): kernel disagrees with its "
                 f"plain version in {worst}")
        return worst, errs[worst]

    worst, flagship, by_config = 0.0, None, {}
    for config, ns in GLUE_CONFIGS:
        args = glue_inputs(config, ns, dev, torch.float32)[0]
        spec, rows = args[0], row_counts(args[0])
        smem, gram = glue.layout(spec, rows)[:2]
        got = condensed_qp(*args)
        again = condensed_qp(*args)
        ref = assemble_iteration(*args)
        torch.cuda.synchronize()
        for name, a, c in zip(names, (*got[0], *got[1:]),
                              (*again[0], *again[1:])):
            if not torch.equal(a, c):
                fail(f"glue {config}: two launches differ in {name}")
        name, rel = rel_err(got, ref, config, "its branch")
        try:                            # the branch the shape does not pick
            glue.layout(spec, rows, not gram)
            other = glue.launch(spec, rows, *args[1:], gram=not gram)
            o_name, o_rel = rel_err(other, ref, config, "other branch")
        except ValueError:              # its sums do not fit: not taken
            other = None
        branch = "Gram launch" if gram else "sums in shared memory"
        print(f"[glue] {config} (ns={ns}, H={spec.H}, nx={spec.nx}, nU="
              f"{spec.H * spec.nu}, m_h={ref[0][2].shape[0]}, m_s="
              f"{ref[0][4].shape[0]}; {branch}, {smem} B shared): "
              f"max|kernel - plain| / max|plain| by output {name} "
              f"{rel:.3e}" + ("" if other is None else
                              f"; other branch {o_name} {o_rel:.3e}")
              + f" (bar {GLUE_RTOL}); two launches bit for bit", flush=True)
        worst = max(worst, rel)
        flagship = flagship or args

        # device ms: the shape's branch, the other one, the plain version
        t_k = cuda_ms(lambda: condensed_qp(*args))
        t_o = None if other is None else cuda_ms(
            lambda: glue.launch(spec, rows, *args[1:], gram=not gram))
        t_p = cuda_ms(lambda: assemble_iteration(*args), n=10, warm=2, k=1)
        nb, fl = glue_bound(spec)
        b, by = bound_ms(nb, fl)
        by_config[config] = dict(ns=ns, H=spec.H, nU=spec.H * spec.nu,
                                 gram=gram, ms=t_k, other_branch_ms=t_o,
                                 plain_ms=t_p, bound_ms=b, bound_by=by,
                                 max_rel_err=rel)
        print(f"[timing] glue {config}: {t_k:.4f} ms ({branch}), other "
              f"branch " + ("does not fit" if t_o is None else
                            f"{t_o:.4f} ms") + f", plain {t_p:.4f} ms "
              f"(host-bound: its ops' launches); bound {b:.6f} ms ({by}: "
              f"{nb} B, {fl:.3e} flop)", flush=True)

    # one launch per SQP iteration on the main path; the Gram launch only
    # past GRAM_NU
    spec, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_car", 20, 4, dev, torch.float32)
    zero_launch_counts()
    s = sqp.solve(spec, env, hyp, ocp, st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    car = launch_counts()
    _, spec_b, data_b, env_b = bench.build(dict(ns=70, H=17))
    draws = bench.draws(spec_b, 5, 7, dev)
    loop = bench.ClosedLoop(spec_b, data_b, env_b, dev)
    zero_launch_counts()
    its = 0
    for m in range(5):
        its += loop.step(draws[m]).it
    torch.cuda.synchronize()
    pend = launch_counts()
    spec_r, env, hyp, ocp, gp, X0, U0, st, eps = problem(
        "params_car_residual", 1, 3, dev, torch.float32)
    zero_launch_counts()
    s_r = sqp.solve(spec_r, env, hyp, ocp, st, X0, U0, gp, eps)
    torch.cuda.synchronize()
    res = launch_counts()
    print(f"[glue] launches (glue_condense, glue_gram): params_car solve "
          f"{car['glue_condense']}, {car['glue_gram']} in {s.it} SQP "
          f"iterations; 5 params_pendulum1D_samples steps "
          f"{pend['glue_condense']}, {pend['glue_gram']} in {its}; "
          f"params_car_residual {res['glue_condense']}, {res['glue_gram']} "
          f"in {s_r.it}", flush=True)
    print(f"[advance] launches (glue_advance): params_car solve "
          f"{car['glue_advance']} in {s.it} SQP iterations; 5 params_"
          f"pendulum1D_samples steps {pend['glue_advance']} in {its}; "
          f"params_car_residual {res['glue_advance']} in {s_r.it}",
          flush=True)
    if (car["glue_condense"], car["glue_gram"]) != (s.it, 0) or \
            (pend["glue_condense"], pend["glue_gram"]) != (its, 0) or \
            (res["glue_condense"], res["glue_gram"]) != (s_r.it, s_r.it):
        fail("glue: not one launch per SQP iteration on the main path")
    if (car["glue_advance"], pend["glue_advance"], res["glue_advance"]) != \
            (s.it, its, s_r.it):
        fail("advance: not one launch per SQP iteration on the main path")

    # the wrapper's host time a call at the flagship's shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        condensed_qp(*flagship)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    print(f"[timing] glue wrapper's host time {host_ms:.4f} ms a call "
          f"(params_pendulum1D_samples)", flush=True)
    flag = by_config[GLUE_CONFIGS[0][0]]
    return dict(max_abs_err=worst, err_relative_to="each output's max "
                "|plain|, the 1e8 bounds held exactly", ms=flag["ms"],
                plain_ms=flag["plain_ms"], bound_ms=flag["bound_ms"],
                bound_by=flag["bound_by"], library_ms=None,
                host_ms_per_call=host_ms, by_config=by_config,
                launches_car_solve=car["glue_condense"],
                launches_pendulum_steps=pend["glue_condense"],
                launches_car_residual=(res["glue_condense"],
                                       res["glue_gram"]))


# the step's consumption against the torch chain it replaces (consume_step
# on the candidate): float32 rounding of the norms' sums in two orders; the
# iterate within the float32 bound of a dot of nU terms (gamma_n = n u) for
# each of the two orders, on the magnitude of what is summed
ADVANCE_NORM_RTOL = 1e-6


def advance_bound(spec):
    """Bytes and float32 operations of one advance launch: Gamma, T, the
    iterate and dU read once, the new iterate written once (the scalars
    aside); the row dots, the candidate and the four squared norms."""
    rows = spec.ns * (spec.H + 1) * spec.nx
    nU = spec.H * spec.nu
    return 4 * (rows * nU + 3 * rows + 3 * nU), 2 * rows * nU + 6 * rows \
        + 6 * nU


def advance_phase(dev):
    """Phase 31 (module docstring).  Returns the kernel's results for the
    report."""
    import torch
    from sampling_gpmpc_torch.microbench_linalg import cuda_ms
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.assemble import condensed_qp
    from sampling_gpmpc_torch.ocp.qp import QPSolution
    from sampling_gpmpc_torch.ops import glue
    from sampling_gpmpc_torch.parallel.worker import glue_inputs
    i32, f32 = torch.int32, torch.float32
    by_config, worst, flagship = {}, 0.0, None
    for config, ns in GLUE_CONFIGS:
        args = glue_inputs(config, ns, dev, f32)[0]
        spec, X, U = args[0], args[3], args[4]
        _, T, Gamma = condensed_qp(*args)
        g = torch.Generator().manual_seed(ns)
        z = (0.5 * torch.randn(spec.H * spec.nu, generator=g)).to(dev)
        # a solve's first step, and a stalled one (alpha halves: both
        # passes of the kernel run)
        for label, best, stall in (("first", float("inf"), 0),
                                   ("stall", 0.0, sqp.STALL_WINDOW - 1)):
            ins = (X, U, T, Gamma, z, torch.tensor(0, device=dev),
                   torch.tensor(9, dtype=i32, device=dev),
                   torch.tensor(best, dtype=f32, device=dev),
                   torch.tensor(stall, dtype=i32, device=dev),
                   torch.zeros((), dtype=i32, device=dev),
                   torch.ones((), dtype=f32, device=dev),
                   torch.tensor(31, dtype=i32, device=dev))
            got = glue.advance(spec, *ins, sqp.STALL)
            again = glue.advance(spec, *ins, sqp.STALL)
            ok = ins[5] == 0
            ref = sqp.consume_step(
                spec, X, U, *sqp.candidate(spec, X, U, T, Gamma, z), ok,
                *ins[7:11]) + (ok, ins[11] + ins[6])
            terms = T.abs() + torch.einsum("ikau,u->ika", Gamma.abs(),
                                           z.abs())
            scale = {"X": float((X.abs() + terms.transpose(0, 1)).max()),
                     "U": float((U.abs() + z.abs().reshape(U.shape)).max())}
            gamma = 2 * (spec.H * spec.nu + 2) * 2.0 ** -24
            torch.cuda.synchronize()
            errs = {}
            for name, a, b, c in zip(glue.ADVANCE_OUTPUTS, got, ref, again):
                if not torch.equal(a, c):
                    fail(f"advance {config}: two launches differ in {name}")
                if a.shape != b.shape or a.dtype != b.dtype:
                    fail(f"advance {config}: {name} {a.dtype} "
                         f"{tuple(a.shape)} against {b.dtype} "
                         f"{tuple(b.shape)}")
                if name in ("X", "U"):
                    errs[name] = float((a - b).abs().max()) / max(
                        scale[name], 1e-30)
                    if errs[name] > gamma:
                        fail(f"advance {config} ({label}): {name} off by "
                             f"{errs[name]:.3e} of its terms' scale")
                elif name in ("x_diff", "u_diff", "best_step"):
                    errs[name] = abs(float(a) - float(b)) / max(
                        abs(float(b)), 1e-30)
                    if errs[name] > ADVANCE_NORM_RTOL:
                        fail(f"advance {config} ({label}): {name} "
                             f"{float(a)!r} against {float(b)!r}")
                elif not torch.equal(a, b):
                    fail(f"advance {config} ({label}): {name} {a} against "
                         f"{b}")
            if label == "stall" and float(got[8]) != 0.5:
                fail(f"advance {config}: the stall branch left alpha "
                     f"{float(got[8])}")
            w = max(errs.values())
            worst = max(worst, w)
            print(f"[advance] {config} (ns={ns}, H={spec.H}, nx={spec.nx}, "
                  f"nU={spec.H * spec.nu}; {label}): largest relative "
                  f"difference from the torch chain {w:.3e} (X, U to "
                  f"{gamma:.2e} of their terms, norms to "
                  f"{ADVANCE_NORM_RTOL}); "
                  f"counters, alpha, done, qp_valid, qp_iters equal; two "
                  f"launches bit for bit", flush=True)
        # device ms: the kernel alone; sqp._advance on each route, the
        # plain one (the torch chain) through plain_route(glue=True)
        st = sqp.SolveState(
            X=X, U=U, X_prev=X, U_prev=U, gp=None, it=0, status=ins[5],
            done=ok, qp_ws=(), qp_valid=ok, qp_iters=ins[11],
            qp_gap=ins[10], best_step=ins[7], stall_count=ins[8],
            mono_count=ins[9], alpha=ins[10])
        sol = QPSolution(z=z, lam=None, s=None, iters=ins[6],
                         status=ins[5], gap=ins[10], state=())
        t_k = cuda_ms(lambda: glue.advance(spec, *ins, sqp.STALL))
        t_r = cuda_ms(lambda: sqp._advance(spec, st, T, Gamma, None, sol))
        with plain_route(gp=False, qp=False, glue=True):
            zero_launch_counts()
            t_p = cuda_ms(lambda: sqp._advance(spec, st, T, Gamma, None,
                                               sol), n=10, warm=2, k=1)
            if launch_counts()["glue_advance"]:
                fail("advance: launched under plain_route(glue=True)")
        nb, fl = advance_bound(spec)
        b, by = bound_ms(nb, fl)
        by_config[config] = dict(ns=ns, H=spec.H, nU=spec.H * spec.nu,
                                 ms=t_k, route_ms=t_r, plain_ms=t_p,
                                 bound_ms=b, bound_by=by, max_rel_err=w)
        print(f"[timing] advance {config}: {t_k:.4f} ms (sqp._advance on "
              f"the kernel route {t_r:.4f}), plain {t_p:.4f} ms (the torch "
              f"chain, host-bound); bound {b:.6f} ms ({by}: {nb} B, "
              f"{fl:.3e} flop)", flush=True)
        flagship = flagship or (spec, ins)

    # the wrapper's host time a call at the flagship's shape
    spec, ins = flagship
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        glue.advance(spec, *ins, sqp.STALL)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    print(f"[timing] advance wrapper's host time {host_ms:.4f} ms a call "
          f"(params_pendulum1D_samples)", flush=True)
    flag = by_config[GLUE_CONFIGS[0][0]]
    return dict(max_abs_err=worst, err_relative_to="X and U: their terms' "
                "largest magnitude; x_diff, u_diff, best_step: their own "
                "value",
                ms=flag["ms"], plain_ms=flag["plain_ms"],
                bound_ms=flag["bound_ms"], bound_by=flag["bound_by"],
                library_ms=None, host_ms_per_call=host_ms,
                by_config=by_config)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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

    # the plain route and the launch counters the phases share with the bench
    global plain_route, launch_counts, wide_launch_counts, zero_launch_counts
    from sampling_gpmpc_torch.ops.routes import (launch_counts, plain_route,
                                                 wide_launch_counts,
                                                 zero_launch_counts)
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
    card = setup.card_line()
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
    # the kernels, and through their plain versions (every stage held plain
    # by plain_route()).  Both share the float32 QP exit, so the per-step
    # difference isolates the kernels; the f64 oracle bounds both.
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
    if not_launched(launches_car):
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
        row = dict(nh=nh, ms=t_k, ms_one_output=t_1, plain_ms=t_p,
                   bound_ms=b, bound_by=by, bound_ms_one_output=b1,
                   partial_library_ms=t_chol)
        pts = walk["points"].get(nh)
        if pts is not None:
            # the main path's call: the blocks kernel, then the launch set
            blk = [pts[k] for k in HALL_BLOCK_ARGS]
            t_pts = cuda_ms(lambda: gp_hall.sample_hall_points(**pts))
            t_blk = cuda_ms(lambda: gp_hall.hall_blocks(nh, *blk,
                                                        ty=pts["ty"]))
            b_blk, _ = bound_ms(hall_blocks_bytes(pts), 0)
            print(f"[timing] gp_hall nh={nh} from the points (one call: "
                  f"hall_blocks_kernel + the launch set) {t_pts:.4f} ms; "
                  f"hall_blocks_kernel alone {t_blk:.4f} ms (bound "
                  f"{b_blk:.5f} ms, bytes: {hall_blocks_bytes(pts)} B)",
                  flush=True)
            row.update(ms_points=t_pts, blocks_ms=t_blk,
                       blocks_bound_ms=b_blk)
        hall_rows.append(row)
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
        dev_ms = hall_kernel_ms(lambda: gp_hall.sample_hall(**st))
        print(f"[timing] gp_hall 2D pendulum, seeded, nh={nh} (no={no}, "
              f"ns={ns}, Ht={Ht}, Rr={Rr}, Rh={st['Kxh'].shape[-1]}; factor "
              f"tiles in {branch} memory, {gp_hall.hall_panels(Ht, nh)} panel "
              f"steps): all {no} outputs in one launch set {t_k:.4f} ms "
              f"(bound {b:.5f} ms, {by}), plain {t_p:.4f} ms; device ms by "
              f"kernel {dev_ms}", flush=True)
        f1_hall.append(dict(nh=nh, tiles=branch, ms=t_k, plain_ms=t_p,
                            bound_ms=b, bound_by=by, kernel_ms=dev_ms))
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

    # ==== wide QPs (128 < nU <= 256: the IPM kernels' wide builds) ========
    # ---- 16. the wide builds on seeded QPs ------------------------------
    phase("wide")
    wide = wide_phase(dev, checks)
    # ---- 17. params_car_samples' committed QP in float32 ----------------
    phase("qp_car_h100")
    qp_car = qp_car_phase(dev, checks)
    # ---- 18. params_car_samples at full width ---------------------------
    phase("car_samples")
    car_s = car_samples_phase(dev, checks)
    # ---- 19. the approximate drone MPC ----------------------------------
    phase("drone")
    drone = drone_phase(dev, checks)
    # ---- 20. the recorded (debug) SQP solve -----------------------------
    phase("debug")
    debug = debug_phase(dev)
    # ---- 21. the design tools in float64 --------------------------------
    phase("tools")
    tools_phase(dev)
    # ---- 22. the sample-sharded solve ------------------------------------
    phase("shard")
    launches_shard = shard_phase(dev)
    # ---- 23.-28. the evaluation side --------------------------------------
    phase("gt")
    gt_phase(dev)
    phase("baselines")
    baselines_phase(dev)
    phase("band")
    band = band_phase(dev)
    phase("mean")
    mean = mean_phase(dev)
    phase("xqp")
    xqp_phase(dev)
    phase("traffic")
    traffic_phase(dev)
    # ---- 29. the port's bench --------------------------------------------
    phase("bench")
    bench_launches = bench_phase(dev, checks, results)

    # ==== the condensing and assembly kernel ===============================
    phase("glue")
    glue_res = glue_phase(dev)
    phase("advance")
    advance_res = advance_phase(dev)
    results["gp_sample"]["car_samples"] = car_s["timing"]["gp_sample"]
    results["gp_hall"]["car_samples_by_fill"] = car_s["timing"]["gp_hall"]
    results["ipm_prepare"]["drone_pessimistic"] = \
        drone["pessimistic"]["timing"][0]
    results["ipm_mehrotra"]["drone_pessimistic"] = \
        drone["pessimistic"]["timing"][1]
    (cs_prep, cs_mehr), (cs_prep_w, cs_mehr_w) = car_s["timing"]["ipm"]
    wide_errs = (wide["errs"] + car_s["errs"]
                 + drone["optimistic"]["errs"])
    wide_results = {
        "ipm_prepare_wide": dict(
            cs_prep, max_abs_err=max(e[0] for e in wide_errs),
            err_relative_to="each field's max |plain|", library_ms=None,
            car_samples_warm=cs_prep_w,
            drone_optimistic=drone["optimistic"]["timing"][0],
            seeded={k: v[0] for k, v in wide["timing"].items()},
            qp_car_h100_rel_err=qp_car["rel_prep"]),
        "ipm_mehrotra_wide": dict(
            cs_mehr, max_abs_err=max(e[1] for e in wide_errs),
            max_abs_err_seeded=max(e[1] for e in wide["errs"]),
            library_ms=None, car_samples_warm=cs_mehr_w,
            drone_optimistic=drone["optimistic"]["timing"][1],
            seeded={k: v[1] for k, v in wide["timing"].items()},
            qp_car_h100=qp_car["read"])}

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
            "launches_car_samples": car_s["launches"][name],
            # of them on the factor's global-tile branch (the hall stage)
            **({"launches_global_car": launches_car["gp_hall_global"],
                "launches_global_car_samples":
                    car_s["launches"]["gp_hall_global"],
                "panel_steps_car": launches_car["gp_hall_panels"],
                "panel_steps_car_samples":
                    car_s["launches"]["gp_hall_panels"]}
               if name == "gp_hall" else {}),
            "launches_drone_pessimistic":
                drone["pessimistic"]["launches"][name],
            "launches_drone_optimistic":
                drone["optimistic"]["launches"][name],
            "launches_debug_recorded": debug["launches"][name],
            # the blocked flagship at 3 SQP iterations, all blocks: the
            # sharded route (IPM kernels off under the group, as in JAX)
            "launches_shard_blocked": launches_shard[name],
            # the float32 status band's three closed loops (phase band) and
            # the mean route's solve (phase mean: no GP kernel, as in JAX)
            "launches_status_band": band["launches"][name],
            "launches_mean_route": mean["launches"][name],
            # the bench's rows (phase bench): launches per timed step
            "launches_per_step_bench": {row: v[name] for row, v in
                                        bench_launches.items()},
            **{k: r[k] for k in keys},
            **{k: v for k, v in r.items() if k not in keys}})
    # the IPM kernels' wide builds: launches of the car_samples step (its
    # main path runs them alone) and of the drone's optimistic loop
    for name in ("ipm_prepare", "ipm_mehrotra"):
        r = wide_results[f"{name}_wide"]
        kernels.append({
            "name": f"{name}_wide", "route": "cuda",
            "source": "sampling_gpmpc_torch/csrc/ipm.cu",
            "build": "IPM_WIDE=1 (libraries ipm_wide, ipm_hard_wide)",
            "replaces": meta[name][1],
            "launches": car_s["wide"][name],
            "launches_drone_optimistic": drone["optimistic"]["wide"][name],
            **{k: r[k] for k in keys},
            **{k: v for k, v in r.items() if k not in keys}})
    # the glue kernel: replaces no TPU kernel (XLA fused the chain there)
    kernels.append({
        "name": "glue_condense", "route": "cuda",
        "source": "sampling_gpmpc_torch/csrc/glue.cu",
        "replaces": "none: sampling_gpmpc_tpu/ocp/condense.py and "
                    "ocp/assemble.py, fused by XLA",
        "launches": launches_car["glue_condense"],
        "launches_pendulum": launches_pend["glue_condense"],
        **{k: glue_res[k] for k in keys},
        **{k: v for k, v in glue_res.items() if k not in keys}})
    kernels.append({
        "name": "glue_advance", "route": "cuda",
        "source": "sampling_gpmpc_torch/csrc/glue.cu",
        "replaces": "none: the JAX package leaves the step "
                    "(sampling_gpmpc_tpu/ocp/sqp.py) to XLA",
        "launches": launches_car["glue_advance"],
        "launches_pendulum": launches_pend["glue_advance"],
        **{k: advance_res[k] for k in keys},
        **{k: v for k, v in advance_res.items() if k not in keys}})
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
