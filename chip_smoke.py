#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``sampling_gpmpc_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. build   — compile every CUDA kernel (one nvcc per source, in parallel)
             and print the card's name and power limit;
2. gp      — the GP-sample kernel vs its plain torch version on the inputs
             of SQP iteration 0 of params_pendulum1D_samples (ns=70, H=17),
             held by the tube criterion |y - mu| <= beta (sigma + sigma_n)
             and pointwise to the plain version within 1e-3 of the tube;
3. ipm     — on the first QP of that solve and on a warm-started later QP:
             the whole kernel solve vs the plain solver, the prepare
             kernel's every output vs prepare_plain, and the Mehrotra kernel
             vs the plain loop on the same prepared problem;
4. loop    — the closed loop on cuda float32 with the stored oracle's
             epistemic draws: 20 teacher-forced steps, each through the
             kernels and through their plain versions, against each other
             and against tests/goldens/oracle_pendulum1d_flagship.npz; then
             20 free-running steps (DEMPC.run, the main path) with the
             kernels' launch counters read around it;
5. timing  — each kernel at the main path's shapes (CUDA events, warm,
             median) beside its plain version and its bound;
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
NOISE_REL = 1e-3               # f32 posterior-variance cancellation floor
# GP kernel vs its plain version, pointwise, as a share of the tube width
# beta (sigma + sigma_n) there: float32 rounding of the same algorithm is
# ~1e-7 of it; a dropped eps or a wrong factor moves a draw by O(1) of it.
GP_REL_TOL = 1e-3
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


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


@contextlib.contextmanager
def plain_route(gp_sample, ipm):
    """Swap the kernel wrappers the main path calls for their plain torch
    versions (same arguments, same results), to run a reference solve on
    the same device; restored on exit."""
    saved = gp_sample.sample_empty_one, ipm.run_full
    gp_sample.sample_empty_one = gp_sample.sample_empty_plain
    ipm.run_full = ipm.run_full_plain
    try:
        yield
    finally:
        gp_sample.sample_empty_one, ipm.run_full = saved


def cuda_ms(fn, n=30, warm=3):
    """Median milliseconds of fn() between CUDA events (warm)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


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
    from sampling_gpmpc_torch.gp import exact
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    from sampling_gpmpc_torch.ops import build, gp_sample, ipm

    dev = setup.resolve_device("cuda")
    f32, f64 = torch.float32, torch.float64
    results = {}

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    card = gpu_line()
    print(f"[build] {len(logs)} sources in {build_s:.1f} s "
          f"(nvcc {' '.join(build.FLAGS)})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    print(f"[card] {card}", flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    # ---- problem at full width ------------------------------------------
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
    eps_all = torch.as_tensor(g["eps"], dtype=f32, device=dev)
    pX, pU, phys = g["plan_X_traj"], g["plan_U_traj"], g["physical_state_traj"]
    st0 = torch.as_tensor(phys[0], dtype=f32, device=dev)
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
    rf64 = {k: v[0] for k, v in gp64.real_fact.items()}
    mean64, cov64 = exact.predict_real(Xt.to(f64), gp64.real_Z, rf64,
                                       hyp64.lengthscale[0],
                                       hyp64.outputscale[0], True)
    var64 = torch.clamp(torch.diagonal(cov64, dim1=-2, dim2=-1), min=0.0)
    sig_n = torch.sqrt(NOISE_REL * gp_in["prior_var"].to(f64))
    tube = spec.gp.beta * (torch.sqrt(var64) + sig_n)
    viol_k = int((torch.abs(dg_k.to(f64) - mean64) > tube).sum())
    viol_p = int((torch.abs(dg_p.to(f64) - mean64) > tube).sum())
    gp_err = float(torch.max(torch.abs(dg_k - dg_p)))
    # the kernel clips its own draws into the tube, so the tube alone cannot
    # fail a wrong factor or a dropped eps: also hold the kernel to its plain
    # version pointwise, relative to the tube's width there
    gp_rel = float(torch.max(torch.abs(dg_k - dg_p).to(f64) / tube))
    finite = bool(torch.isfinite(dg_k).all())
    print(f"[gp] ns={spec.ns} Ht={spec.H * spec.Ty} "
          f"R={gp_in['Kxm'].shape[-1]}: max|dg kernel - plain| = {gp_err:.3e}"
          f" = {gp_rel:.3e} of the tube width (tol {GP_REL_TOL}); "
          f"tube violations kernel={viol_k} plain={viol_p} of {dg_k.numel()}; "
          f"finite={finite}", flush=True)
    if viol_k or viol_p or not finite:
        fail("GP-sample kernel outside the tube or non-finite")
    if gp_rel > GP_REL_TOL:
        fail("GP-sample kernel disagrees with its plain version")
    results["gp_sample"] = {"max_abs_err": gp_err}

    # ---- 3. IPM kernels vs plain ----------------------------------------
    tol, reg = 3e-5, 1e-7
    consts = (qp_mod.STALL_ITERS, qp_mod.STALL_RTOL, qp_mod.MU_GRIND)

    def solve_pair(qp_args, ws, wv):
        qp_args = tuple(a.contiguous() for a in qp_args)
        k = qp_mod._finish(*ipm.run_full(*qp_args, ws, wv, tol, reg, 150,
                                         *consts, qp_mod.WS_BAND), tol)
        p = qp_mod._finish(*ipm.run_full_plain(*qp_args, ws, wv, tol, reg,
                                               150, *consts, qp_mod.WS_BAND),
                           tol)
        ex = qp_mod._finish(*ipm.run_full_plain(
            *[a.to(f64) for a in qp_args],
            None if ws is None else tuple(a.to(f64) for a in ws), wv,
            1e-12, 1e-13, 150, *consts, qp_mod.WS_BAND), 1e-12)
        return k, p, ex

    def prepare_report(label, qp_args, ws, wv):
        """The prepare kernel's every output against prepare_plain's on the
        same inputs, each relative to the field's own largest magnitude;
        and which start each took (the kernel keeps its cold candidate in
        the head of its scratch buffer)."""
        qp_args = tuple(a.contiguous() for a in qp_args)
        m_h = qp_args[3].shape[0]
        d = ipm.prepare(*qp_args, ws, wv, qp_mod.WS_BAND)
        p = ipm.prepare_plain(*qp_args, ws, wv, qp_mod.WS_BAND)
        cold = ipm.prepare_plain(*qp_args, None, None, qp_mod.WS_BAND).st0
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

    def as_prepared(d):
        """The prepare kernel's outputs as the plain loop's input."""
        h, s = d.h0, d.s0
        st = (torch.zeros_like(d.g), s[2], s[3], h[0], h[1], s[0], s[4], s[1],
              s[5], s[6], s[7])
        return ipm.Prepared(d.H, d.g, d.Gth.T, d.dh[0], d.Gts.T, *d.sd[:6],
                            d.qs[0], st, d.sch, d.scs)

    def ipm_report(label, qp_args, ws, wv):
        # the whole solve: kernels, plain f32, plain f64
        k, p, ex = solve_pair(qp_args, ws, wv)
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
        # each kernel alone: prepare against prepare_plain, then the loop
        # kernel against the plain loop on the prepare kernel's outputs
        rel_prep, d = prepare_report(label, qp_args, ws, wv)
        pk = as_prepared(d)
        bk, rk, ik = ipm.mehrotra(d, tol, reg, 150, *consts)
        bp, rp, ip = ipm.mehrotra_plain(pk, tol, reg, 150, *consts)
        du_m = float(torch.max(torch.abs(bk[0] - bp[0])))
        print(f"[ipm] mehrotra {label} on the same prepared problem: "
              f"|du kernel - plain|inf = {du_m:.3e} (bound {bound:.3e}); "
              f"kkt {float(rk):.3e}/{float(rp):.3e}; iters "
              f"{int(ik)}/{int(ip)}", flush=True)
        stat_tol = tol * qp_mod.STATUS_RTOL
        if du_m > bound or float(rk) > stat_tol or float(rp) > stat_tol:
            fail(f"IPM Mehrotra kernel {label}")
        return rel_prep, du_m

    qp0, _, _, _ = sqp.assemble_qp(spec, env, hyp, ocp, st0, X0, U0,
                                   agent.reset_hall(gp0), eps_all[0, 0],
                                   hall_empty=True)
    prep0, du0 = ipm_report("cold, step 0", qp0, None, None)
    # warm start: solve teacher-forced step m-1, carry its state into m
    m = 10
    Xa, Ua = shift_solution(torch.as_tensor(pX[m - 2], dtype=f32, device=dev),
                            torch.as_tensor(pU[m - 2], dtype=f32, device=dev))
    sa = sqp.solve(spec, env, hyp, ocp,
                   torch.as_tensor(phys[m - 1], dtype=f32, device=dev),
                   Xa, Ua, gp0, eps_all[m - 1])
    Xb, Ub = shift_solution(torch.as_tensor(pX[m - 1], dtype=f32, device=dev),
                            torch.as_tensor(pU[m - 1], dtype=f32, device=dev))
    qpm, _, _, _ = sqp.assemble_qp(
        spec, env, hyp, ocp, torch.as_tensor(phys[m], dtype=f32, device=dev),
        Xb, Ub, agent.reset_hall(gp0), eps_all[m, 0], hall_empty=True)
    prep1, du1 = ipm_report(f"warm, step {m}", qpm, sa.qp_ws, sa.qp_valid)
    # prepare: the largest field error relative to that field's scale
    results["ipm_prepare"] = {"max_abs_err": max(prep0, prep1),
                              "err_relative_to": "each field's max |plain|"}
    results["ipm_mehrotra"] = {"max_abs_err": max(du0, du1)}

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
            Xs, Us = shift_solution(
                torch.as_tensor(pX[m - 1], dtype=f32, device=dev),
                torch.as_tensor(pU[m - 1], dtype=f32, device=dev))
        st_m = torch.as_tensor(phys[m], dtype=f32, device=dev)
        st = sqp.solve(spec, env, hyp, ocp, st_m, Xs, Us, gp0, eps_all[m])
        with plain_route(gp_sample, ipm):
            sp = sqp.solve(spec, env, hyp, ocp, st_m, Xs, Us, gp0,
                           eps_all[m])
        if int(st.status) != 0 or int(sp.status) != 0:
            fail(f"teacher-forced step {m}: status {int(st.status)} "
                 f"(plain {int(sp.status)})")
        ex.append(float(np.max(np.abs(st.X.cpu().numpy() - pX[m]))))
        eu.append(float(np.max(np.abs(st.U.cpu().numpy() - pU[m]))))
        kx.append(float(torch.max(torch.abs(st.X - sp.X))))
        ku.append(float(torch.max(torch.abs(st.U - sp.U))))
    print(f"[loop] teacher-forced {n_steps} steps vs the f64 oracle: status 0 "
          f"all; max|dX| {max(ex):.3e} (tol {TF_TOL_X}), max|dU| "
          f"{max(eu):.3e} (tol {TF_TOL_U}); per step dX "
          f"{[round(v, 5) for v in ex]}", flush=True)
    print(f"[loop] teacher-forced {n_steps} steps, kernels vs plain versions: "
          f"max|dX| {max(kx):.3e} (tol {TF_KP_TOL_X}), max|dU| {max(ku):.3e} "
          f"(tol {TF_KP_TOL_U}); per step dX {[f'{v:.2e}' for v in kx]}, dU "
          f"{[f'{v:.2e}' for v in ku]}", flush=True)
    if max(ex) > TF_TOL_X or max(eu) > TF_TOL_U:
        fail("teacher-forced closed loop outside the f32 tolerance")
    if max(kx) > TF_KP_TOL_X or max(ku) > TF_KP_TOL_U:
        fail("teacher-forced kernel path disagrees with the plain path")

    mpc = DEMPC(params, spec, data, env, device=dev, dtype=f32,
                epistemic=g["eps"])
    for k in (gp_sample.LAUNCHES, ipm.LAUNCHES):
        for name in k:
            k[name] = 0
    torch.cuda.synchronize()
    out = mpc.run()
    torch.cuda.synchronize()
    launches = {**gp_sample.LAUNCHES, **ipm.LAUNCHES}
    traj = np.stack(out["physical_state_traj"] + [out["final_state"]])
    step_ms = [1e3 * t for t in out["solver_time"]]
    # the whole window after the first step (which builds and warms up):
    # its mean keeps the slow cold-QP steps a median would hide
    window_ms = sum(step_ms[1:]) / (len(step_ms) - 1)
    print(f"[loop] free-running {n_steps} steps (DEMPC.run, cuda float32): "
          f"statuses {sorted(set(out['sqp_status_traj']))}, finite "
          f"{bool(np.isfinite(traj).all())}, final state {out['final_state']}"
          f" (oracle {g['final_state']}); qp iters {out['qp_iters']}",
          flush=True)
    print(f"[loop] ms per MPC step over steps 1..{n_steps - 1}: mean "
          f"{window_ms} (median {statistics.median(step_ms[1:])}, max "
          f"{max(step_ms[1:])}); first step {step_ms[0]}; per step "
          f"{[round(v, 3) for v in step_ms]}; launches {launches}",
          flush=True)
    if set(out["sqp_status_traj"]) != {0} or not np.isfinite(traj).all():
        fail("free-running closed loop")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")

    # ---- 5. timing at the main path's shapes ----------------------------
    ns, Ht, R = gp_in["Kxm"].shape
    t_gk = cuda_ms(lambda: gp_sample.sample_empty_one(**gp_in))
    t_gp = cuda_ms(lambda: gp_sample.sample_empty_plain(**gp_in), n=10)
    cov_batch = (gp_in["Ktt"] + 1e-3 * torch.eye(Ht, device=dev)).contiguous()
    t_chol = cuda_ms(lambda: torch.linalg.cholesky(cov_batch))
    gb = 4 * (ns * Ht * R + ns * Ht * Ht + ns * Ht + R * R + R + Ht
              + ns * Ht)
    gf = ns * (2 * R * R * Ht + 2 * R * Ht + R * Ht * (Ht + 1)
               + Ht ** 3 / 3 + Ht * Ht)
    b, by = bound_ms(gb, gf)
    results["gp_sample"].update(ms=t_gk, plain_ms=t_gp, bound_ms=b,
                                bound_by=by, library_ms=None,
                                partial_library_ms=t_chol)
    print(f"[timing] gp_sample kernel {t_gk:.4f} ms, plain {t_gp:.4f} ms, "
          f"bound {b:.5f} ms ({by}: {gb} B, {gf:.3e} flop); partial "
          f"yardstick torch.linalg.cholesky of the ({ns},{Ht},{Ht}) batch "
          f"{t_chol:.4f} ms (only the factorization)", flush=True)

    # the main path's first QP (cold) and a warm-started one
    for label, qpa, ws, wv in (("cold", qp0, None, None),
                               ("warm", qpm, sa.qp_ws, sa.qp_valid)):
        qpa = tuple(a.contiguous() for a in qpa)
        nU, m_h, m_s = qpa[1].shape[0], qpa[3].shape[0], qpa[5].shape[0]
        prep = ipm.prepare(*qpa, ws, wv, qp_mod.WS_BAND)
        t_pk = cuda_ms(lambda: ipm.prepare(*qpa, ws, wv, qp_mod.WS_BAND))
        t_pp = cuda_ms(lambda: ipm.prepare_plain(*qpa, ws, wv,
                                                 qp_mod.WS_BAND), n=10)
        t_mk = cuda_ms(lambda: ipm.mehrotra(prep, tol, reg, 150, *consts))
        pp = ipm.prepare_plain(*qpa, ws, wv, qp_mod.WS_BAND)
        t_mp = cuda_ms(lambda: ipm.mehrotra_plain(pp, tol, reg, 150, *consts),
                       n=5, warm=1)
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
        if label == "cold":
            results["ipm_prepare"].update(ms=t_pk, plain_ms=t_pp,
                                          bound_ms=bp, bound_by=byp,
                                          library_ms=None)
            results["ipm_mehrotra"].update(ms=t_mk, plain_ms=t_mp,
                                           bound_ms=bm, bound_by=bym,
                                           library_ms=None, iters=iters)

    # ---- report -----------------------------------------------------------
    meta = {
        "gp_sample": ("csrc/gp_sample.cu",
                      "sampling_gpmpc_tpu/ops/pallas_gp.py:148"),
        "ipm_prepare": ("csrc/ipm.cu",
                        "sampling_gpmpc_tpu/ops/pallas_ipm.py:423"),
        "ipm_mehrotra": ("csrc/ipm.cu",
                         "sampling_gpmpc_tpu/ops/pallas_ipm.py:112"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sampling_gpmpc_torch/" + src, "replaces": rep,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"partial_library_ms": r["partial_library_ms"]}
               if "partial_library_ms" in r else {}),
            **({"iters": r["iters"]} if "iters" in r else {}),
            **({"err_relative_to": r["err_relative_to"]}
               if "err_relative_to" in r else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
