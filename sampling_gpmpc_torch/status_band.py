"""The float32 STATUS_RTOL acceptance band in real closed loops.

Counterpart of ``profiling/status_band.py``.  ``ocp/qp.py`` accepts a QP
as status 0 whenever its best KKT residual is within ``STATUS_RTOL`` of
the exit tolerance, so a step could be consumed at a residual 1e3 times
the tolerance.  This replays closed loops through the recorded SQP solve
(``sqp.solve_recorded``: the update of ``solve``, with the same kernels on
the card) and histograms every consumed QP's best residual relative to
the exit tolerance.  On the card every consumed QP goes through the IPM
kernels (``ipm_prepare``, ``ipm_mehrotra``) and the GP stages through
``gp_sample`` and ``gp_hall``; each config's launches and QP routes
(``ocp/qp.py`` ``ROUTES``) are printed beside its table.

Usage (from the repository root):
    python -m sampling_gpmpc_torch.status_band [--steps N] [config ...]
    python -m sampling_gpmpc_torch.status_band --eps-from \\
        tests/goldens/oracle_pendulum1d_flagship.npz params_pendulum1D_samples
    ... --device cpu   # float64 on the CPU (SGPMPC_DTYPE=float32 for f32)

CUDA float32 by default.  ``--eps-from`` replays a golden's stored draws
(its ``eps``, (steps, sqp, ns, g_ny, H, Ty)), so that a run can be held
against a JAX run on the same draws; otherwise the port's seeded draws.
"""

import argparse
import dataclasses
import os

import numpy as np

BANDS = (1.0, 3.0, 10.0, 100.0, 1000.0)
LABELS = (["<=1x"] + [f"({a:g},{b:g}]x" for a, b in
                      zip((1, 3, 10, 100), BANDS[1:])] + [">1000x"])
CONFIGS = ("params_pendulum1D_samples", "params_pendulum", "params_car")


def exit_tol(spec, dtype) -> float:
    """The QP exit tolerance the loop runs with (``sqp`` passes the
    config's ``qp_tol`` where it sets one)."""
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    return spec.qp_tol if spec.qp_tol > 0 else qp_mod.TOL[dtype]


def band_histogram(gaps, statuses, tol: float) -> dict:
    """Consumed (status 0) QPs' best residuals over ``tol``, by band."""
    gaps, statuses = np.asarray(gaps), np.asarray(statuses)
    consumed = statuses == 0
    ratio = gaps[consumed] / tol
    hist = np.zeros(len(BANDS) + 1, dtype=int)
    prev = 0.0
    for i, b in enumerate(BANDS):
        hist[i] = int(np.sum((ratio > prev) & (ratio <= b)))
        prev = b
    hist[-1] = int(np.sum(ratio > BANDS[-1]))
    return {"hist": hist, "consumed": int(consumed.sum()),
            "rejected": int((~consumed).sum()),
            "max_ratio": float(ratio.max()) if ratio.size else 0.0}


def run_config(config: str, n_steps, device, dtype, eps=None) -> dict:
    """One config's closed loop through ``sqp.solve_recorded``.

    Args:
        eps: optional draws (steps, max_sqp_iter, ns, g_ny, H, Ty); the
            loop runs at most that many steps.
    Returns:
        {"gaps", "statuses" (one per QP), "X", "U" (each step's plan),
         "launches", "routes" (kernel launches and QP routes of the loop),
         "tol"}.
    """
    import torch

    from sampling_gpmpc_torch import agent as agent_mod
    from sampling_gpmpc_torch.config import load_problem
    from sampling_gpmpc_torch.dempc import shift_solution
    from sampling_gpmpc_torch.envs import make_env
    from sampling_gpmpc_torch.gp.exact import GPHyperArrays
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    from sampling_gpmpc_torch.ocp import sqp
    from sampling_gpmpc_torch.ocp.spec import make_ocp_data
    from sampling_gpmpc_torch.parallel import worker

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, spec, data = load_problem(
        os.path.join(here, "params", config + ".yaml"))
    steps = spec.num_mpc_iter
    if n_steps is not None:
        steps = min(steps, n_steps)
    if eps is not None:
        steps = min(steps, len(eps))
    spec = dataclasses.replace(spec, num_mpc_iter=steps)
    env = make_env(spec, params)
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    ocp = make_ocp_data(spec, data, device, dtype)
    hyp = GPHyperArrays.from_spec(spec.gp, device, dtype)
    gp = agent_mod.init_gp_state(spec, env, device, dtype, hyp=hyp)
    eps = (agent_mod.make_epistemic(spec, None, device, dtype)
           if eps is None else t_(eps))
    X, U = sqp.init_iterate(spec, device, dtype, data.start)
    x = t_(data.start)
    ws = wv = None
    goal = t_(data.goal)
    K_fb = t_(data.K_fb) if spec.use_feedback else None
    probe = lambda gp_, Xt: (None, None)   # noqa: E731 - no moments here
    gaps, statuses, Xs, Us = [], [], [], []
    worker.zero_counters()
    for m in range(steps):
        st, recs = sqp.solve_recorded(spec, env, hyp, ocp, x, X, U, gp,
                                      eps[m], ws, wv, probe_fn=probe)
        for r in recs:
            gaps.append(r["qp_gap"])
            statuses.append(r["qp_status"])
        X, U, gp = st.X, st.U, st.gp
        ws, wv = st.qp_ws, st.qp_valid
        Xs.append(X.cpu().numpy())
        Us.append(U.cpu().numpy())
        u0 = U[0]
        if K_fb is not None:
            u0 = u0 - (goal - X[0, 0]) @ K_fb.T
        x = env.discrete_dyn(X[0, 0], u0).reshape(-1)
        if spec.shift_soln:
            X, U = shift_solution(X, U)
    counts = worker.counters()
    launches = {k: counts[k] for k in worker.COUNTERS[:4]}
    return {"gaps": np.asarray(gaps), "statuses": np.asarray(statuses),
            "X": np.stack(Xs), "U": np.stack(Us), "launches": launches,
            "routes": dict(qp_mod.ROUTES), "tol": exit_tol(spec, dtype)}


def report(config: str, r: dict) -> np.ndarray:
    """Print one config's lines (the JAX script's, then the launches and
    routes); returns its histogram."""
    h = band_histogram(r["gaps"], r["statuses"], r["tol"])
    print(f"{config}: {h['consumed']} consumed QPs ({h['rejected']} "
          f"rejected), max ratio {h['max_ratio']:.2f}x tol", flush=True)
    print("  " + "  ".join(f"{l}:{n}" for l, n in zip(LABELS, h["hist"])),
          flush=True)
    print("  launches " + " ".join(f"{k}={v}" for k, v in
                                   r["launches"].items())
          + "; QP routes " + " ".join(f"{k}={v}" for k, v in
                                      r["routes"].items()), flush=True)
    return h["hist"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="float32 status-0 band")
    ap.add_argument("configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--steps", type=int, default=None,
                    help="cap MPC steps per config")
    ap.add_argument("--eps-from", default=None,
                    help=".npz whose eps (steps, sqp, ns, g_ny, H, Ty) the "
                         "loop replays (one config)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) | cpu | cuda:N")
    args = ap.parse_args(argv)

    import torch

    from sampling_gpmpc_torch import setup
    from sampling_gpmpc_torch.ocp import qp as qp_mod
    device, dtype = setup.resolve(args.device)
    eps = None
    if args.eps_from:
        if len(args.configs) != 1:
            raise SystemExit("--eps-from replays one config's draws: name "
                             "exactly one config")
        eps = np.load(args.eps_from)["eps"]
    print(f"{dtype} on {device}: tol={qp_mod.TOL[dtype]:g}, STATUS_RTOL "
          f"band = (tol, {qp_mod.STATUS_RTOL:g}*tol]", flush=True)
    total = np.zeros(len(BANDS) + 1, dtype=int)
    for config in args.configs:
        r = run_config(config, args.steps, device, dtype, eps)
        total += report(config, r)
    print("TOTAL: " + " ".join(str(h) for h in total), flush=True)
    if device.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(device)}", flush=True)


if __name__ == "__main__":
    main()
