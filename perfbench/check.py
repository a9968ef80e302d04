"""Whether the timed path's steps are right: the kept steps against the
float64 reference, number by number, each beside its limit.

For every kept step (harness.Record), with the reference (reference/)
worked out again from the configuration file, the worst over the steps:

* ``chain``: the step's inputs are what the episode implies, exactly: an
  episode's first step starts at the published start from the cold
  iterate (the start over every stage, zero inputs), a later one at the
  previous step's plant state and shifted plan.  Limit 0.
* ``gp_gap``: iteration 0's sampled GP rows (read from the program's
  hallucination buffer, which holds each iteration's inputs and rows)
  against the reference's draw from the same base draws at the inputs
  the reference forms from the step's iterate, in units of the prior
  standard deviation of their output and task.
* each later iteration's rows, conditioned on the real data and the
  program's rows of the iterations before, against that float64
  posterior: ``hall_out``, how far they lie outside its tube mean +/- beta
  std, in prior std; ``hall_gap``, their raw gap to the reference's draw
  from the same base draws, in prior std; and, along the posterior's
  principal directions whose variance is at least TAU of the prior's
  (``whitened``), the draws' deviations from its mean as z-scores:
  ``hall_var_gap``, |sum z_prog^2 / sum z_ref^2 - 1|, and
  ``hall_corr_gap``, 1 - the correlation of z_prog with z_ref, pooled over
  the step's later iterations, samples and outputs.
* ``plan_gap``: the plan against the reference's linearization and
  condensing of the last SQP iteration (from the iterate entering it and
  the program's rows of it): X_prev + alpha T + Gamma (U - U_prev) must be
  the plan's X, relative to 1 + |X|; with the GP inputs of iteration 0
  and of the last iteration against those the reference forms.
* the reference's float64 QP of that iteration, from its own
  linearization, and its optimum: ``u_gap``, the program's step's largest
  distance from that optimum; ``qp_gap``, the objective at the program's
  step against the optimum's, relative to 1 + |optimum|
  (``qp_gap_scaled``: over the QP's scale 1 + max|g| + max penalty;
  ``qp_gap_first``: that, over an episode's first steps alone, whose
  one-iteration QPs start cold);
  ``qp_viol``, the step's largest violation of a hard row, relative to
  1 + |bound|.
* ``plant_gap``: the next plant state against the reference plant's step
  from the plan's first state and input (with the ancillary feedback),
  relative to 1 + |x|.

Each cell's limits file names the numbers that decide ``correct`` there;
the others go to the run's log.  A step that failed (QP status not 0, or
not finite) counts in ``failed`` and is not kept.  The run is correct
when at least one step was compared and every named number is within its
limit.  The program is judged from its own state step by step (a float32
chain leaves a float64 one over free-running steps); ``chain`` checks the
start and the carry that this skips.
"""

from __future__ import annotations

import torch

from perfbench.reference import mpc, qp

NUMBERS = ("chain", "gp_gap", "hall_gap", "hall_out", "hall_var_gap",
           "hall_corr_gap", "plan_gap", "qp_gap", "qp_gap_scaled",
           "qp_gap_first", "qp_viol", "u_gap", "plant_gap")

# the principal directions of a hall-conditioned posterior (in prior-std
# units) whose variance is at least TAU are judged by ``whitened``; the
# others hold what float32 cannot resolve
TAU = 0.01


def worst(a) -> float:
    """The largest entry, NaN counting as infinitely large."""
    return float(torch.max(torch.nan_to_num(a, nan=float("inf"))))


def rel(a, b):
    return worst(torch.abs(a - b) / (1.0 + torch.abs(b)))


def whitened(dev, dev_ref, cov, prior_std, tau: float = TAU):
    """Deviations from the posterior mean, (ns, g_ny, H, Ty) each, as
    z-scores along the principal directions of the posterior covariance
    cov (ns, g_ny, H Ty, H Ty), scaled to the prior's std, whose variance
    is at least tau: (z, z_ref), flat, the same directions in both.  Any
    square root of cov gives z_ref's spread; a draw from the same base
    draws also its values."""
    ns, g_ny = dev.shape[:2]
    d = prior_std.expand(dev.shape).reshape(ns, g_ny, -1)
    lam, V = torch.linalg.eigh(cov / (d[..., :, None] * d[..., None, :]))
    keep = lam >= tau
    scale = torch.sqrt(torch.clamp(lam, min=tau))

    def z(x):
        x = x.reshape(ns, g_ny, -1) / d
        return ((V.transpose(-1, -2) @ x[..., None])[..., 0] / scale)[keep]
    return z(dev), z(dev_ref)


def compare_step(m: mpc.Model, rec) -> dict:
    """The numbers of one kept step (float64 on the model's device)."""
    s = m.spec
    f = m.dtype
    t = lambda a: a.to(device=m.device, dtype=f)  # noqa
    o = rec.out
    x, X_in, U_in, eps = t(rec.x), t(rec.X), t(rec.U), t(rec.eps)
    X, U, X_prev, U_prev = t(o.X), t(o.U), t(o.X_prev), t(o.U_prev)
    hall_Z, hall_Y = t(o.hall_Z), t(o.hall_Y)
    it, alpha = int(o.it), float(o.alpha)
    HH = s.H

    # the start and the carry, exactly, in the program's dtype
    if rec.first:
        start = m.ocp.start.to(rec.x.dtype)
        bad = [not torch.equal(rec.x, start.expand_as(rec.x)),
               not torch.equal(rec.X, start.expand_as(rec.X)),
               bool(torch.any(rec.U != 0))]
    else:
        p = rec.prev
        Xs, Us = (mpc.shift(p.X, p.U) if s.shift_soln else (p.X, p.U))
        bad = [not torch.equal(rec.x, p.x_next), not torch.equal(rec.X, Xs),
               not torch.equal(rec.U, Us)]
    chain = float(sum(bad))

    # the GP stage of every SQP iteration
    prior_std = m.prior_std()[None, :, None, :]          # (1, g_ny, 1, Ty)
    gp_gap = hall_gap = hall_out = in_gap = 0.0
    zs, zs_ref = [], []
    for i in range(it):
        rows = slice(i * HH, (i + 1) * HH)
        if i == 0:
            Xt = mpc.gp_inputs(m, X_in, U_in)
            in_gap = max(in_gap, rel(hall_Z[:, 0, rows], Xt))
        else:
            Xt = hall_Z[:, 0, rows]
        if i == it - 1:
            in_gap = max(in_gap, rel(hall_Z[:, 0, rows],
                                      mpc.gp_inputs(m, X_prev, U_prev)))
        g = mpc.with_hall(m.gp0, hall_Z, hall_Y, i * HH)
        dg_ref, mean, std, cov = mpc.gp_stage(m, g, Xt, eps[i],
                                              moments=True)
        dg = hall_Y[:, :, rows]
        gap = worst(torch.abs(dg - dg_ref) / prior_std)
        out = worst(torch.clamp(torch.abs(dg - mean) - m.spec.beta * std,
                                 min=0.0) / prior_std)
        if i == 0:
            gp_gap = max(gp_gap, gap)
        else:
            hall_gap, hall_out = max(hall_gap, gap), max(hall_out, out)
            z, z_ref = whitened(dg - mean, dg_ref - mean, cov, prior_std)
            zs.append(z)
            zs_ref.append(z_ref)
    hall_var = hall_corr = 0.0
    z, z_ref = (torch.cat(zs), torch.cat(zs_ref)) if zs else (None, None)
    if zs and z_ref.numel():
        zz, rr = torch.sum(z * z), torch.sum(z_ref * z_ref)
        hall_var = worst(torch.abs(zz / rr - 1.0))
        hall_corr = worst(1.0 - torch.sum(z * z_ref)
                           / torch.sqrt(zz * rr))

    # linearization, condensing and the QP of the last iteration
    dg_last = hall_Y[:, :, (it - 1) * HH:it * HH]
    T, Gamma = mpc.linearize(m, x, X_prev, U_prev, dg_last)
    dU = (U - U_prev).reshape(-1)
    dX = alpha * T + torch.einsum("ikau,u->ika", Gamma, dU)
    X_pred = X_prev + dX.transpose(0, 1)
    plan_gap = max(rel(X, X_pred), in_gap)
    problem = mpc.assemble(m, T, Gamma, X_prev, U_prev)
    du_ref, status_ref, _ = qp.solve(problem)
    f_ref = float(qp.objective(problem, du_ref))
    f_prog = float(qp.objective(problem, dU / alpha))
    qp_gap = (f_prog - f_ref) / (1.0 + abs(f_ref))
    qscale = 1.0 + float(torch.max(torch.abs(problem[1]))) + max(
        [float(torch.max(z)) for z in problem[7:9] if z.numel()] + [0.0])
    qp_gap_scaled = (f_prog - f_ref) / qscale
    if status_ref != 0:
        qp_gap = qp_gap_scaled = float("inf")
    qp_viol = float(qp.hard_violation(problem, dU / alpha))
    u_gap = float(torch.max(torch.abs(dU / alpha - du_ref)))

    # the plant
    x_ref = m.plant.step(X[0, 0], mpc.applied_input(m, X, U))
    plant_gap = rel(t(o.x_next), x_ref)
    return {"chain": chain, "gp_gap": gp_gap, "hall_gap": hall_gap,
            "hall_out": hall_out, "hall_var_gap": hall_var,
            "hall_corr_gap": hall_corr,
            "plan_gap": plan_gap, "qp_gap": qp_gap,
            "qp_gap_scaled": qp_gap_scaled, "qp_viol": qp_viol,
            "qp_gap_first": qp_gap_scaled if rec.first else 0.0,
            "u_gap": u_gap,
            "plant_gap": plant_gap}


def compare(config_path: str, records, device) -> dict:
    """The largest of each number over the kept steps and how many were
    compared: {"compared": n, name: value}."""
    m = mpc.Model.from_file(config_path, device, torch.float64)
    most = {k: 0.0 for k in NUMBERS}
    for rec in records:
        for k, v in compare_step(m, rec).items():
            most[k] = max(most[k], float("inf") if v != v else v)
    return {"compared": len(records), **most}


def verdict(readings: dict, limits: dict):
    """(correct, checks): each number the cell's limits name beside its
    limit; correct when at least one step was compared (``compared``'s
    limit is a floor) and every such number is within its limit."""
    checks = {"compared": {"value": readings["compared"], "limit": 1}}
    ok = readings["compared"] >= 1
    for k, lim in limits.items():
        v = readings[k]
        ok = ok and v <= lim
        # a non-finite reading (NaN counts as infinite) prints as the
        # largest float, so that the result line stays plain JSON
        checks[k] = {"value": min(v, 1.0e308), "limit": lim}
    return ok, checks
