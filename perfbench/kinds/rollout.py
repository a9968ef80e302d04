"""The forward-sampling rollout: one step is one whole rollout.

ns realizations of the GP dynamics propagated for T steps under the
configuration's replayed plan, each step conditioning every realization on
its own sampled value: the program's ``reachability.forward_sample_rollout``
(the call ``simulate_forward_sampling.py`` makes), from the published start
with the ancillary feedback, on fresh base draws each rollout from a pool
made at set-up.  Its traffic files add ``compare_realizations``: how many
realizations of a kept rollout, drawn from the seed, the check compares.

The check (``compare``) judges every step of the kept realizations from
the program's own state (teacher-forced), against ``reference/fs.py`` in
float64, whose posterior is formed from scratch on the real data and the
realization's own rows before the step:

* ``chain``: the rollout starts at the published start, on the
  configuration's replayed plan, on its own pool entry's draws, and the
  program's start state (the GP state ``gp0``) reads the same after it as
  at set-up (the rollout appends into copies); at most one of a kept
  rollout's realizations is not finite (the step's own bar).  Limit 0.
* ``fs_gp_gap``: the sampled value at each step against the reference's
  draw from the same base draw, at the GP input the reference forms from
  the step's state and input, in prior std.
* ``fs_var_gap``, ``fs_corr_gap``: the z-scores of the program's values
  under the reference posterior against the base draws, pooled over the
  steps, realizations and outputs whose posterior variance is at least
  ``TAU`` of the prior: |sum z^2 / sum eps^2 - 1| and 1 - corr(z, eps).
* ``fs_plant_gap``: the GP inputs the program conditioned on, and the next
  state, against the reference's from the step's state, input and the
  program's value, relative to 1 + |x|.
* logged: ``fs_env_gap``, the per-step min/max envelope of the first kept
  rollout's realizations against a free-running float64 reference rollout
  on the same draws; ``fs_excluded``, kept realizations left out as not
  finite.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from perfbench import check, faults, traffic
from perfbench.reference import fs

MIX_KEYS = ("compare_realizations",)
NUMBERS = ("chain", "fs_gp_gap", "fs_var_gap", "fs_corr_gap", "fs_plant_gap",
           "fs_env_gap", "fs_excluded")
# the z-scores pool the points whose posterior variance is at least TAU of
# the prior's: far below the configuration's (about 1e-6 of the prior along
# the rollout, the real data being dense against the lengthscales), far
# above what float64 resolves
TAU = 1e-8


class Start(NamedTuple):
    """What a rollout starts from: the start state and the plan."""
    x: torch.Tensor          # (nx,)
    U: torch.Tensor          # (T, nu)


class Out(NamedTuple):
    """A rollout: the states (T+1, ns, nx), the GP inputs (ns, g_ny, T, D)
    and sampled values (ns, g_ny, T, Ty) each realization conditioned on,
    and ``ok``: at most one realization not finite."""
    X: torch.Tensor
    hall_Z: torch.Tensor
    hall_Y: torch.Tensor
    ok: torch.Tensor


def _out(X, hall_Z, hall_Y) -> Out:
    bad = (~torch.isfinite(X).all(dim=-1).all(dim=0)).sum()
    return Out(X, hall_Z, hall_Y, bad <= 1)


def _sums(tensors):
    """Float64 sums and NaN counts of tensors, as one device vector."""
    return torch.stack([torch.nansum(t.double()) for t in tensors]
                       + [torch.isnan(t).sum().double() for t in tensors])


class Draws(traffic.Draws):
    """(pool, 1, T, ns, g_ny, 1, Ty): one rollout an episode, its base
    draws as ``forward_sample_rollout`` takes them."""

    @staticmethod
    def shape(mix, sizes):
        return (mix.pool_episodes, mix.episode_steps, sizes["T"],
                sizes["ns"], sizes["g_ny"], 1, sizes["Ty"])


class Program:
    """``sampling_gpmpc_torch``'s forward-sampling rollout on one device, in
    the precision the configuration states (cell.Cell.precision)."""

    def __init__(self, config_path: str, device, dtype):
        from sampling_gpmpc_torch import agent, reachability
        from sampling_gpmpc_torch.config import load_problem
        from sampling_gpmpc_torch.envs import make_env
        from sampling_gpmpc_torch.gp.exact import GPHyperArrays
        from sampling_gpmpc_torch.ops import routes

        self.device, self.dtype = torch.device(device), dtype
        params, spec, data = load_problem(config_path)
        T = spec.num_mpc_iter
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa
                                      device=self.device)
        self.spec, self.routes = spec, routes
        self.rollout = reachability.forward_sample_rollout
        self.env = make_env(spec, params)
        self.hyp = GPHyperArrays.from_spec(spec.gp, self.device, dtype)
        self.gp0 = agent.init_gp_state(spec, self.env, self.device, dtype,
                                       capacity=T, hyp=self.hyp)
        self.fb = {"K": data.K_fb, "x_eq": data.goal}
        self.start = Start(t(data.start), t(np.asarray(
            params[fs.REPLAYED])[:T]))
        self.libraries = []
        self.sizes = dict(
            ns=spec.ns, T=T, nx=spec.nx, nu=spec.nu, g_ny=spec.g_ny,
            Ty=spec.Ty, D=spec.n_gp_inputs, beta=spec.gp.beta,
            R=int(self.gp0.real_fact["mask"].shape[-1]),
            word=torch.finfo(dtype).bits // 8)
        self.fp0 = self.fingerprint()

    def fingerprint(self):
        """The start state's sums: the rollout must leave it as it is."""
        g = self.gp0
        return _sums([g.real_Z, g.real_Y, g.hall_Z, g.hall_Y,
                      *g.real_fact.values()])

    def build(self) -> None:
        pass                     # plain torch: nothing to build

    def episode_start(self) -> Start:
        return self.start

    def step(self, c: Start, eps):
        """One rollout on its base draws eps (T, ns, g_ny, 1, Ty)."""
        X, gp = self.rollout(self.spec, self.env, self.hyp, self.gp0, c.x,
                             c.U, use_feedback=self.fb, eps=eps)
        return c, _out(X, gp.hall_Z, gp.hall_Y)

    def launch_counts(self) -> dict:
        return self.routes.launch_counts()


def control(config_path: str, device):
    """The control of the check: the program's own float32 path, the
    precision below the configuration's float64."""
    return Program(config_path, device, torch.float32)


@dataclasses.dataclass
class Record:
    """A kept rollout: its episode (pool entry), the realizations kept,
    what went in for them and what came out, and the start state's
    fingerprints at set-up and after the rollout."""
    episode: int
    idx: torch.Tensor        # (n,) kept realizations
    x0: torch.Tensor         # (nx,)
    U: torch.Tensor          # (T, nu)
    eps: torch.Tensor        # (T, n, g_ny, 1, Ty)
    X: torch.Tensor          # (T+1, n, nx)
    hall_Z: torch.Tensor     # (n, g_ny, T, D)
    hall_Y: torch.Tensor     # (n, g_ny, T, Ty)
    fp0: torch.Tensor
    fp: torch.Tensor


def record(loop, c: Start, eps, out: Out) -> Record:
    """A seeded sample of ``compare_realizations`` of the rollout's
    realizations (device ops only: no wait for the card)."""
    ns = eps.shape[1]
    g = torch.Generator().manual_seed(traffic.seed64(loop.seed,
                                                     3 + loop.episode))
    idx = torch.randperm(ns, generator=g)[
        :loop.mix.extra["compare_realizations"]].sort().values
    idx = idx.to(eps.device)
    return Record(loop.episode, idx, c.x, c.U, eps[:, idx], out.X[:, idx],
                  out.hall_Z[idx], out.hall_Y[idx], loop.system.fp0,
                  loop.system.fingerprint())


def counts(out: Out):
    """A rollout's metrics read no count of it."""
    return ()


def compare_rollout(m: fs.Model, rec: Record, pool: Draws,
                    envelope: bool) -> dict:
    """The numbers of one kept rollout (float64 on the model's device)."""
    f, s = torch.float64, m.spec
    t64 = lambda a: a.to(device=m.device, dtype=f)  # noqa

    # the start, the plan, the draws and the start state, exactly
    start = m.start.to(rec.X.dtype)
    finite = torch.isfinite(rec.X).all(dim=-1).all(dim=0)
    excluded = int((~finite).sum())
    bad = [not torch.equal(rec.x0, start),
           not torch.equal(rec.X[0][finite], start.expand_as(
               rec.X[0])[finite]),
           not torch.equal(rec.U, m.U.to(rec.U.dtype)),
           not torch.equal(rec.eps, pool.episode(rec.episode)[0][:, rec.idx]),
           not torch.equal(rec.fp, rec.fp0), excluded > 1]

    X = t64(rec.X)[:, finite]                          # (T+1, n, nx)
    Zp = t64(rec.hall_Z)[finite]                       # (n, g_ny, T, D)
    Yp = t64(rec.hall_Y)[finite][..., 0]               # (n, g_ny, T)
    n = X.shape[1]
    eps = t64(rec.eps)[:, finite].reshape(m.T, n, s.g_ny)
    prior_std = m.prior_std()
    Zr = X.new_zeros((n, m.T, s.D))
    gp_gap = plant_gap = 0.0
    zs, es = [], []
    for t in range(m.T):
        u, z = fs.inputs(m, X[t], t)
        Zr[:, t] = z
        plant_gap = max(plant_gap, check.rel(Zp[:, :, t],
                                              z[:, None].expand_as(
                                                  Zp[:, :, t])))
        mean, var = fs.posterior(m, Zr[:, :t], Yp[..., :t], z)
        y = Yp[..., t]
        y_ref = fs.draw(m, mean, var, eps[t])
        gp_gap = max(gp_gap, check.worst(torch.abs(y - y_ref) / prior_std))
        keep = var >= TAU * m.os_
        zs.append(((y - mean) / torch.sqrt(torch.clamp(var, min=0.0)))[keep])
        es.append(eps[t][keep])
        plant_gap = max(plant_gap, check.rel(
            X[t + 1], m.plant.propagate(X[t], u, y)))
    z, e = torch.cat(zs), torch.cat(es)
    var_gap = corr_gap = 0.0
    if z.numel():
        zz, ee = torch.sum(z * z), torch.sum(e * e)
        var_gap = check.worst(torch.abs(zz / ee - 1.0))
        corr_gap = check.worst(1.0 - torch.sum(z * e) / torch.sqrt(zz * ee))

    env_gap = 0.0
    if envelope and n:
        X_ref = fs.rollout(m, t64(rec.eps)[:, finite])[0]
        env = lambda a: torch.stack([a.amin(1), a.amax(1)])  # noqa
        env_gap = check.worst(torch.abs(env(X) - env(X_ref)))
    return {"chain": float(sum(bad)), "fs_gp_gap": gp_gap,
            "fs_var_gap": var_gap, "fs_corr_gap": corr_gap,
            "fs_plant_gap": plant_gap, "fs_env_gap": env_gap,
            "fs_excluded": float(excluded)}


def compare(c, records, device, seed):
    """The worst of each number over the kept rollouts and how many were
    compared: {"compared": n, name: value}."""
    m = fs.Model.from_file(c.config_path, device, torch.float64)
    most = {k: 0.0 for k in NUMBERS}
    pool = None
    for k, rec in enumerate(records):
        if pool is None:        # the run's draws, made again from the seed
            pool = Draws(c.mix, {"T": m.T, "ns": m.spec.ns,
                                 "g_ny": m.spec.g_ny, "Ty": m.spec.Ty,
                                 "beta": m.spec.beta}, seed, device,
                         rec.eps.dtype)
        for name, v in compare_rollout(m, rec, pool, k == 0).items():
            most[name] = max(most[name], float("inf") if v != v else v)
    return {"compared": len(records), **most}


# --------------------------------------------------------------------------
# faults planted in the program's rollout (control.py, the tests)
# --------------------------------------------------------------------------

def unchanged(system):
    """The rollout hands back its start: every state the start, the GP
    state as it was given."""
    def rollout(spec, env, hyp, gp, x0, U, use_feedback=None, eps=None):
        return x0.expand(len(U) + 1, spec.ns, spec.nx), gp
    return faults.patch(system, "rollout", rollout)


def _sampled(change_dg=None, change_eps=None):
    """The rollout's draw of each step with its values or base draws
    changed; returns the undo."""
    from sampling_gpmpc_torch import reachability
    orig = reachability._sample_at_points_uf

    def sample(spec, hyp, gp, ufs, Xt, eps):
        if change_eps is not None:
            eps = change_eps(eps)
        dg = orig(spec, hyp, gp, ufs, Xt, eps)
        return dg if change_dg is None else change_dg(dg)
    return faults.patch(reachability, "_sample_at_points_uf", sample)


def half_batch(system):
    """Each step draws half of the realizations and gives the others the
    mean of those drawn."""
    def change(dg):
        h = dg.shape[0] // 2
        return torch.cat([dg[:h], dg[:h].mean(0, keepdim=True).expand(
            (dg.shape[0] - h,) + dg.shape[1:])])
    return _sampled(change_dg=change)


def _mean(system):
    """Each step draws the posterior mean (base draws 0)."""
    return _sampled(change_eps=torch.zeros_like)


def _shrink(system):
    """Each step draws from base draws halved."""
    return _sampled(change_eps=lambda e: 0.5 * e)


def _flip(system):
    """Each step draws from base draws negated."""
    return _sampled(change_eps=torch.neg)


def next_state(system):
    """The next state is altered where the rollout makes it."""
    from sampling_gpmpc_torch import reachability
    orig = reachability._propagate

    def propagate(*a):
        return orig(*a) + 1e-3
    return faults.patch(reachability, "_propagate", propagate)


def unconditioned(system):
    """No append: each step conditions on the real data alone."""
    from sampling_gpmpc_torch.gp import exact

    def append_rows_update(rf, uf, *a, **kw):
        return uf
    return faults.patch(exact, "append_rows_update", append_rows_update)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "next_state": next_state, "mean": _mean, "shrink": _shrink,
          "flip": _flip, "unconditioned": unconditioned}
