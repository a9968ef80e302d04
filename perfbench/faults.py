"""Faults planted in the timed path of ``systems.Program``, each where its
layer produces its result: the upper readings of the correctness limits
(``python -m perfbench.control --faults ...``, on the card at a cell's own
size) and the fault tests (``perfbench/tests/test_perfbench_faults.py``)
use the same ones.

    with faults.planted("hall_mean", system):
        ...   # every step of ``system`` runs with the fault

* ``unchanged``: the solve hands back the state it was given;
* ``half_batch``: the GP stage draws half of the samples and gives the
  others the mean of those drawn (every SQP iteration);
* ``answer``: the plan's first input is altered where the solve makes it;
* ``next_state``: the plant's next state is altered where it is made;
* ``hall_mean``, ``hall_shrink``, ``hall_flip``: the hall-conditioned GP
  stages (SQP iterations >= 1) draw from base draws set to 0, halved or
  negated: the posterior mean, a shrunk draw, a mirrored draw, all
  inside the posterior's tube;
* ``hall_unconditioned``: the hall stages condition on the real data
  alone, as iteration 0 does, not on the sample's rows of the iterations
  before;
* ``qp_stop``: the QP's Mehrotra loop stops after QP_STOP_ITERS iterations
  and reports status 0: a feasible step short of the optimum.
"""

from __future__ import annotations

import contextlib

import torch

QP_STOP_ITERS = 4


def patch(obj, name: str, value):
    """Set ``obj.name``; returns the undo."""
    had = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, value)

    def undo():
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)
    return undo


def unchanged(system):
    sqp = system.sqp

    def solve(spec, env, hyp, ocp, x, X, U, gp, eps, qp_ws, qp_valid):
        s = sqp._initial_state(spec, X, U, gp, qp_ws, qp_valid)
        return s._replace(gp=gp, it=1)
    return patch(system, "solve", solve)


def _sample_dynamics(change_dg=None, change_eps=None, forget=False):
    """agent.sample_dynamics with its rows (every iteration) or its hall
    stages' base draws (iterations >= 1) changed, or (``forget``) its hall
    stages conditioned as iteration 0; returns the undo."""
    from sampling_gpmpc_torch import agent
    orig = agent.sample_dynamics

    def sample_dynamics(spec, env, hyp, gp, Xt, eps, hall_empty=False,
                        group=None):
        if change_eps is not None and not hall_empty:
            eps = change_eps(eps)
        hall_empty = hall_empty or forget
        if change_dg is None:
            return orig(spec, env, hyp, gp, Xt, eps, hall_empty, group)
        dg, _ = orig(spec, env, hyp, gp, Xt, eps, hall_empty, group)
        dg = change_dg(spec, dg)
        return dg, agent.append_hall(spec, hyp, gp, Xt, dg)
    return patch(agent, "sample_dynamics", sample_dynamics)


def half_batch(system):
    def change(spec, dg):
        h = spec.ns // 2
        return torch.cat([dg[:h], dg[:h].mean(0, keepdim=True).expand(
            (spec.ns - h,) + dg.shape[1:])])
    return _sample_dynamics(change_dg=change)


def hall_mean(system):
    return _sample_dynamics(change_eps=torch.zeros_like)


def hall_shrink(system):
    return _sample_dynamics(change_eps=lambda e: 0.5 * e)


def hall_flip(system):
    return _sample_dynamics(change_eps=torch.neg)


def hall_unconditioned(system):
    return _sample_dynamics(forget=True)


def answer(system):
    orig = system.solve

    def solve(*a):
        st = orig(*a)
        return st._replace(U=torch.cat([st.U[:1] + 0.05, st.U[1:]]))
    return patch(system, "solve", solve)


def next_state(system):
    from perfbench import systems
    orig = system.step

    def step(c, eps):
        nxt, out = orig(c, eps)
        x = out.x_next + 1e-3
        return (systems.Carry(x, nxt.X, nxt.U, nxt.gp, nxt.qp_ws,
                              nxt.qp_valid), out._replace(x_next=x))
    return patch(system, "step", step)


def qp_stop(system):
    sqp = system.sqp
    orig = sqp.solve_qp_soft

    def solve_qp_soft(*a, **kw):
        sol = orig(*a, **{**kw, "max_iter": QP_STOP_ITERS})
        return sol._replace(status=torch.zeros_like(sol.status))
    return patch(sqp, "solve_qp_soft", solve_qp_soft)


FAULTS = {f.__name__: f for f in (unchanged, half_batch, answer, next_state,
                                  hall_mean, hall_shrink, hall_flip,
                                  hall_unconditioned, qp_stop)}


@contextlib.contextmanager
def planted(name: str, system, table=FAULTS):
    """Within the block, ``system``'s steps run with the fault ``name`` of
    ``table`` (the MPC step's faults unless a kind gives its own)."""
    undo = table[name](system)
    try:
        yield system
    finally:
        undo()
