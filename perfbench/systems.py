"""What the loop drives: the measured program, or the reference in its place.

Both take a configuration file and hand back, for one MPC step, the same
``Out``; the harness loop (``harness.py``) knows nothing else of them.

* ``Program``: ``sampling_gpmpc_torch``, set up through its public
  constructors, a step as ``DEMPC.run`` makes one: ``ocp.sqp.solve`` from
  the carried iterate with the QP warm start carried, the plan's first
  input with the ancillary feedback applied to the plant
  (``env.discrete_dyn``), ``dempc.shift_solution`` where the config
  shifts.  The only module of this package that imports the program.
* ``Reference``: ``perfbench/reference`` put in the program's place (every
  QP cold), as the control of the correctness check runs it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass
class Carry:
    """What one MPC step hands the next within an episode."""
    x: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    gp: object = None
    qp_ws: tuple = None
    qp_valid: torch.Tensor = None


class Out(NamedTuple):
    """One MPC step's result: the plan (before the shift), the iterate
    entering its last SQP iteration, the hallucination buffer with every
    iteration's GP inputs and sampled rows, the SQP iterations, the step
    scale, the last QP's status, the summed QP iterations (a tensor or an
    int), the next plant state, and ``ok``: a bool tensor, false where the
    QP status is not 0 or the state or plan is not finite."""
    X: torch.Tensor
    U: torch.Tensor
    X_prev: torch.Tensor
    U_prev: torch.Tensor
    hall_Z: torch.Tensor
    hall_Y: torch.Tensor
    it: int
    alpha: object
    status: object
    qp_iters: object
    x_next: torch.Tensor
    ok: torch.Tensor


def _ok(status, x_next, X, U):
    finite = torch.isfinite(torch.cat([x_next.reshape(-1), X.reshape(-1),
                                       U.reshape(-1)])).all()
    return finite & (torch.as_tensor(status, device=X.device) == 0)


class Program:
    """``sampling_gpmpc_torch`` on one device (float32 on the card)."""

    def __init__(self, config_path: str, device, dtype=torch.float32):
        from sampling_gpmpc_torch import agent
        from sampling_gpmpc_torch.config import load_problem
        from sampling_gpmpc_torch.dempc import shift_solution
        from sampling_gpmpc_torch.envs import make_env
        from sampling_gpmpc_torch.gp.exact import GPHyperArrays
        from sampling_gpmpc_torch.ocp import sqp
        from sampling_gpmpc_torch.ocp.assemble import row_counts
        from sampling_gpmpc_torch.ocp.spec import make_ocp_data
        from sampling_gpmpc_torch.ops import ipm
        from sampling_gpmpc_torch.ops import routes

        self.device, self.dtype = torch.device(device), dtype
        params, spec, data = load_problem(config_path)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa
                                      device=self.device)
        self.spec, self.sqp, self.shift = spec, sqp, shift_solution
        self.solve = sqp.solve
        self.routes = routes
        self.env = make_env(spec, params)
        self.ocp = make_ocp_data(spec, data, self.device, dtype)
        self.hyp = GPHyperArrays.from_spec(spec.gp, self.device, dtype)
        self.gp0 = agent.init_gp_state(spec, self.env, self.device, dtype,
                                       hyp=self.hyp)
        self.start = data.start
        self.K_fb = t(data.K_fb) if spec.use_feedback else None
        self.goal = t(data.goal)
        m_h, m_s = row_counts(spec)
        nU = spec.H * spec.nu
        self.libraries = ["gp_sample", ipm._library(m_s, nU)] + (
            ["gp_hall"] if spec.max_sqp_iter > 1 else [])
        self.sizes = dict(
            ns=spec.ns, H=spec.H, nx=spec.nx, nu=spec.nu, g_ny=spec.g_ny,
            Ty=spec.Ty, max_sqp_iter=spec.max_sqp_iter, beta=spec.gp.beta,
            dt=spec.dt, R=int(self.gp0.real_fact["mask"].shape[-1]), nU=nU,
            m_h=m_h, m_s=m_s)

    def build(self) -> None:
        """Build (or find built) the CUDA libraries this configuration
        launches, all at once; nothing on the CPU."""
        if self.device.type == "cuda":
            from sampling_gpmpc_torch.ops import build
            build.build_all(self.libraries)

    def episode_start(self) -> Carry:
        sqp = self.sqp
        X, U = sqp.init_iterate(self.spec, self.device, self.dtype,
                                self.start)
        return Carry(x=torch.as_tensor(self.start, dtype=self.dtype,
                                       device=self.device),
                     X=X, U=U, gp=self.gp0,
                     qp_ws=sqp.init_qp_ws(self.spec, self.device, self.dtype),
                     qp_valid=torch.zeros((), dtype=torch.bool,
                                          device=self.device))

    def step(self, c: Carry, eps):
        """One MPC step on its draws eps (max_sqp_iter, ns, g_ny, H, Ty);
        returns (next Carry, Out)."""
        st = self.solve(self.spec, self.env, self.hyp, self.ocp, c.x, c.X, c.U,
                        c.gp, eps, c.qp_ws, c.qp_valid)
        X, U = st.X, st.U
        u0 = U[0]
        if self.K_fb is not None:
            u0 = u0 - (self.goal - X[0, 0]) @ self.K_fb.T
        x_next = self.env.discrete_dyn(X[0, 0], u0).reshape(-1)
        Xn, Un = self.shift(X, U) if self.spec.shift_soln else (X, U)
        out = Out(X, U, st.X_prev, st.U_prev, st.gp.hall_Z, st.gp.hall_Y,
                  st.it, st.alpha, st.status, st.qp_iters, x_next,
                  _ok(st.status, x_next, X, U))
        return Carry(x_next, Xn, Un, st.gp, st.qp_ws, st.qp_valid), out

    def launch_counts(self) -> dict:
        return self.routes.launch_counts()


class Reference:
    """``perfbench/reference`` in the program's place: the control of the
    correctness check, in the precision it is given."""

    def __init__(self, config_path: str, device, dtype):
        from perfbench.reference import mpc
        self.mpc = mpc
        self.device, self.dtype = torch.device(device), dtype
        self.model = mpc.Model.from_file(config_path, device, dtype)
        s = self.model.spec
        self.spec = s
        self.libraries = []
        self.sizes = dict(ns=s.ns, H=s.H, nx=s.nx, nu=s.nu, g_ny=s.g_ny,
                          Ty=s.Ty, max_sqp_iter=s.max_sqp_iter, beta=s.beta,
                          dt=s.dt)

    def build(self) -> None:
        pass

    def episode_start(self) -> Carry:
        X, U = self.mpc.init_iterate(self.model)
        return Carry(x=self.model.ocp.start.clone(), X=X, U=U)

    def step(self, c: Carry, eps):
        m = self.model
        r = self.mpc.solve(m, c.x, c.X, c.U, eps)
        x_next = m.plant.step(r.X[0, 0], self.mpc.applied_input(m, r.X, r.U))
        Xn, Un = self.mpc.shift(r.X, r.U) if self.spec.shift_soln else (r.X,
                                                                        r.U)
        out = Out(r.X, r.U, r.X_prev, r.U_prev, r.gp.hall_Z, r.gp.hall_Y, r.it,
                  r.alpha, r.status, r.qp_iters, x_next,
                  _ok(r.status, x_next, r.X, r.U))
        return Carry(x_next, Xn, Un), out

    def launch_counts(self) -> dict:
        return {}
