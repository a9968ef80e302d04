"""Closed-loop receding-horizon MPC driver.

Counterpart of the reference DEMPC orchestrator (ref: src/DEMPC.py:12-112):
the host loop steps the true plant and re-runs the SQP solve; the next
solve starts from the shifted solution (ref: src/solver.py:174-189) and the
QP warm start carries across MPC steps.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from sampling_gpmpc_torch import agent as agent_mod
from sampling_gpmpc_torch import setup
from sampling_gpmpc_torch.config import ProblemData, ProblemSpec
from sampling_gpmpc_torch.envs.base import Env
from sampling_gpmpc_torch.gp.exact import GPHyperArrays
from sampling_gpmpc_torch.gp.kernel import kernel_matrix
from sampling_gpmpc_torch.ocp import sqp
from sampling_gpmpc_torch.ocp.spec import make_ocp_data
from sampling_gpmpc_torch.reachability import reject_and_resample
from sampling_gpmpc_torch.utils.termcolor import bcolors


def shift_solution(X, U):
    """Warm-start shift (ref: src/solver.py:174-178): stages move one step
    forward; the terminal state and last input are repeated."""
    return torch.cat([X[1:], X[-1:]], dim=0), torch.cat([U[1:], U[-1:]], dim=0)


class DEMPC:
    """Owns the problem tensors and the closed-loop state.

    Args:
        device, dtype: where and in which precision the loop runs (CUDA and
            float32 by default; see setup.resolve).
        epistemic: optional (num_mpc_iter, max_sqp_iter, ns, g_ny, H, Ty)
            base draws; drawn from a generator seeded with the config's
            seed when absent.
    """

    def __init__(self, params: dict, spec: ProblemSpec, data: ProblemData,
                 env: Env, device=None, dtype=None, recorder=None,
                 verbose=False, epistemic=None):
        self.device, self.dtype = setup.resolve(device, dtype)
        self.verbose = verbose
        self.spec, self.data, self.env = spec, data, env
        self.ocp = make_ocp_data(spec, data, self.device, self.dtype)
        self.hyp = GPHyperArrays.from_spec(spec.gp, self.device, self.dtype)
        self.gp_state = agent_mod.init_gp_state(spec, env, self.device,
                                                self.dtype, hyp=self.hyp)
        if epistemic is None:
            epistemic = agent_mod.make_epistemic(spec, None, self.device,
                                                 self.dtype)
        elif not isinstance(epistemic, torch.Tensor):
            epistemic = torch.from_numpy(np.array(epistemic))
        self.epistemic = epistemic.to(dtype=self.dtype, device=self.device)
        self.recorder = recorder
        if spec.dynamics_rejection:
            tight = params["agent"]["tight"]
            Bd_norm = float(np.sqrt(data.P_term[1][1]))
            self._var_eps = (float(tight["dyn_eps"])
                             + float(tight["w_bound"])) * Bd_norm
            self._reject_fb = ({"K": data.K_fb, "x_eq": data.goal}
                               if spec.use_feedback else None)
            self._reject_gen = torch.Generator().manual_seed(spec.seed + 1)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _realized_input(self, x, u):
        if not self.spec.use_feedback:
            return u
        return u - (self.ocp.x_eq - x) @ self.ocp.K_fb.T

    def record_rollouts(self, x0, U):
        """The plan's inputs rolled through (a) the true dynamics — the
        linearization-error probe (ref: src/visu.py:486-491) — and (b) the
        real-data GP posterior-mean dynamics (ref: src/visu.py:235-258)."""
        spec, env, hyp, gp = self.spec, self.env, self.hyp, self.gp_state
        rf = gp.real_fact
        alpha = rf["mask"] * torch.linalg.solve_triangular(
            rf["L"].transpose(-1, -2), rf["w"][..., None], upper=True)[..., 0]
        x0, U = self._tensor(x0), self._tensor(U)
        xt, xm = x0, x0
        true_traj, mean_traj = [x0], [x0]
        for k in range(U.shape[0]):
            xt = env.discrete_dyn(xt, self._realized_input(xt, U[k]))
            xu = torch.cat([xm, self._realized_input(xm, U[k])])
            z = env.g_inputs(xu)[None]
            dg = torch.stack([
                (kernel_matrix(z, gp.real_Z, hyp.lengthscale[j],
                               hyp.outputscale[j], spec.use_derivatives)
                 @ alpha[j])[:spec.Ty] for j in range(spec.g_ny)])
            xm = env.assemble_val_jac(xu, dg)[:, 0]
            true_traj.append(xt)
            mean_traj.append(xm)
        return (torch.stack(true_traj).cpu().numpy(),
                torch.stack(mean_traj).cpu().numpy())

    def run(self, x0: Optional[np.ndarray] = None):
        """Full closed loop (ref: src/DEMPC.py:39-80). Returns trajectories."""
        spec = self.spec
        x_curr = self._tensor(x0 if x0 is not None else self.data.start)
        X, U = sqp.init_iterate(spec, self.device, self.dtype, self.data.start)
        qp_ws = sqp.init_qp_ws(spec, self.device, self.dtype)
        qp_valid = torch.zeros((), dtype=torch.bool, device=self.device)
        phys, inputs, plans, times, survivors = [], [], [], [], []
        qp_iters, statuses, gaps = [], [], []
        for m in range(spec.num_mpc_iter):
            t0 = time.perf_counter()
            st = sqp.solve(spec, self.env, self.hyp, self.ocp, x_curr, X, U,
                           self.gp_state, self.epistemic[m], qp_ws, qp_valid)
            status = int(st.status)          # waits for the device
            dt_solve = time.perf_counter() - t0
            qp_ws, qp_valid = st.qp_ws, st.qp_valid
            X, U, self.gp_state = st.X, st.U, st.gp
            u0 = self._realized_input(X[0, 0], U[0])
            x_next = self.env.discrete_dyn(X[0, 0], u0)

            phys.append(x_curr.cpu().numpy())
            inputs.append(U.cpu().numpy())
            plans.append(X.cpu().numpy())
            times.append(dt_solve)
            qp_iters.append(int(st.qp_iters))
            statuses.append(status)
            gaps.append(float(st.qp_gap))
            if self.verbose:
                print(f"{bcolors.green}Reached: {m} "
                      f"{np.round(phys[-1], 4)} "
                      f"u0={np.round(u0.cpu().numpy(), 4)} "
                      f"sqp_iters={st.it} status={status} "
                      f"solve={dt_solve:.3f}s{bcolors.ENDC}")
            if self.recorder is not None:
                self.recorder.record(phys[-1], plans[-1], inputs[-1],
                                     dt_solve, self)
            x_curr = x_next.reshape(-1)
            if spec.dynamics_rejection:
                self.gp_state, n_alive = reject_and_resample(
                    spec, self.env, self.hyp, self.gp_state, X, U, x_curr,
                    self.data.ci, self._var_eps, self._reject_gen,
                    use_feedback=self._reject_fb)
                survivors.append(n_alive)
                if self.verbose:
                    # per-step survivor count (ref: src/agent.py:354,394)
                    print(f"{bcolors.OKCYAN}Samples remaining in N(k+1): "
                          f"{n_alive}/{spec.ns}{bcolors.ENDC}")
            if spec.shift_soln:
                X, U = shift_solution(X, U)

        return {
            "physical_state_traj": phys,
            "input_traj": inputs,
            "state_traj": plans,
            "solver_time": times,
            "final_state": x_curr.cpu().numpy(),
            "sqp_iters": st.it,
            "sqp_status": int(st.status),
            "sqp_done": bool(st.done),
            "qp_iters": qp_iters,
            "sqp_status_traj": statuses,
            "qp_gap_traj": gaps,
            "rejection_survivors": survivors,
        }
