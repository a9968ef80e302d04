"""Trajectory recording + data.pkl-compatible artifact persistence.

Mirrors the reference Visualizer's record/save_data contract
(ref: src/visu.py:475-517) so that downstream tooling (visualization,
benchmarking replay, convex-hull aggregation) can resume from the same
artifact keys: state_traj, input_traj, physical_state_traj,
true_state_traj, mean_state_traj, solver_time, GP train-data snapshots,
tightenings.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


class Recorder:
    def __init__(self, params: dict, path: Optional[str] = None):
        self.params = params
        self.save_path = path
        self.state_traj = []
        self.input_traj = []
        self.mean_state_traj = []
        self.true_state_traj = []
        self.physical_state_traj = []
        self.solver_time = []
        self.gp_model_after_solve_train_X = []
        self.gp_model_after_solve_train_Y = []
        self.tilde_eps_list = None
        self.ci_list = None

    def record(self, x_curr, X, U, solve_time, mpc=None):
        """Per-MPC-step record (ref: src/visu.py:475-495).

        Args:
            x_curr: (nx,) measured state.
            X: (H+1, ns, nx) planned states; stored in the reference's
               (H+1, ns*nx) layout.
            U: (H, nu) planned inputs.
            mpc: optional DEMPC instance for true-dynamics re-propagation
                 and GP snapshotting.
        """
        ns = X.shape[1]
        spec = mpc.spec if mpc is not None else None
        self.physical_state_traj.append(np.tile(np.asarray(x_curr), ns))
        self.state_traj.append(np.asarray(X).reshape(X.shape[0], -1))
        self.input_traj.append(np.asarray(U))
        self.solver_time.append(solve_time)

        if mpc is not None:
            # roll the plan's input sequence through the true dynamics (the
            # linearization-error probe, ref: src/visu.py:486-491) and the
            # real-data GP posterior-mean dynamics (ref: src/visu.py:235-258)
            true_traj, mean_traj = mpc.record_rollouts(X[0, 0], U)
            self.true_state_traj.append(true_traj)
            self.mean_state_traj.append(mean_traj)

            gp = mpc.gp_state
            n = gp.hall_n
            self.gp_model_after_solve_train_X.append(
                gp.hall_Z[:, :, :n].cpu().numpy())
            self.gp_model_after_solve_train_Y.append(
                gp.hall_Y[:, :, :n].cpu().numpy())

    def save_data(self, path: Optional[str] = None):
        path = path or self.save_path
        os.makedirs(path, exist_ok=True)
        data_dict = {
            "state_traj": self.state_traj,
            "input_traj": self.input_traj,
            "mean_state_traj": self.mean_state_traj,
            "true_state_traj": self.true_state_traj,
            "physical_state_traj": self.physical_state_traj,
            "solver_time": self.solver_time,
            "gp_model_after_solve_train_X": self.gp_model_after_solve_train_X,
            "gp_model_after_solve_train_Y": self.gp_model_after_solve_train_Y,
            "tilde_eps_list": self.tilde_eps_list,
            "ci_list": self.ci_list,
        }
        with open(os.path.join(path, "data.pkl"), "wb") as f:
            pickle.dump(data_dict, f)
        return os.path.join(path, "data.pkl")
