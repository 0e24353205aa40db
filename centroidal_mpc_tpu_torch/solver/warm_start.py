"""Analytic warm starts for the SCP solve.

Port of `centroidal_mpc_tpu/solver/warm_start.py`.  The two analytic
warm starts are computed in numpy from the schedule and returned as
tensors on the schedule's device; `ddp_warm_start` (the pipeline's stage
1) runs the iLQR of `solver/ddp.py` on the device of the model and
schedule it is given.
"""
from __future__ import annotations

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config.robots import POINT3, RobotSpec
from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import (CentroidalModel,
                                                        dynamics_step)
from centroidal_mpc_tpu_torch.solver.ddp import (DdpSettings, DdpSolution,
                                                 solve_ilqr, take)


def centroid_state_warm_start(robot: RobotSpec, schedule: ContactSchedule,
                              dtype=None) -> torch.Tensor:
    """(N+1, nx) state warm start: CoM above the active-contact centroid,
    zero momenta (reference src/centroidal_model.py:164-171)."""
    logic = schedule.logic.cpu().numpy()
    pos = schedule.position.cpu().numpy()
    n = logic.shape[0]
    X = np.zeros((n + 1, 9))
    n_active = np.maximum(logic.sum(axis=1), 1.0)
    centroid = (pos * logic[:, :, None]).sum(axis=1) / n_active[:, None]
    X[:n, 0] = centroid[:, 0]
    X[:n, 1] = centroid[:, 1]
    X[:n, 2] = robot.com_height + centroid[:, 2]
    X[n] = X[n - 1]
    return torch.as_tensor(X, dtype=dtype or schedule.logic.dtype,
                           device=schedule.logic.device)


def weight_distribution_control_warm_start(robot: RobotSpec,
                                           schedule: ContactSchedule,
                                           dtype=None) -> torch.Tensor:
    """(N, nu) control warm start: each active contact carries an equal
    share of the robot weight, with 1e-3 tangential forces (reference
    src/centroidal_model.py:176-183)."""
    logic = schedule.logic.cpu().numpy()
    n, c = logic.shape
    share = robot.weight_force / np.maximum(logic.sum(axis=1), 1.0)
    per_contact = np.zeros((n, c, robot.n_u_per_contact))
    fz_col = 2 if robot.contact_model == POINT3 else 4
    fx_col = 0 if robot.contact_model == POINT3 else 2
    per_contact[:, :, fx_col] = 1e-3 * logic
    per_contact[:, :, fx_col + 1] = 1e-3 * logic
    per_contact[:, :, fz_col] = share[:, None] * logic
    return torch.as_tensor(per_contact.reshape(n, robot.n_u),
                           dtype=dtype or schedule.logic.dtype,
                           device=schedule.logic.device)


def ddp_warm_start_solution(model: CentroidalModel, schedule: ContactSchedule,
                            robot: RobotSpec, state_weights=None,
                            control_weights=None,
                            settings: DdpSettings | None = None
                            ) -> DdpSolution:
    """The iLQR solve behind `ddp_warm_start`, with its iteration count,
    cost and gains."""
    dtype, device = schedule.logic.dtype, schedule.logic.device
    X_ref = centroid_state_warm_start(robot, schedule, dtype)
    U_ref = weight_distribution_control_warm_start(robot, schedule, dtype)
    wx = torch.as_tensor(state_weights if state_weights is not None
                         else [1e3] * 3 + [1e1] * 3 + [1e1] * 3,
                         dtype=dtype, device=device)
    wu = (torch.as_tensor(control_weights, dtype=dtype, device=device)
          if control_weights is not None
          else torch.full((robot.n_u,), 1e-3, dtype=dtype, device=device))

    def dynamics(x, u, k):
        return dynamics_step(model, x, u, take(schedule.position, k),
                             take(schedule.logic, k),
                             take(schedule.orientation, k))

    def stage_cost(x, u, k):
        dx = x - take(X_ref, k)
        du = u - take(U_ref, k)
        return torch.sum(wx * dx * dx) + torch.sum(wu * du * du)

    def terminal_cost(x):
        dx = x - X_ref[-1]
        return 10.0 * torch.sum(wx * dx * dx)

    return solve_ilqr(dynamics, stage_cost, terminal_cost, X_ref[0], U_ref,
                      settings or DdpSettings())


def ddp_warm_start(model: CentroidalModel, schedule: ContactSchedule,
                   robot: RobotSpec, state_weights=None,
                   control_weights=None,
                   settings: DdpSettings | None = None):
    """Dynamically consistent warm start by iLQR on the centroidal
    dynamics (the reference's stage-1 whole-body DDP role,
    run_motion.py:16-30): track the contact-centroid state path with
    control regularization around the weight-distribution heuristic.  The
    result is a rollout of the nonlinear dynamics, unlike the kinematic
    centroid path.  Runs on the device of `model` and `schedule`.
    Returns (X (N+1, nx), U (N, nu)) tensors there."""
    sol = ddp_warm_start_solution(model, schedule, robot, state_weights,
                                  control_weights, settings)
    return sol.X, sol.U
