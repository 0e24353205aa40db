"""Analytic warm starts for the SCP solve.

Port of `centroid_state_warm_start` and
`weight_distribution_control_warm_start` from
`centroidal_mpc_tpu/solver/warm_start.py`.  Both are computed in numpy
from the schedule and returned as tensors on the schedule's device.
The DDP warm start is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config.robots import POINT3, RobotSpec
from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule


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
