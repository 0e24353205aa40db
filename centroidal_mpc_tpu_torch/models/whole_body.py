"""Whole-body tracking layer: centroidal solution -> robot-ready joint
trajectories (the pipeline's kinematic stage 3).

Port of `centroidal_mpc_tpu/models/whole_body.py`.  The reference tracks
the SCP solution with Crocoddyl and exports 1 kHz joint positions,
velocities, feedforward torques and gains
(src/whole_body_control.py:434-488).  Here the same deliverable comes
from the closed-form leg model (models/kinematics.py) under the
massless-leg approximation the centroidal model already makes:

  base pose     <- interpolated CoM path (identity orientation)
  foot targets  <- contact placements (stance) / swing references (flight)
  joints        <- closed-form IK, one call over every control knot
  velocities    <- central finite differences at dt_ctrl
  tau_ff        <- -J(q)' f from the SCP contact forces (ZOH)
  gains         <- the reference simulator's per-gait PD gains
                   (src/simulate_solo.py:303-308)

Everything is computed on the device of the solution X.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from centroidal_mpc_tpu_torch.contact.plan import ContactPlan
from centroidal_mpc_tpu_torch.contact.swing import SwingTrajectories
from centroidal_mpc_tpu_torch.models import kinematics as kin

# Reference PD gains per gait (src/simulate_solo.py:303-330).
PD_GAINS = {"TROT": (4.0, 0.2), "PACE": (4.0, 0.2), "BOUND": (3.0, 0.2)}


@dataclasses.dataclass(frozen=True)
class WholeBodyTrajectory:
    """1 kHz whole-body references (the reference's
    wholeBody_interpolated_traj payload, run_motion.py:68-72)."""

    base_pos: torch.Tensor  # (T, 3)
    q: torch.Tensor         # (T, 3 n_legs) joint positions (leg-major)
    qdot: torch.Tensor      # (T, 3 n_legs)
    tau_ff: torch.Tensor    # (T, 3 n_legs) feedforward torques
    feet: torch.Tensor      # (T, n_legs, 3) world foot targets
    kp: torch.Tensor        # scalar PD gains
    kd: torch.Tensor


def track_centroidal_solution(plan: ContactPlan, swing: SwingTrajectories,
                              X: torch.Tensor, U: torch.Tensor,
                              dt_ctrl: float,
                              geom: kin.LegGeometry = kin.SOLO12_LEGS,
                              base_height_offset: float = 0.0,
                              ) -> WholeBodyTrajectory:
    """Map an SCP solution X (N+1, 9), U (N, nu) to whole-body joint
    trajectories at dt_ctrl."""
    n = plan.horizon
    n_legs = geom.n_legs
    n_inner = int(round(plan.dt / dt_ctrl))
    t_total = n * n_inner
    dtype, device = X.dtype, X.device

    # base path: linear interpolation of the CoM (identity orientation)
    frac = torch.arange(n_inner, dtype=dtype, device=device) / n_inner
    com = X[:, :3]
    base = (com[:-1, None, :]
            + frac[None, :, None] * (com[1:, None, :] - com[:-1, None, :]))
    base = base.reshape(t_total, 3)
    base = base + torch.tensor([0.0, 0.0, base_height_offset], dtype=dtype,
                               device=device)

    # world foot targets: stance -> placement, swing -> swing reference
    sched = plan.schedule
    logic_ctrl = sched.logic.to(device, dtype).repeat_interleave(n_inner, 0)
    pos_ctrl = sched.position.to(device, dtype).repeat_interleave(n_inner, 0)
    swing_pos = torch.as_tensor(np.asarray(swing.pos), dtype=dtype,
                                device=device).permute(2, 0, 1)[:t_total]
    feet_world = torch.where(logic_ctrl[:, :, None] > 0, pos_ctrl, swing_pos)

    # IK at every control knot: one call over the time axis
    q_legs = kin.ik_all_legs(feet_world - base[:, None, :], geom)

    # velocities: central differences, one-sided at the ends
    qd = (torch.roll(q_legs, -1, dims=0) - torch.roll(q_legs, 1, dims=0)) / (
        2 * dt_ctrl)
    qd = torch.cat([((q_legs[1] - q_legs[0]) / dt_ctrl)[None], qd[1:-1],
                    ((q_legs[-1] - q_legs[-2]) / dt_ctrl)[None]])

    # feedforward torques from the planned contact forces (ZOH)
    forces_ctrl = U.reshape(n, n_legs, 3).repeat_interleave(n_inner, 0)
    forces_ctrl = forces_ctrl * logic_ctrl[:, :, None]
    tau = kin.feet_contact_torques(q_legs, forces_ctrl, geom)

    kp, kd = PD_GAINS.get(plan.gait.gait_type, (4.0, 0.2))
    nj = 3 * n_legs
    return WholeBodyTrajectory(
        base_pos=base, q=q_legs.reshape(t_total, nj),
        qdot=qd.reshape(t_total, nj), tau_ff=tau.reshape(t_total, nj),
        feet=feet_world, kp=torch.tensor(kp, dtype=dtype, device=device),
        kd=torch.tensor(kd, dtype=dtype, device=device))


def export_robot_dat(traj: WholeBodyTrajectory, out_dir) -> Dict[str, str]:
    """Write the robot-ready .dat files the reference exports
    (src/whole_body_control.py:478-488): one row a control knot, the
    index followed by the joint values."""
    from pathlib import Path
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, arr in [("quadruped_positions", traj.q),
                      ("quadruped_velocities", traj.qdot),
                      ("quadruped_feedforward_torque", traj.tau_ff)]:
        a = arr.detach().cpu().numpy()
        data = np.hstack([np.arange(a.shape[0])[:, None], a])
        path = out / f"{name}.dat"
        np.savetxt(path, data, fmt="%.18e")
        files[name] = str(path)
    return files
