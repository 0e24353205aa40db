"""Swing-foot trajectory generation at the control rate (numpy).

Copy of `centroidal_mpc_tpu/contact/swing.py` (reference
src/contact_plan.py:70-110, compute_foot_traj).  For each phase: planted
feet hold their placement; swinging feet follow a quintic in x/y from
the previous phase's placement to the next phase's placement, and a
half-up / half-down quintic in z to step_height.  It reads only the
plan's host-side phases.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from centroidal_mpc_tpu_torch.contact.plan import ContactPlan
from centroidal_mpc_tpu_torch.utils.polynomials import poly5_traj


@dataclasses.dataclass(frozen=True)
class SwingTrajectories:
    """Per-foot control-rate end-effector references.

    pos/vel/acc: (C, 3, N_ctrl) arrays; foot order matches
    RobotSpec.foot_names.
    """

    pos: np.ndarray
    vel: np.ndarray
    acc: np.ndarray

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {"x": self.pos, "x_dot": self.vel, "x_ddot": self.acc}


def compute_swing_trajectories(plan: ContactPlan,
                               dt_ctrl: float) -> SwingTrajectories:
    n_ctrl = int(round(plan.phases[-1].t_end / dt_ctrl))
    n_c = plan.robot.n_contacts
    pos = np.zeros((n_c, 3, n_ctrl))
    vel = np.zeros((n_c, 3, n_ctrl))
    acc = np.zeros((n_c, 3, n_ctrl))
    phases = plan.phases
    step_height = plan.gait.step_height
    for i, ph in enumerate(phases):
        prev_ph = phases[i - 1] if i > 0 else ph
        next_ph = phases[i + 1] if i < len(phases) - 1 else ph
        t0 = int(round(ph.t_start / dt_ctrl))
        t1 = int(round(ph.t_end / dt_ctrl))
        n_phase = t1 - t0
        duration = ph.t_end - ph.t_start
        for c in range(n_c):
            if ph.active[c]:
                pos[c, :, t0:t1] = ph.positions[c][:, None]
                continue
            # swing: xy quintic from where the foot left (previous phase's
            # placement) to where it lands (next phase's placement)
            # (reference src/contact_plan.py:92-98)
            x0 = prev_ph.positions[c]
            x1 = next_ph.positions[c]
            xy, dxy, ddxy = poly5_traj(x0[:2], x1[:2], duration, dt_ctrl)
            m = min(xy.shape[1], n_phase)
            pos[c, :2, t0:t0 + m] = xy[:, :m]
            vel[c, :2, t0:t0 + m] = dxy[:, :m]
            acc[c, :2, t0:t0 + m] = ddxy[:, :m]
            # z: half the phase up to an apex, half back down (reference
            # src/contact_plan.py:99-108 does 0 -> step_height -> 0; on
            # uneven terrain the endpoints are the lift-off and landing
            # heights, and the apex clears the higher of the two)
            half = int(0.5 * n_phase)
            z_apex = max(x0[2], x1[2]) + step_height
            z_up, dz_up, ddz_up = poly5_traj(
                np.array([x0[2]]), np.array([z_apex]), 0.5 * duration, dt_ctrl)
            z_dn, dz_dn, ddz_dn = poly5_traj(
                np.array([z_apex]), np.array([x1[2]]), 0.5 * duration, dt_ctrl)
            mu = min(z_up.shape[1], half)
            md = min(z_dn.shape[1], n_phase - half)
            pos[c, 2, t0:t0 + mu] = z_up[0, :mu]
            vel[c, 2, t0:t0 + mu] = dz_up[0, :mu]
            acc[c, 2, t0:t0 + mu] = ddz_up[0, :mu]
            pos[c, 2, t0 + half:t0 + half + md] = z_dn[0, :md]
            vel[c, 2, t0 + half:t0 + half + md] = dz_dn[0, :md]
            acc[c, 2, t0 + half:t0 + half + md] = ddz_dn[0, :md]
    return SwingTrajectories(pos=pos, vel=vel, acc=acc)
