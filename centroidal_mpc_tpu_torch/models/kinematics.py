"""Closed-form leg kinematics for point-foot robots (solo12, bolt).

Port of `centroidal_mpc_tpu/models/kinematics.py`.  3-DoF point-foot legs
(hip abduction HAA about x, hip flexion HFE and knee KFE about y) have
closed-form FK and IK (the reference asks pinocchio per knot,
src/contact_plan.py:149-155, src/simulate_solo.py:146-160).  Every
function takes any number of leading axes: q (..., 3) a leg, q_legs
(..., n_legs, 3) a robot, so a whole 1 kHz trajectory is one call over a
leading time axis.  The leg Jacobian is `torch.func.jacfwd` of the FK.

Conventions: base frame at the base link, x forward, z up.  Leg order
matches RobotSpec.foot_names (solo12: FR, FL, HR, HL; bolt: FL, FR).
Zero configuration = straight legs pointing down.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap


@dataclasses.dataclass(frozen=True)
class LegGeometry:
    """Point-foot leg geometry (meters), approximating URDF parameters.

    hip_x/hip_y: HAA joint position in the base frame; y_off: lateral
    offset from the HAA axis to the leg's sagittal plane; l_upper/l_lower:
    link lengths.  By default the hips form the solo12 quadruped layout
    (FR, FL, HR, HL); `hips`/`sides` override it for other morphologies
    (e.g. the 2-legged bolt).
    """

    hip_x: float = 0.1946
    hip_y: float = 0.0875
    y_off: float = 0.05945
    l_upper: float = 0.160
    l_lower: float = 0.160
    hips: Optional[Tuple[Tuple[float, float, float], ...]] = None
    sides: Optional[Tuple[float, ...]] = None

    @property
    def n_legs(self) -> int:
        return 4 if self.hips is None else len(self.hips)

    def hip_positions(self) -> np.ndarray:
        """(n_legs, 3) HAA origins in the base frame."""
        if self.hips is not None:
            return np.asarray(self.hips, np.float64)
        return np.array([
            [self.hip_x, -self.hip_y, 0.0],
            [self.hip_x, self.hip_y, 0.0],
            [-self.hip_x, -self.hip_y, 0.0],
            [-self.hip_x, self.hip_y, 0.0],
        ])

    def side_signs(self) -> np.ndarray:
        """(n_legs,) +1 left / -1 right lateral offset signs."""
        if self.sides is not None:
            return np.asarray(self.sides, np.float64)
        return np.array([-1.0, 1.0, -1.0, 1.0])


SOLO12_LEGS = LegGeometry()

# Bolt point-foot biped (reference conf_bolt.py; FL, FR order from its
# ee_frame_names).  The HAA origins put the legs above the nominal stance
# of config/robots.py:BOLT; the 0.25 m segments make BOLT's com_height
# (0.355 m, the reference q0 base height) reachable with the mass
# distribution of rigid_body.bolt_spec.
BOLT_LEGS = LegGeometry(
    hip_x=0.0, hip_y=0.1235, y_off=0.0, l_upper=0.25, l_lower=0.25,
    hips=((0.0, 0.1235, 0.0), (0.0, -0.1235, 0.0)),
    sides=(1.0, -1.0))


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def leg_fk(q: torch.Tensor, side, geom: LegGeometry = SOLO12_LEGS
           ) -> torch.Tensor:
    """Foot position in the HIP frame: q (..., 3) = (haa, hfe, kfe), side
    (...) = +-1 (lateral offset sign).  The sagittal chain hangs below the
    HFE axis; HAA rotates its plane about the base x axis."""
    haa, hfe, kfe = q[..., 0], q[..., 1], q[..., 2]
    # the lengths as tensors of q's dtype: under jacfwd a Python float
    # times a 0-d tensor promotes the Jacobian to float64
    l1, l2 = _like(geom.l_upper, q), _like(geom.l_lower, q)
    px = -(l1 * torch.sin(hfe) + l2 * torch.sin(hfe + kfe))
    pz = -(l1 * torch.cos(hfe) + l2 * torch.cos(hfe + kfe))
    py = side * _like(geom.y_off, q)
    c, s = torch.cos(haa), torch.sin(haa)
    return torch.stack([px, c * py - s * pz, s * py + c * pz], dim=-1)


def leg_ik(p_hip: torch.Tensor, side, knee_sign: float = 1.0,
           geom: LegGeometry = SOLO12_LEGS) -> torch.Tensor:
    """Closed-form IK: foot position in the hip frame (..., 3) -> (haa,
    hfe, kfe).  knee_sign selects the knee-bent-backward (+1) or forward
    (-1) branch.  Unreachable targets are clamped to the workspace
    boundary; the below-hip branch is assumed (targets above the hip
    plane resolve to their below-plane mirror)."""
    x, y, z = p_hip[..., 0], p_hip[..., 1], p_hip[..., 2]
    side = _like(side, p_hip)
    # HAA from the lateral plane: rotate (y, z) so the leg plane sits at
    # lateral offset side*y_off; the in-plane vertical reach is
    # sqrt(y^2 + z^2 - y_off^2)
    r_sq = y * y + z * z
    zeta = torch.sqrt(torch.clamp(r_sq - geom.y_off ** 2, min=1e-12))
    haa = torch.atan2(z, y) - torch.atan2(-zeta, side * geom.y_off)
    haa = torch.atan2(torch.sin(haa), torch.cos(haa))      # wrap to [-pi, pi]
    # planar 2-link IK in the leg plane with extension d
    d = torch.sqrt(torch.clamp(x * x + zeta * zeta, min=1e-12))
    l1, l2 = geom.l_upper, geom.l_lower
    d = torch.clamp(d, abs(l1 - l2) + 1e-9, l1 + l2 - 1e-9)
    cos_knee = (d * d - l1 * l1 - l2 * l2) / (2.0 * l1 * l2)
    kfe = knee_sign * torch.arccos(torch.clamp(cos_knee, -1.0, 1.0))
    alpha = torch.atan2(-x, zeta)   # angle of the target from straight down
    beta = torch.atan2(l2 * torch.sin(kfe), l1 + l2 * torch.cos(kfe))
    return torch.stack([haa, alpha - beta, kfe], dim=-1)


def leg_jacobian(q: torch.Tensor, side, geom: LegGeometry = SOLO12_LEGS
                 ) -> torch.Tensor:
    """(..., 3, 3) foot-position Jacobian d p_hip / d q (forward-mode AD
    of the closed-form FK, vmapped over the leading axes)."""
    side = _like(side, q).expand(q.shape[:-1])
    lead = q.shape[:-1]
    jac = vmap(jacfwd(lambda qq, s: leg_fk(qq, s, geom)))(
        q.reshape(-1, 3), side.reshape(-1))
    return jac.reshape(lead + (3, 3))


def fk_all_legs(q_legs: torch.Tensor,
                geom: LegGeometry = SOLO12_LEGS) -> torch.Tensor:
    """(..., n_legs, 3) base-frame foot positions from (..., n_legs, 3)
    joint angles."""
    hips = _like(geom.hip_positions(), q_legs)
    sides = _like(geom.side_signs(), q_legs)
    return hips + leg_fk(q_legs, sides, geom)


def ik_all_legs(feet_base: torch.Tensor,
                geom: LegGeometry = SOLO12_LEGS) -> torch.Tensor:
    """(..., n_legs, 3) joint angles from (..., n_legs, 3) base-frame foot
    targets."""
    hips = _like(geom.hip_positions(), feet_base)
    sides = _like(geom.side_signs(), feet_base)
    return leg_ik(feet_base - hips, sides, 1.0, geom)


def feet_contact_torques(q_legs: torch.Tensor, forces: torch.Tensor,
                         geom: LegGeometry = SOLO12_LEGS) -> torch.Tensor:
    """(..., n_legs, 3) joint torques realizing base-frame contact forces:
    tau_leg = -J_leg' f_leg (the reaction; the reference applies -Jc' K dh
    as its centroidal correction, src/simulate_solo.py:295-296)."""
    sides = _like(geom.side_signs(), q_legs)
    jacs = leg_jacobian(q_legs, sides, geom)
    return -torch.einsum("...ij,...i->...j", jacs, forces)
