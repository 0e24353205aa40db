"""Robot specifications for the centroidal OCP.

The reference obtains robot data (mass, foot frames, initial foot placements)
at config-import time via pinocchio + example_robot_data URDF loading
(reference: config/conf_solo12_trot.py:21-47).  That makes configs non-hermetic
and host-bound.  Here a robot is a small frozen dataclass of plain numbers:
everything the centroidal layer actually consumes (mass, contact count/order,
per-contact control parameterization, stance foot placements) is declarative,
so problem construction is pure and jit/shard friendly.

Contact models
--------------
``point3``  -- per-contact control is a 3D force f = (fx, fy, fz); used by
              quadrupeds (solo12) and point-foot bipeds (bolt).
              (reference: src/centroidal_model.py:104-107, 201-203)
``wrench6`` -- per-contact control is (cop_x, cop_y, fx, fy, fz, tau_z) for
              flat-foot humanoids (Talos).
              (reference: src/centroidal_model.py:104-119, 204-208)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

POINT3 = "point3"
WRENCH6 = "wrench6"

N_X = 9  # centroidal state: com(3), linear momentum(3), angular momentum(3)


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    """Declarative robot description for the centroidal layer.

    Attributes:
      name: robot identifier ('solo12' | 'talos' | 'bolt').
      contact_model: POINT3 or WRENCH6.
      foot_names: contact names in *control-vector order*.  The reference
        orders solo12 contacts FR, FL, HR, HL (Debris.idx mapping at
        src/contact_plan.py:29-37 matches the dict insertion order at
        :163-172), so u = [f_FR, f_FL, f_HR, f_HL].
      mass: total robot mass [kg].
      com_height: nominal standing CoM height [m].
      max_leg_length: kinematic leg-length bound [m] (reference
        conf_solo12_trot.py:30, used by the com-reachability constraint).
      stance_foot_positions: (C, 3) world-frame foot placements in the
        nominal standing configuration.  The reference computes these with
        pinocchio forward kinematics of q0 (src/contact_plan.py:149-155);
        here they are constants of the spec.
      foot_half_dims: (lxp, lxn, lyp, lyn) CoP box half-extents [m]; only
        meaningful for WRENCH6 robots (reference conf_solo12_trot.py:32-35).
    """

    name: str
    contact_model: str
    foot_names: Tuple[str, ...]
    mass: float
    com_height: float
    max_leg_length: float
    stance_foot_positions: Tuple[Tuple[float, float, float], ...]
    foot_half_dims: Tuple[float, float, float, float] = (0.01, 0.01, 0.01, 0.01)
    gravity: float = -9.81

    @property
    def n_contacts(self) -> int:
        return len(self.foot_names)

    @property
    def n_u_per_contact(self) -> int:
        return 3 if self.contact_model == POINT3 else 6

    @property
    def n_x(self) -> int:
        return N_X

    @property
    def n_u(self) -> int:
        return self.n_contacts * self.n_u_per_contact

    @property
    def n_w(self) -> int:
        """Number of contact-position noise parameters (reference
        conf_solo12_trot.py:66)."""
        return self.n_contacts * 3

    def stance_positions_array(self) -> np.ndarray:
        return np.asarray(self.stance_foot_positions, dtype=np.float64)

    @property
    def weight_force(self) -> float:
        """Magnitude of the gravity force the contacts must support,
        -m*g (reference src/centroidal_model.py:176)."""
        return -self.mass * self.gravity


# Solo12 quadruped.  Mass and standing geometry approximate the
# example_robot_data 'solo12' model in its initial configuration with the
# base x set to 0 (reference conf_solo12_trot.py:25-28, 45-46): feet sit
# under the hips at x = +-0.1946, y = +-0.14695, on the ground plane.
SOLO12 = RobotSpec(
    name="solo12",
    contact_model=POINT3,
    foot_names=("FR", "FL", "HR", "HL"),
    mass=2.5,
    com_height=0.25,
    max_leg_length=0.34,
    stance_foot_positions=(
        (0.1946, -0.14695, 0.0),
        (0.1946, 0.14695, 0.0),
        (-0.1946, -0.14695, 0.0),
        (-0.1946, 0.14695, 0.0),
    ),
)

# Talos humanoid (legs model).  The reference ships only gait + whole-body
# weights for Talos (conf_talos.py) and relies on TALOS branches in the
# centroidal layer; the centroidal-complete spec here fills that gap
# (SURVEY.md section 2a row 10).  Foot half-dims follow the reference foot
# box defaults; mass approximates the talos_legs reduced model.
TALOS = RobotSpec(
    name="talos",
    contact_model=WRENCH6,
    foot_names=("RF", "LF"),
    mass=45.0,
    com_height=0.87,
    max_leg_length=1.0,
    stance_foot_positions=(
        (0.0, -0.085, 0.0),
        (0.0, 0.085, 0.0),
    ),
    foot_half_dims=(0.1, 0.1, 0.05, 0.05),
)

# Bolt point-foot biped (reference conf_bolt.py; centroidal-complete here).
BOLT = RobotSpec(
    name="bolt",
    contact_model=POINT3,
    foot_names=("FL", "FR"),
    mass=1.3,
    com_height=0.35487417,
    max_leg_length=0.4,
    stance_foot_positions=(
        (0.0, 0.1235, 0.0),
        (0.0, -0.1235, 0.0),
    ),
)

ROBOTS = {"solo12": SOLO12, "talos": TALOS, "bolt": BOLT}
