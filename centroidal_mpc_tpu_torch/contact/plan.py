"""Contact-plan expansion: gait spec -> dense per-knot contact schedule.

Port of `centroidal_mpc_tpu/contact/plan.py`, with footholds snapped
onto terrain (`contact/terrain.py`).  The schedule is built in numpy and
handed over as tensors of one dtype on one device:

    logic:       (N, C)        1.0 where foot c is planted at knot k
    position:    (N, C, 3)     world-frame contact point (zeros when inactive)
    orientation: (N, C, 3, 3)  contact frame rotation (zeros when inactive)

The schedule is shared by every scenario of a batch, so it carries no
batch axis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config.gaits import SWING_FEET, GaitSpec
from centroidal_mpc_tpu_torch.config.robots import RobotSpec


@dataclasses.dataclass(frozen=True)
class ContactSchedule:
    """Dense per-knot contact data (tensors)."""

    logic: torch.Tensor        # (N, C)
    position: torch.Tensor     # (N, C, 3)
    orientation: torch.Tensor  # (N, C, 3, 3)

    @property
    def horizon(self) -> int:
        return self.logic.shape[0]

    @property
    def n_contacts(self) -> int:
        return self.logic.shape[1]

    def positions_flat(self) -> torch.Tensor:
        """(N, 3C) view (the reference's flattened contacts_position)."""
        n, c, _ = self.position.shape
        return self.position.reshape(n, c * 3)


@dataclasses.dataclass(frozen=True)
class Phase:
    """Host-side phase record (the reference's per-phase Debris group)."""

    name: str
    t_start: float
    t_end: float
    knot_start: int
    knot_end: int               # exclusive
    active: np.ndarray          # (C,) bool
    positions: np.ndarray       # (C, 3)
    rotations: Optional[np.ndarray] = None  # (C, 3, 3) contact frames


@dataclasses.dataclass(frozen=True)
class ContactPlan:
    """Full expansion of a gait: host-side phases + dense schedule."""

    robot: RobotSpec
    gait: GaitSpec
    dt: float
    phases: List[Phase]
    schedule: ContactSchedule

    @property
    def horizon(self) -> int:
        return self.schedule.horizon


def _foot_indices(robot: RobotSpec, swing_names: Sequence[str]) -> List[int]:
    return [i for i, name in enumerate(robot.foot_names) if name in swing_names]


def build_contact_plan(robot: RobotSpec, gait: GaitSpec, dt: float,
                       initial_foot_positions: Optional[np.ndarray] = None,
                       dtype: torch.dtype = torch.float32,
                       *, device, terrain=None) -> ContactPlan:
    """Expand a gait into phases and a dense contact schedule (same
    semantics as the JAX `build_contact_plan`: each phase lasts
    support_knots or step_knots, the named feet swing, and swung feet land
    step_length ahead along +x).  Flat ground gives identity contact
    frames; with a `terrain` (contact/terrain.Terrain) every foothold is
    snapped onto the highest covering surface, its z from the surface
    plane and its contact frame from the surface rotation (the
    reference's rotated-Debris pathway, src/contact_plan.py:8-37)."""
    if initial_foot_positions is None:
        foot_pos = robot.stance_positions_array().copy()
    else:
        foot_pos = np.array(initial_foot_positions, dtype=np.float64)
    n_c = robot.n_contacts
    biped = n_c == 2
    foot_rot = np.tile(np.eye(3), (n_c, 1, 1))

    def snap(c: int) -> None:
        if terrain is not None:
            z, r = terrain.surface_at(foot_pos[c, 0], foot_pos[c, 1])
            foot_pos[c, 2] = z
            foot_rot[c] = r

    for c in range(n_c):
        snap(c)

    phases: List[Phase] = []
    t_start = 0.0
    knot = 0
    for phase_name in gait.flat_phases(biped):
        knots = gait.phase_knots(phase_name)
        t_end = t_start + knots * dt
        swing = _foot_indices(robot, SWING_FEET[phase_name])
        active = np.ones(n_c, dtype=bool)
        active[swing] = False
        phases.append(Phase(name=phase_name, t_start=t_start, t_end=t_end,
                            knot_start=knot, knot_end=knot + knots,
                            active=active, positions=foot_pos.copy(),
                            rotations=foot_rot.copy()))
        for c in swing:
            foot_pos[c, 0] += gait.step_length
            snap(c)
        t_start = t_end
        knot += knots

    n = knot
    logic = np.zeros((n, n_c))
    position = np.zeros((n, n_c, 3))
    orientation = np.zeros((n, n_c, 3, 3))
    for ph in phases:
        sl = slice(ph.knot_start, ph.knot_end)
        logic[sl] = ph.active.astype(np.float64)
        for c in range(n_c):
            if ph.active[c]:
                position[sl, c] = ph.positions[c]
                orientation[sl, c] = ph.rotations[c]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    schedule = ContactSchedule(logic=t(logic), position=t(position),
                               orientation=t(orientation))
    return ContactPlan(robot=robot, gait=gait, dt=dt, phases=phases,
                       schedule=schedule)
