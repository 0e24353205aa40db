"""Uneven terrain: stepstones with rotated contact frames.

Port of `centroidal_mpc_tpu/contact/terrain.py` (host-side numpy, as
there).  A stone is a box whose top face is the plane through
``(cx, cy, height)`` with normal ``R e_z``, R = Ry(pitch) Rx(roll) (the
reference's Debris poses, src/contact_plan.py:8-37, and its stepstone
boxes, src/simulate_solo.py:55-75).  The contact-plan builder queries
`Terrain.surface_at` to snap each foothold onto the highest covering
surface, which gives the schedule raised contact points and rotated
contact frames; the solver's friction pyramids rotate with them.  The
dense plane set of the physics plant (`Terrain.arrays`) belongs to the
simulation and is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _rot_rp(roll: float, pitch: float) -> np.ndarray:
    """R = Ry(pitch) @ Rx(roll)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float64)
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float64)
    return ry @ rx


@dataclasses.dataclass(frozen=True)
class Stepstone:
    """One tilted stepstone, described by its top face."""

    center: Tuple[float, float]      # top-face center xy
    height: float                    # top-face center z
    size: Tuple[float, float] = (0.1, 0.1)   # footprint extents (lx, ly)
    roll: float = 0.0                # rotation about x [rad]
    pitch: float = 0.0               # rotation about y [rad]

    def rotation(self) -> np.ndarray:
        return _rot_rp(self.roll, self.pitch)

    def normal(self) -> np.ndarray:
        return self.rotation()[:, 2]

    def plane_height(self, x: float, y: float) -> float:
        """z of the top-face plane at (x, y)."""
        n = self.normal()
        cx, cy = self.center
        return self.height - (n[0] * (x - cx) + n[1] * (y - cy)) / n[2]

    def covers(self, x: float, y: float) -> bool:
        cx, cy = self.center
        return (abs(x - cx) <= 0.5 * self.size[0]
                and abs(y - cy) <= 0.5 * self.size[1])


@dataclasses.dataclass(frozen=True)
class Terrain:
    """Flat ground (z = 0, identity frame) plus optional stepstones."""

    stones: Tuple[Stepstone, ...] = ()

    def surface_at(self, x: float, y: float):
        """(z, R) of the highest surface covering (x, y)."""
        best_z, best_r = 0.0, np.eye(3)
        for stone in self.stones:
            if stone.covers(x, y):
                z = stone.plane_height(x, y)
                if z > best_z:
                    best_z, best_r = z, stone.rotation()
        return best_z, best_r


FLAT = Terrain()


def _q_to_rp(qx: float, qy: float) -> Tuple[float, float]:
    """Reference stepstone quaternions are (qx, qy, 0, 1) unnormalized
    (src/simulate_solo.py:225-255): roll = 2 atan(qx), pitch = 2 atan(qy)."""
    return 2.0 * float(np.arctan(qx)), 2.0 * float(np.arctan(qy))


def _ref_stone(start_pos, q) -> Stepstone:
    """The reference's build_one_stepstone(start_pos, orientation)
    (src/simulate_solo.py:55-75): the box spans [start_x, start_x +
    stone_length] with its top face at start_z."""
    roll, pitch = _q_to_rp(q[0], q[1])
    return Stepstone(center=(start_pos[0] + 0.05, start_pos[1]),
                     height=start_pos[2], size=(0.1, 0.1),
                     roll=roll, pitch=pitch)


# Reference per-gait debris layouts (src/simulate_solo.py:224-255).
TROT_DEBRIS = Terrain(stones=(
    _ref_stone((0.2, 0.15, 0.01), (0.1, -0.0)),
    _ref_stone((0.2, -0.15, 0.01), (-0.1, -0.0)),
    _ref_stone((0.45, 0.15, 0.02), (0.15, 0.0)),
    _ref_stone((0.44, -0.15, 0.02), (-0.15, 0.0)),
))

BOUND_DEBRIS = Terrain(stones=(
    _ref_stone((-0.15, 0.15, 0.02), (0.3, -0.0)),
    _ref_stone((-0.15, -0.15, 0.02), (-0.3, -0.0)),
    _ref_stone((0.12, 0.15, 0.02), (0.3, -0.0)),
    _ref_stone((0.12, -0.15, 0.02), (-0.3, -0.0)),
    _ref_stone((0.45, 0.15, 0.02), (-0.1, -0.0)),
    _ref_stone((0.45, -0.15, 0.02), (0.1, -0.0)),
    _ref_stone((0.75, -0.15, 0.02), (0.0, 0.0)),
    _ref_stone((0.75, 0.15, 0.02), (-0.0, 0.0)),
))

PACE_DEBRIS = Terrain(stones=(
    _ref_stone((0.15, 0.15, 0.02), (0.05, -0.0)),
    _ref_stone((0.15, -0.15, 0.02), (-0.05, -0.0)),
    _ref_stone((-0.25, 0.15, 0.02), (0.05, -0.0)),
    _ref_stone((-0.25, -0.15, 0.02), (-0.05, -0.0)),
))

DEBRIS_BY_GAIT = {"TROT": TROT_DEBRIS, "BOUND": BOUND_DEBRIS,
                  "PACE": PACE_DEBRIS}
