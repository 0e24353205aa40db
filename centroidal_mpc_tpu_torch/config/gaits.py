"""Gait specifications and phase-template expansion.

Mirrors the reference gait grammar (src/contact_plan.py:112-148): a gait is
{type, stepLength, stepHeight, stepKnots, supportKnots, nbSteps}; it expands
into a list of named phases, alternating double-support and stepping phases,
with the final step followed by a closing double support.
"""
from __future__ import annotations

import dataclasses
from typing import List

TROT = "TROT"
PACE = "PACE"
BOUND = "BOUND"

# Phase names follow the reference (src/contact_plan.py:115-148).  A phase
# name encodes which feet SWING during it; 'doubleSupport' means all feet
# planted.
DOUBLE_SUPPORT = "doubleSupport"


@dataclasses.dataclass(frozen=True)
class GaitSpec:
    """Declarative gait description (reference conf_solo12_trot.py:12-17)."""

    gait_type: str
    step_length: float
    step_height: float
    step_knots: int
    support_knots: int
    nb_steps: int

    def phase_templates(self, biped: bool) -> List[List[str]]:
        """Expand into per-step phase-name templates.

        Reference: src/contact_plan.py:113-148.  Each of the nb_steps step
        cycles contributes [DS, stepA, DS, stepB]; the last cycle appends a
        closing DS.
        """
        if self.gait_type == TROT:
            a, b = "rflhStep", "lfrhStep"
        elif self.gait_type == PACE:
            if biped:
                a, b = "rfStep", "lfStep"
            else:
                a, b = "rfrhStep", "lflhStep"
        elif self.gait_type == BOUND:
            a, b = "rflfStep", "rhlhStep"
        else:
            raise ValueError(f"unknown gait type {self.gait_type!r}")
        templates: List[List[str]] = []
        for step in range(self.nb_steps):
            if step < self.nb_steps - 1:
                templates.append([DOUBLE_SUPPORT, a, DOUBLE_SUPPORT, b])
            else:
                templates.append(
                    [DOUBLE_SUPPORT, a, DOUBLE_SUPPORT, b, DOUBLE_SUPPORT]
                )
        return templates

    def flat_phases(self, biped: bool) -> List[str]:
        return [p for template in self.phase_templates(biped) for p in template]

    def phase_knots(self, phase: str) -> int:
        return self.support_knots if phase == DOUBLE_SUPPORT else self.step_knots

    def horizon(self, biped: bool) -> int:
        """Total number of planning knots N (reference conf_solo12_trot.py:50)."""
        return sum(self.phase_knots(p) for p in self.flat_phases(biped))


# Which feet swing in each stepping phase, per foot-name convention.
# Quadruped foot order: FR, FL, HR, HL; biped: RF/FR first, LF/FL second.
SWING_FEET = {
    "rflhStep": ("FR", "HL"),
    "lfrhStep": ("FL", "HR"),
    "rfrhStep": ("FR", "HR"),
    "lflhStep": ("FL", "HL"),
    "rflfStep": ("FR", "FL"),
    "rhlhStep": ("HR", "HL"),
    "rfStep": ("RF", "FR"),
    "lfStep": ("LF", "FL"),
    DOUBLE_SUPPORT: (),
}

# Reference preset gaits.
SOLO12_TROT = GaitSpec(TROT, step_length=0.12, step_height=0.1,
                       step_knots=15, support_knots=5, nb_steps=4)
SOLO12_PACE = GaitSpec(PACE, step_length=0.0, step_height=0.05,
                       step_knots=10, support_knots=3, nb_steps=4)
SOLO12_BOUND = GaitSpec(BOUND, step_length=0.2, step_height=0.1,
                        step_knots=15, support_knots=5, nb_steps=4)
BOLT_PACE = GaitSpec(PACE, step_length=0.0, step_height=0.05,
                     step_knots=10, support_knots=2, nb_steps=5)
TALOS_PACE = GaitSpec(PACE, step_length=0.0, step_height=0.1,
                      step_knots=15, support_knots=5, nb_steps=4)

# Benchmark gait: N = 3*10 + 2*10 = 50 knots, the BASELINE.md horizon.
SOLO12_TROT_N50 = GaitSpec(TROT, step_length=0.12, step_height=0.1,
                           step_knots=10, support_knots=10, nb_steps=1)

# Reduced-scale demo/CI gait: one step-in-place trot cycle, N=18 knots.
# step_length=0 keeps the short horizon dynamically feasible (an
# aggressive step in so few knots violates the friction cone + vertical
# momentum budget and the QP correctly refuses to converge).
SOLO12_TROT_MINI = GaitSpec(TROT, step_length=0.0, step_height=0.05,
                            step_knots=6, support_knots=2, nb_steps=1)
