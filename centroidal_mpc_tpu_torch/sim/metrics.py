"""Evaluation metrics over Monte-Carlo rollouts.

Port of `centroidal_mpc_tpu/sim/metrics.py`, the vectorized equivalents
of the reference's analysis suite:
  * cumulative centroidal tracking cost mean/std across sims
    (src/utils.py:245-302);
  * friction-pyramid violation/saturation counters
    (src/constraints.py:298-335, evaluate_friction_pyramid_constraints);
  * tangential/vertical force ratios (src/utils.py:116-243).
"""
from __future__ import annotations

from typing import Dict

import torch

from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule

# Reference checker tolerances (src/constraints.py:327-328).
VIOLATION_TOL = 5e-5
SATURATION_TOL = 1e-6


def cumulative_tracking_cost(Q: torch.Tensor, X_sim: torch.Tensor,
                             X_ref: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Cumulative per-knot tracking cost statistics across sims.

    X_sim (S, N+1, nx), X_ref (N+1, nx).  Returns the cumulative mean and
    the cumulative (population) std over time, (N+1,), matching the
    reference's accumulation (src/utils.py:266-284), and the per-knot
    cost (S, N+1).
    """
    dx = X_sim - X_ref[None]
    j = torch.einsum("ski,ij,skj->sk", dx, Q, dx)
    return {
        "cum_mean": torch.cumsum(j.mean(dim=0), dim=0),
        "cum_std": torch.cumsum(j.std(dim=0, correction=0), dim=0),
        "per_knot": j,
    }


def _forces(schedule: ContactSchedule, U: torch.Tensor) -> torch.Tensor:
    """U (..., N, nu) point3 forces as (..., N, C, 3)."""
    n, c = schedule.logic.shape
    return U.reshape(U.shape[:-2] + (n, c, 3))


def friction_cone_stats(pyramid: torch.Tensor, schedule: ContactSchedule,
                        U: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Violation / saturation counts of the rotated friction pyramid.

    pyramid (5, 3); U (..., N, nu) forces (point3 layout).  Counts rows
    with G R' f > tol (violations) and |G R' f| <= sat_tol (saturations)
    over all 5 pyramid rows at active contacts, like the reference's
    checker (which, unlike its constraint assembly, uses all 5 rows).
    """
    rot_pyr = torch.einsum("ri,kcji->kcrj", pyramid, schedule.orientation)
    lhs = torch.einsum("kcrj,...kcj->...kcr", rot_pyr, _forces(schedule, U))
    active = schedule.logic[:, :, None] > 0
    return {
        "violations": ((lhs > VIOLATION_TOL) & active).sum((-1, -2, -3)),
        "saturations": ((lhs.abs() <= SATURATION_TOL) & active).sum(
            (-1, -2, -3)),
    }


def tangential_ratio(schedule: ContactSchedule,
                     U: torch.Tensor) -> torch.Tensor:
    """|f_tangential| / f_z at active contacts (nan where swinging), the
    quantity plotted against mu in the paper's force figures
    (src/utils.py:215-221).  U (..., N, nu) -> (..., N, C)."""
    F = _forces(schedule, U)
    ratio = (torch.linalg.vector_norm(F[..., :2], dim=-1)
             / F[..., 2].clamp(min=1e-9))
    return torch.where(schedule.logic > 0, ratio,
                       torch.full_like(ratio, float("nan")))
