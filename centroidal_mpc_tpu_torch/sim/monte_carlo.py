"""Batched Monte-Carlo closed-loop evaluation on the centroidal model.

Port of `centroidal_mpc_tpu/sim/monte_carlo.py`.  The reference validates
a solution with sequential rollouts under random pushes
(src/simulate_solo.py:184-344): a force drawn from N(0, 15 I) is applied
along y for 200 ms from a random start, while an LQR correction tracks
the plan.  Here every sim runs at once: one loop over the knots carries
the states of all S sims.  The rollout is dynamics steps and small
products; it launches none of the port's kernels.

Disturbances come from an explicit `torch.Generator`, so the draws are
reproducible (they cannot equal `jax.random`'s); they are drawn on the
generator's device and moved to the solution's.
"""
from __future__ import annotations

import dataclasses

import torch

from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import (CentroidalModel,
                                                        dynamics_step)

# Reference disturbance model (src/simulate_solo.py:90-115, 281-291):
# 3D force ~ N(0, 15 I); only the y component is applied, for 200 ms.
FORCE_COV = 15.0
PUSH_MS = 200


@dataclasses.dataclass(frozen=True)
class MonteCarloResult:
    X_sim: torch.Tensor       # (S, N+1, nx) closed-loop states
    U_sim: torch.Tensor       # (S, N, nu) applied (feedback-corrected) forces
    push_force: torch.Tensor  # (S, 3)
    push_start: torch.Tensor  # (S,)


def sample_disturbances(generator: torch.Generator, n_sims: int,
                        horizon: int, dt: float, dtype=torch.float32):
    """(forces (S, 3), start knot (S,), duration knots): the reference's
    pseudorandom force pushes at planning rate, drawn on the generator's
    device."""
    dev = generator.device
    forces = FORCE_COV ** 0.5 * torch.randn((n_sims, 3), generator=generator,
                                            dtype=dtype, device=dev)
    duration = max(int(round(PUSH_MS * 1e-3 / dt)), 1)
    hi = max(horizon - duration, 1)
    starts = torch.randint(0, hi, (n_sims,), generator=generator, device=dev)
    return forces, starts, duration


def closed_loop_rollout(model: CentroidalModel, schedule: ContactSchedule,
                        X_ref, U_ref, K, x0, push_force, push_start,
                        push_len: int):
    """S disturbance rollouts with LQR feedback, all at once.

    X_ref (N+1, nx), U_ref (N, nu), K (N, nu, nx) are the plan; x0
    (S, nx), push_force (S, 3), push_start (S,) one entry per sim.
    u_k = U_ref_k + K_k (x_k - X_ref_k); the push adds the force's y
    component (like src/simulate_solo.py:289-291) to the linear-momentum
    rate for push_len knots from push_start.
    Returns (X (S, N+1, nx), U (S, N, nu)).
    """
    f_ext = torch.zeros_like(push_force)
    f_ext[..., 1] = push_force[..., 1]
    end = push_start + push_len
    xs, us = [x0], []
    for k in range(U_ref.shape[-2]):
        x = xs[-1]
        u = U_ref[k] + ((K[k] @ (x - X_ref[k])[..., None])[..., 0])
        x_next = dynamics_step(model, x, u, schedule.position[k],
                               schedule.logic[k], schedule.orientation[k])
        act = ((push_start <= k) & (k < end)).to(x.dtype)
        x_next[..., 3:6] += model.dt * act[..., None] * f_ext
        xs.append(x_next)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def run_monte_carlo(model: CentroidalModel, schedule: ContactSchedule,
                    X_ref, U_ref, K, generator: torch.Generator,
                    n_sims: int) -> MonteCarloResult:
    """n_sims rollouts of the plan (X_ref, U_ref, K) from X_ref[0] under
    disturbances drawn from `generator`."""
    forces, starts, duration = sample_disturbances(
        generator, n_sims, U_ref.shape[-2], float(model.dt), X_ref.dtype)
    forces, starts = forces.to(X_ref.device), starts.to(X_ref.device)
    x0 = X_ref[0].expand(n_sims, X_ref.shape[-1])
    X_sim, U_sim = closed_loop_rollout(model, schedule, X_ref, U_ref, K, x0,
                                       forces, starts, duration)
    return MonteCarloResult(X_sim=X_sim, U_sim=U_sim, push_force=forces,
                            push_start=starts)
