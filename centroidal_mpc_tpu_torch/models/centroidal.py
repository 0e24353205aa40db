"""Centroidal dynamics model, batch-first.

Port of `centroidal_mpc_tpu/models/centroidal.py`.  State x = [com(3),
lin_mom(3), ang_mom(3)]; control u = per-contact forces (point3) or
per-contact (cop_x, cop_y, f, tau_z) wrenches (wrench6); explicit-Euler
discretization x+ = x + dt * xdot (reference integrate_model_one_step,
src/centroidal_model.py:189-212).

Every function takes any number of leading axes: x (..., nx), u (..., nu),
pos (..., C, 3), logic (..., C), rot (..., C, 3, 3), broadcast against
each other.  A batch of B scenarios over N knots is x (B, N, nx) with the
shared schedule arrays (N, C, ...).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config.robots import N_X, POINT3, RobotSpec
from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.ops import lqr_kernel


@dataclasses.dataclass(frozen=True)
class CentroidalModel:
    """Centroidal dynamics parameters (shared by every scenario)."""

    mass: torch.Tensor          # scalar
    gravity: torch.Tensor       # scalar (signed, -9.81)
    dt: torch.Tensor            # scalar
    Q: torch.Tensor             # (nx, nx) LQR state weights
    R: torch.Tensor             # (nu, nu) LQR control weights
    cov_w: torch.Tensor         # (n_w, n_w) contact-position noise
    cov_eta: torch.Tensor       # (nx, nx) additive white noise
    contact_model: str = POINT3
    n_contacts: int = 4

    @property
    def n_u_per_contact(self) -> int:
        return 3 if self.contact_model == POINT3 else 6

    @property
    def n_u(self) -> int:
        return self.n_contacts * self.n_u_per_contact

    @property
    def n_w(self) -> int:
        return self.n_contacts * 3

    @classmethod
    def from_spec(cls, robot: RobotSpec, dt: float, Q, R, cov_w, cov_eta,
                  dtype=torch.float32, *, device) -> "CentroidalModel":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)
        return cls(mass=t(robot.mass), gravity=t(robot.gravity), dt=t(dt),
                   Q=t(Q), R=t(R), cov_w=t(cov_w), cov_eta=t(cov_eta),
                   contact_model=robot.contact_model,
                   n_contacts=robot.n_contacts)


@dataclasses.dataclass(frozen=True)
class TrajectoryData:
    """Per-knot linearization data; a batch adds a leading B axis."""

    f: torch.Tensor      # (N, nx)      one-step integration at (x_k, u_k)
    A: torch.Tensor      # (N, nx, nx)  d f / d x
    B: torch.Tensor      # (N, nx, nu)  d f / d u
    C: torch.Tensor      # (N, nx, n_w) d f / d contact positions
    K: torch.Tensor      # (N, nu, nx)  LQR feedback gains
    Sigma: torch.Tensor  # (N+1, nx, nx) state covariance


def _skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]x with v x w = _skew(v) @ w."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def _contact_wrench(model: CentroidalModel, x, u, pos, logic, rot):
    """Per-contact effective force and angular-momentum rate, both gated
    by the contact logic: (forces (..., C, 3), ang (..., C, 3))."""
    c = model.n_contacts
    r = pos - x[..., None, :3]
    if model.contact_model == POINT3:
        forces = u.reshape(u.shape[:-1] + (c, 3)) * logic[..., None]
        r, forces = torch.broadcast_tensors(r, forces)
        ang = torch.linalg.cross(r, forces)
    else:  # WRENCH6: u_c = (cop_x, cop_y, fx, fy, fz, tau_z)
        uc = u.reshape(u.shape[:-1] + (c, 6))
        forces = uc[..., 2:5] * logic[..., None]
        cop_world = torch.einsum("...cij,...cj->...ci", rot[..., :2], uc[..., :2])
        r, forces = torch.broadcast_tensors(r, forces)
        cop_world, f_raw = torch.broadcast_tensors(cop_world, uc[..., 2:5])
        ang = (torch.linalg.cross(r, forces)
               + torch.linalg.cross(cop_world, f_raw) * logic[..., None]
               + rot[..., :, 2] * (uc[..., 5] * logic)[..., None])
    return forces, ang


def dynamics_step(model: CentroidalModel, x, u, pos, logic, rot):
    """One explicit-Euler step x+ = x + dt * xdot."""
    m = model.mass
    forces, ang = _contact_wrench(model, x, u, pos, logic, rot)
    zero = torch.zeros_like(m)
    grav = torch.stack([zero, zero, m * model.gravity])
    lin = forces.sum(-2) + grav
    lead = torch.broadcast_shapes(x.shape[:-1], lin.shape[:-1])
    xdot = torch.cat([(x[..., 3:6] / m).expand(lead + (3,)),
                      lin.expand(lead + (3,)),
                      ang.sum(-2).expand(lead + (3,))], dim=-1)
    return x + model.dt * xdot


def linearize_step(model: CentroidalModel, x, u, pos, logic, rot):
    """Closed-form (f, A, B, C) of the discrete step: A = d step/dx
    (..., nx, nx), B = d step/du (..., nx, nu), C = d step/d pos
    (..., nx, 3C).  Matches the Jacobians of `dynamics_step`."""
    n_c, dt, m = model.n_contacts, model.dt, model.mass
    dtype, dev = x.dtype, x.device
    f = dynamics_step(model, x, u, pos, logic, rot)
    lead = f.shape[:-1]
    forces, _ = _contact_wrench(model, x, u, pos, logic, rot)
    skew_f = _skew(forces)                      # (..., C, 3, 3)
    r = pos - x[..., None, :3]
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    A = torch.eye(N_X, dtype=dtype, device=dev).expand(
        lead + (N_X, N_X)).clone()
    A[..., 0:3, 3:6] += dt / m * eye3
    A[..., 6:9, 0:3] += dt * skew_f.sum(-3)

    B = torch.zeros(lead + (N_X, model.n_u), dtype=dtype, device=dev)
    skew_r = _skew(r) * logic[..., None, None]  # d ang / d f_c = [p-c]x
    if model.contact_model == POINT3:
        lin_rows = torch.einsum("...c,ij->...icj", logic, eye3)
        B[..., 3:6, :] = lin_rows.reshape(lin_rows.shape[:-2] + (-1,)) * dt
        B[..., 6:9, :] = (skew_r.movedim(-3, -2)
                          .reshape(skew_r.shape[:-3] + (3, -1)) * dt)
    else:
        uc = u.reshape(u.shape[:-1] + (n_c, 6))
        f_raw = uc[..., 2:5]
        cop_world = torch.einsum("...cij,...cj->...ci", rot[..., :2], uc[..., :2])
        lg = logic[..., None, None]
        blocks = torch.zeros(lead + (n_c, N_X, 6), dtype=dtype, device=dev)
        d_cop = -torch.einsum("...cij,...cjk->...cik", _skew(f_raw),
                              rot[..., :2])
        blocks[..., 6:9, 0:2] = d_cop * lg
        blocks[..., 3:6, 2:5] = eye3 * lg
        blocks[..., 6:9, 2:5] = skew_r + _skew(cop_world) * lg
        blocks[..., 6:9, 5] = rot[..., :, 2] * logic[..., None]
        B = blocks.movedim(-3, -2).reshape(lead + (N_X, model.n_u)) * dt

    C = torch.zeros(lead + (N_X, model.n_w), dtype=dtype, device=dev)
    C[..., 6:9, :] = (-skew_f.movedim(-3, -2)
                      .reshape(skew_f.shape[:-3] + (3, -1)) * dt)
    return f, A, B, C


def lqr_gain(model: CentroidalModel, A, B, n_iter: int = 2):
    """LQR feedback gain from an n_iter-truncated DARE fixed point
    (reference compute_lqr_feedback_gains, src/centroidal_model.py:217-228):
    P <- Q; repeat n_iter: P <- Q + A'PA - A'PB (R + B'PB)^-1 B'PA;
    K = -(R + B'PB)^-1 B'PA.  A (..., nx, nx), B (..., nx, nu) ->
    K (..., nu, nx); every leading index is an independent problem, all
    solved by one `ops.lqr_kernel.lqr_gain_batched` call."""
    nx, nu = A.shape[-1], B.shape[-1]
    lead = A.shape[:-2]
    K = lqr_kernel.lqr_gain_batched(
        model.Q, model.R, A.reshape(-1, nx, nx).contiguous(),
        B.reshape(-1, nx, nu).contiguous(), n_iter=n_iter)
    return K.reshape(lead + (nu, nx))


def compute_trajectory_data(model: CentroidalModel,
                            schedule: ContactSchedule,
                            X: torch.Tensor, U: torch.Tensor,
                            lqr_iters: int = 2,
                            with_covariance: bool = True) -> TrajectoryData:
    """Linearize whole trajectories at once.  X (..., N+1, nx),
    U (..., N, nu).  with_covariance=True (the stochastic mode's
    covariance recursion) is not ported yet and raises."""
    if with_covariance:
        raise NotImplementedError(
            "covariance propagation (stochastic mode) is not ported yet")
    n = schedule.horizon
    pos = schedule.positions_flat().reshape(n, schedule.n_contacts, 3)
    f, A, B, C = linearize_step(model, X[..., :-1, :], U, pos,
                                schedule.logic, schedule.orientation)
    K = lqr_gain(model, A, B, lqr_iters)
    Sigma = torch.zeros(X.shape[:-2] + (n + 1, N_X, N_X), dtype=A.dtype,
                        device=A.device)
    return TrajectoryData(f=f, A=A, B=B, C=C, K=K, Sigma=Sigma)


def integrate_dynamics_trajectory(model: CentroidalModel,
                                  schedule: ContactSchedule,
                                  X: torch.Tensor, U: torch.Tensor):
    """Pointwise one-step integration at every knot: (..., N, nx).  Like
    the reference, this evaluates step(x_k, u_k) for each knot of the
    given trajectory; it does not chain states."""
    return dynamics_step(model, X[..., :-1, :], U, schedule.position,
                         schedule.logic, schedule.orientation)


def model_accuracy(model: CentroidalModel, schedule: ContactSchedule,
                   X_curr, U_curr, X_prev, U_prev,
                   data: TrajectoryData) -> torch.Tensor:
    """GuSTO model-accuracy ratio rho = sum_k |e_k|^2 / sum_k |l_k|^2 with
    l_k the linear prediction around the previous trajectory and e_k the
    angular-momentum rows (6:9) of the nonlinear-vs-linear mismatch
    (reference compute_model_accuracy, src/scp_solver.py:71-87).  One
    value per leading index."""
    f_nl = integrate_dynamics_trajectory(model, schedule, X_curr, U_curr)
    dx = X_curr[..., :-1, :] - X_prev[..., :-1, :]
    du = U_curr - U_prev
    linear = (data.f + torch.einsum("...kij,...kj->...ki", data.A, dx)
              + torch.einsum("...kij,...kj->...ki", data.B, du))
    err = f_nl[..., 6:] - linear[..., 6:]
    return (err * err).sum((-2, -1)) / (linear * linear).sum((-2, -1))
