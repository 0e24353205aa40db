"""Full-physics whole-body closed-loop simulator (the PyBullet role).

Port of `centroidal_mpc_tpu/sim/physics.py`.  The reference validates
plans with sequential PyBullet episodes (src/simulate_solo.py:184-344): a
1 kHz torque loop

    tau = tau_ff + Kp (q_des - q) + Kd (qd_des - qd) - Jc' K_lqr (h - h_des)

(:293-308) under random force pushes (N(0, 15 I) sampled, the y
component applied for 200 ms from a random start, :90-115, :286-291),
logging the centroidal state and the feet for tracking-cost and
foot-slippage statistics (src/utils.py:94-114, :245-302).

The plant is the floating-base rigid-body engine (models/rigid_body.py)
with a penalty ground contact (spring-damper normal force and anchored
Coulomb friction against the terrain's planes), integrated semi-implicitly
at 1 kHz.  Its contact model differs from the planner's KKT contact
dynamics on purpose: an independent plant, as PyBullet's is to
Crocoddyl's, so feet really slide when the friction cone saturates.

Every episode runs at once: one Python loop over the T control steps
carries the states of all episodes (leading axes), with fixed shapes and
no host read inside the loop.  The plant is plain PyTorch; it launches
none of the port's kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from centroidal_mpc_tpu_torch.contact.terrain import FLAT, TerrainArrays
from centroidal_mpc_tpu_torch.models import rigid_body as rb
from centroidal_mpc_tpu_torch.ops.linalg import solve
from centroidal_mpc_tpu_torch.sim.monte_carlo import sample_disturbances
from centroidal_mpc_tpu_torch.utils.interpolation import (
    interpolate_linear, interpolate_zero_order)


@dataclasses.dataclass(frozen=True)
class PhysicsSettings:
    """Penalty-contact plant parameters (solo12-scale defaults)."""

    dt: float = 0.001
    ground_kp: float = 5000.0      # normal spring [N/m]
    ground_kd: float = 50.0        # normal damper [N s/m]
    tangent_kp: float = 1500.0     # static-friction anchor spring [N/m]
    tangent_kd: float = 15.0       # tangential damper [N s/m]
    mu: float = 0.5                # Coulomb friction coefficient
    joint_damping: float = 0.005   # actuator/transmission damping [N m s]


@dataclasses.dataclass(frozen=True)
class ClosedLoopReferences:
    """Control-rate (1 kHz) references for the reference's torque law."""

    q_des: torch.Tensor     # (T, nj) joint positions
    qd_des: torch.Tensor    # (T, nj) joint velocities
    tau_ff: torch.Tensor    # (T, nj) feedforward torques
    h_des: torch.Tensor     # (T, 9) centroidal state [com, lin, ang]
    K_lqr: torch.Tensor     # (T, nu, 9) centroidal LQR gains (ZOH)
    logic: torch.Tensor     # (T, C) contact flags
    kp: torch.Tensor        # PD gains (scalars)
    kd: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PhysicsSimResult:
    h: torch.Tensor           # (S, T, 9) simulated centroidal states
    feet: torch.Tensor        # (S, T, C, 3) world foot positions
    base_rpy: torch.Tensor    # (S, T, 3)
    fell: torch.Tensor        # (S,) base dropped below half nominal height
    push_force: torch.Tensor  # (S, 3)
    push_start: torch.Tensor  # (S,) control-step index


def build_references(wb_traj, X_centroidal, K_lqr, schedule,
                     n_inner: int = 10) -> ClosedLoopReferences:
    """1 kHz references from a kinematic whole-body trajectory
    (models/whole_body.track_centroidal_solution), the centroidal plan
    (interpolated linearly) and its per-knot LQR gains (zero-order hold,
    models/centroidal.compute_trajectory_data), on the trajectory's
    device and dtype.  The interpolation runs on the host (numpy)."""
    h_des = interpolate_linear(X_centroidal, n_inner)
    n = X_centroidal.shape[0] - 1
    K = interpolate_zero_order(K_lqr.reshape(n, -1), n_inner).reshape(
        n * n_inner, K_lqr.shape[1], K_lqr.shape[2])
    logic = np.repeat(schedule.logic.detach().cpu().numpy(), n_inner, axis=0)
    t = min(h_des.shape[0], wb_traj.q.shape[0], K.shape[0], logic.shape[0])
    dtype, device = wb_traj.q.dtype, wb_traj.q.device

    def tensor(a):
        return torch.as_tensor(a[:t], dtype=dtype, device=device)

    return ClosedLoopReferences(
        q_des=wb_traj.q[:t], qd_des=wb_traj.qdot[:t],
        tau_ff=wb_traj.tau_ff[:t], h_des=tensor(h_des), K_lqr=tensor(K),
        logic=tensor(logic), kp=wb_traj.kp.to(dtype),
        kd=wb_traj.kd.to(dtype))


def surface_query(terrain: TerrainArrays, feet: torch.Tensor):
    """The active surface under each foot: the highest covering plane.

    feet (..., C, 3).  Returns (p0 (..., C, 3), n (..., C, 3), z_surf
    (..., C)): a point of the plane, its unit normal and its height at the
    foot's xy.  Row 0 (flat ground) covers everywhere, so every foot has a
    surface; planes that do not cover a foot score -inf, and ties go to
    the first plane (PyBullet's collision query against the reference's
    stepstone boxes, src/simulate_solo.py:55-75)."""
    dxy = feet[..., :, None, :2] - terrain.p0[:, :2]        # (..., C, P, 2)
    covers = (dxy.abs() <= terrain.half).all(-1)             # (..., C, P)
    n = terrain.normal                                       # (P, 3)
    zs = terrain.p0[:, 2] - (dxy[..., 0] * n[:, 0]
                             + dxy[..., 1] * n[:, 1]) / n[:, 2]
    zs = torch.where(covers, zs, -torch.inf)
    idx = zs.argmax(-1)                                      # (..., C)
    return (terrain.p0[idx], terrain.normal[idx],
            zs.gather(-1, idx[..., None])[..., 0])


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def _contact_forces(settings: PhysicsSettings, feet, feet_vel, anchors,
                    terrain: TerrainArrays):
    """Penalty contact against each foot's active surface plane: a
    spring-damper normal force along the plane's normal, clamped at 0, and
    anchored Coulomb friction in its tangent plane.  feet, feet_vel,
    anchors (..., C, 3).

    Returns (forces (..., C, 3), new anchors (..., C, 3)).  Feet above
    their surface get no force and re-anchor where they are; sliding feet
    re-anchor so the spring matches the clamped force; sticking feet keep
    their anchor."""
    s = settings
    p0, n, _ = surface_query(terrain, feet)
    pen = -((feet - p0) * n).sum(-1)               # depth along the normal
    in_contact = pen > 0.0
    vn = (feet_vel * n).sum(-1)
    fn = torch.where(in_contact, s.ground_kp * pen - s.ground_kd * vn, 0.0)
    fn = fn.clamp_min(0.0)
    disp = feet - anchors
    disp_t = disp - n * (disp * n).sum(-1, keepdim=True)
    vel_t = feet_vel - n * vn[..., None]
    ft_spring = -s.tangent_kp * disp_t - s.tangent_kd * vel_t
    ft_norm = _norm(ft_spring) + 1e-12
    ft_max = s.mu * fn
    scale = (ft_max / ft_norm).clamp_max(1.0)
    ft = ft_spring * scale[..., None] * in_contact[..., None]
    slid = (ft_norm > ft_max) | ~in_contact
    anchor_slide = feet + (ft + s.tangent_kd * vel_t) / s.tangent_kp
    anchors_new = torch.where(
        slid[..., None],
        torch.where(in_contact[..., None], anchor_slide, feet), anchors)
    return ft + n * fn[..., None], anchors_new


def simulate_episode(spec: rb.RigidBodySpec, refs: ClosedLoopReferences,
                     x0: torch.Tensor, push_force: torch.Tensor,
                     push_start: torch.Tensor, push_len: int,
                     settings: PhysicsSettings = PhysicsSettings(),
                     terrain: Optional[TerrainArrays] = None):
    """Closed-loop 1 kHz episodes, all at once.

    x0 (..., nq+nv), push_force (..., 3) (its y component is applied),
    push_start (...) (control step); the leading axes broadcast.  Returns
    (h (..., T, 9) the centroidal state after each step, feet (..., T, C,
    3) before it, rpy (..., T, 3) the base orientation after it)."""
    dtype, device = x0.dtype, x0.device
    if terrain is None:
        terrain = FLAT.arrays(device, dtype)
    nq, nf = spec.nq, spec.n_feet
    push_force = torch.as_tensor(push_force, dtype=dtype, device=device)
    push_start = torch.as_tensor(push_start, device=device)
    lead = torch.broadcast_shapes(x0.shape[:-1], push_force.shape[:-1],
                                  push_start.shape)
    x0 = x0.expand(lead + x0.shape[-1:]).contiguous()
    t_total = refs.q_des.shape[0]
    ts = torch.arange(t_total, device=device).reshape(
        (t_total,) + (1,) * len(lead))
    push_on = ((ts >= push_start) & (ts < push_start + push_len)).to(dtype)
    f_push = torch.zeros(lead + (3,), dtype=dtype, device=device)
    f_push[..., 1] = push_force[..., 1]
    zeros6 = torch.zeros(lead + (6,), dtype=dtype, device=device)

    q, v = x0[..., :nq], x0[..., nq:]
    anchors = rb.foot_points(spec, q)
    hs, feet_out, rpys = [], [], []
    for t in range(t_total):
        terms = rb.plant_terms(spec, q, v)
        h = torch.cat([terms.com, terms.momentum], dim=-1)
        if t > 0:
            hs.append(h)                  # the state after step t - 1
        # the reference torque law (src/simulate_solo.py:293-308) plus the
        # centroidal LQR correction delta f = K (h - h_des), mapped to the
        # joints through the contact Jacobians of the planted feet
        tau = (refs.tau_ff[t] + refs.kp * (refs.q_des[t] - q[..., 6:])
               + refs.kd * (refs.qd_des[t] - v[..., 6:]))
        df = ((h - refs.h_des[t]) @ refs.K_lqr[t].transpose(-1, -2)
              ).reshape(lead + (nf, 3)) * refs.logic[t][:, None]
        dtau = -torch.einsum("...cij,...ci->...j", terms.Jc, df)[..., 6:]
        tau = tau + dtau - settings.joint_damping * v[..., 6:]
        jc = terms.Jc.reshape(lead + (nf * 3, spec.nv))
        feet_vel = (jc @ v[..., None])[..., 0].reshape(lead + (nf, 3))
        f_c, anchors = _contact_forces(settings, terms.feet, feet_vel,
                                       anchors, terrain)
        gen = (torch.cat([zeros6, tau], dim=-1) - terms.bias
               + (jc.transpose(-1, -2)
                  @ f_c.reshape(lead + (nf * 3, 1)))[..., 0])
        # push: a world force at the base origin through the base Jacobian
        wrench = torch.cat([torch.linalg.cross(q[..., 0:3], f_push), f_push],
                           dim=-1)
        j0 = terms.J[..., 0, :, :]
        gen = gen + push_on[t][..., None] * (
            j0.transpose(-1, -2) @ wrench[..., None])[..., 0]
        udot = solve(terms.M, gen[..., None])[..., 0]
        q, v = rb.integrate_step(spec, q, v, udot, settings.dt)
        feet_out.append(terms.feet)
        rpys.append(q[..., 3:6])
    hs.append(torch.cat([rb.com_position(spec, q),
                         rb.centroidal_momentum(spec, q, v)], dim=-1))
    return (torch.stack(hs, dim=-2), torch.stack(feet_out, dim=-3),
            torch.stack(rpys, dim=-2))


def run_physics_monte_carlo(spec: rb.RigidBodySpec,
                            refs: ClosedLoopReferences, x0: torch.Tensor,
                            generator: torch.Generator, n_sims: int,
                            settings: PhysicsSettings = PhysicsSettings(),
                            terrain: Optional[TerrainArrays] = None,
                            ) -> PhysicsSimResult:
    """n_sims episodes from x0 (nq+nv,) under pushes drawn from
    `generator` (sim/monte_carlo.sample_disturbances: N(0, 15 I) forces,
    a start uniform over the steps that leave a whole 200 ms push), all at
    once (the reference's nb_sims loop, src/simulate_solo.py:260)."""
    forces, starts, push_len = sample_disturbances(
        generator, n_sims, refs.q_des.shape[0], settings.dt, x0.dtype)
    forces, starts = forces.to(x0.device), starts.to(x0.device)
    h, feet, rpy = simulate_episode(spec, refs, x0, forces, starts, push_len,
                                    settings, terrain)
    fell = h[..., 2].amin(-1) < 0.5 * x0[..., 2]
    return PhysicsSimResult(h=h, feet=feet, base_rpy=rpy, fell=fell,
                            push_force=forces, push_start=starts)


def _slip(result: PhysicsSimResult, refs: ClosedLoopReferences,
          threshold: float, terrain: Optional[TerrainArrays]):
    """(S, T-1, C) stance-foot xy slip per step, steps under `threshold`
    zeroed: a planted foot counts while it is under its surface (strictly)
    at both ends of the step."""
    feet = result.feet                                  # (S, T, C, 3)
    if terrain is None:
        terrain = FLAT.arrays(feet.device, feet.dtype)
    d = _norm(feet[:, 1:, :, :2] - feet[:, :-1, :, :2])
    stance = (refs.logic[1:] > 0).to(d.dtype)           # (T-1, C)
    below = feet[..., 2] < surface_query(terrain, feet)[2]
    on_ground = below[:, 1:] & below[:, :-1]
    slip = d * stance * on_ground.to(d.dtype)
    return torch.where(slip > threshold, slip, 0.0)


def foot_slippage(result: PhysicsSimResult, refs: ClosedLoopReferences,
                  threshold: float = 1e-5,
                  terrain: Optional[TerrainArrays] = None) -> torch.Tensor:
    """(S,) cumulative stance-foot xy slip per episode (the reference's
    compute_norm_contact_slippage, src/utils.py:94-114)."""
    return _slip(result, refs, threshold, terrain).sum(dim=(1, 2))


def foot_slippage_series(result: PhysicsSimResult,
                         refs: ClosedLoopReferences,
                         threshold: float = 1e-5,
                         terrain: Optional[TerrainArrays] = None
                         ) -> torch.Tensor:
    """(S, T-1) cumulative stance-foot slip over time per episode (behind
    the reference's cumulative-slippage figure, src/utils.py:304-385)."""
    return torch.cumsum(_slip(result, refs, threshold, terrain).sum(dim=2),
                        dim=1)


def tracking_cost(result: PhysicsSimResult, refs: ClosedLoopReferences,
                  weights=None) -> torch.Tensor:
    """(S, T) cumulative centroidal tracking cost (the reference's
    plot_centroidal_tracking_cost statistic, src/utils.py:245-302)."""
    h = result.h
    w = (torch.ones(9, dtype=h.dtype, device=h.device) if weights is None
         else torch.as_tensor(weights, dtype=h.dtype, device=h.device))
    err = h - refs.h_des
    return torch.cumsum((err * w * err).sum(-1), dim=1)
