"""Joint-space whole-body DDP on the rigid-body engine.

Port of `centroidal_mpc_tpu/models/whole_body_ddp.py`: a trajectory
optimization over the floating-base model with contact-constrained
forward dynamics, solved by the Gauss-Newton iLQR of solver/ddp.py (the
reference's Crocoddyl stages, src/whole_body_control.py).  It covers both
reference modes:

  * ``TRACK_CENTROIDAL=False`` (stage 1, :168-291 + run_motion.py:16-30):
    track a CoM-progress heuristic;
  * ``TRACK_CENTROIDAL=True`` (stage 3, :305-344 + run_motion.py:49-72):
    track the SCP solution (CoM, centroidal momentum, contact forces) and
    produce robot-ready joint trajectories.

One action model serves the whole horizon: the gait phase is data (a
per-knot contact mask).  The dynamics are the contact-KKT solve of
models/rigid_body.py plus semi-implicit Euler; the costs are
least-squares residuals (Crocoddyl's residual models): swing and stance
foot tracking (:360-382), CoM tracking (:312-318), centroidal momentum
(:319-327), contact force toward the SCP forces (:328-344), and
state/control regularization (:46-152).  One knot's dynamics and
residual share one walk of the tree (`rigid_body.dynamics_terms`).

State x = [q (6+nj), v (6+nj)]; control = joint torques (nj,).  The
solve runs on the device of the targets.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from centroidal_mpc_tpu_torch.contact.plan import ContactPlan
from centroidal_mpc_tpu_torch.contact.swing import SwingTrajectories
from centroidal_mpc_tpu_torch.models import kinematics as kin
from centroidal_mpc_tpu_torch.models import rigid_body as rb
from centroidal_mpc_tpu_torch.solver.ddp import (DdpSettings, DdpSolution,
                                                 solve_ilqr_residual, take)
from centroidal_mpc_tpu_torch.utils.interpolation import (
    interpolate_linear, interpolate_zero_order)


@dataclasses.dataclass(frozen=True)
class WholeBodyWeights:
    """Cost weights (the reference's whole-body task weights,
    src/whole_body_control.py:46-152, conf_solo12_trot.py:88-90)."""

    foot: float = 1e6          # swing/stance foot position tracking
    com: float = 1e4           # CoM tracking
    lin_momentum: float = 1e1  # centroidal linear momentum tracking
    ang_momentum: float = 1e1  # centroidal angular momentum tracking
    force: float = 1e-2        # contact force toward the SCP plan (stage
                               # 1: toward the weight distribution)
    posture: float = 1e-1      # joint posture regularization
    base_rpy: float = 1e1      # keep the base level
    velocity: float = 1e-1     # generalized-velocity regularization
    torque: float = 1e-3       # control regularization
    terminal_scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class WholeBodyTargets:
    """Per-knot references at the planning rate (tensors on one
    device)."""

    contact_mask: torch.Tensor   # (N, C)
    contact_ref: torch.Tensor    # (N, C, 3) stance anchor points
    foot_target: torch.Tensor    # (N, C, 3) world foot references
    com_target: torch.Tensor     # (N+1, 3)
    mom_target: torch.Tensor     # (N+1, 6) [linear, angular]
    force_target: torch.Tensor   # (N, C, 3) SCP contact forces


@dataclasses.dataclass(frozen=True)
class WholeBodySolution:
    """Solved whole-body trajectory and its per-knot data (the
    reference's get_solution_trajectories payload,
    src/whole_body_control.py:384-432)."""

    Q: torch.Tensor         # (N+1, nq) configurations
    V: torch.Tensor         # (N+1, nv) generalized velocities
    TAU: torch.Tensor       # (N, nj) joint torques
    forces: torch.Tensor    # (N, C, cd) contact forces of the KKT dynamics
    com: torch.Tensor       # (N+1, 3)
    momentum: torch.Tensor  # (N+1, 6) centroidal momentum [lin, ang]
    feet: torch.Tensor      # (N+1, C, 3) world foot positions
    K: torch.Tensor         # (N, nj, 2 nv) iLQR feedback gains
    cost: torch.Tensor
    iterations: int

    def centroidal_states(self) -> torch.Tensor:
        """(N+1, 9) [com, lin momentum, ang momentum] (the
        wholeBody_to_centroidal_traj payload, run_motion.py:30)."""
        return torch.cat([self.com, self.momentum], dim=1)


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def build_targets(plan: ContactPlan, swing: SwingTrajectories,
                  dt_ctrl: float, X_centroidal=None, U_centroidal=None,
                  dtype: torch.dtype = torch.float64,
                  device=None) -> WholeBodyTargets:
    """Per-knot references at the planning rate, on `device` (default:
    the plan schedule's).

    Stage-3 mode: pass the SCP solution (X_centroidal (N+1, 9),
    U_centroidal (N, nu)); CoM, momentum and force targets come from it.
    Stage-1 mode: omit them; the CoM target is the contact-centroid
    progress and the force target the weight distribution."""
    device = plan.schedule.logic.device if device is None else device
    logic = _np64(plan.schedule.logic)                        # (N, C)
    pos = _np64(plan.schedule.position)                       # (N, C, 3)
    n, n_c = logic.shape
    n_inner = int(round(plan.dt / dt_ctrl))

    # foot targets: stance -> placement, swing -> swing reference at the
    # planning knots
    swing_pos = np.asarray(swing.pos).transpose(2, 0, 1)      # (T, C, 3)
    swing_knots = swing_pos[::n_inner][:n]
    foot_target = np.where(logic[:, :, None] > 0, pos, swing_knots)

    if X_centroidal is not None:
        Xc = _np64(X_centroidal)
        com_target = Xc[:, 0:3]
        mom_target = Xc[:, 3:9]
    else:
        # contact-centroid CoM progress (solver/warm_start.py semantics)
        n_active = np.maximum(logic.sum(axis=1), 1.0)
        centroid = (pos * logic[:, :, None]).sum(axis=1) / n_active[:, None]
        com_target = np.zeros((n + 1, 3))
        com_target[:n, 0:2] = centroid[:, 0:2]
        com_target[:n, 2] = plan.robot.com_height + centroid[:, 2]
        com_target[n] = com_target[n - 1]
        mom_target = np.zeros((n + 1, 6))
    if U_centroidal is not None:
        u_arr = _np64(U_centroidal)
        nuc = u_arr.shape[1] // n_c
        u_arr = u_arr.reshape(n, n_c, nuc)
        # wrench6 controls are (cop_x, cop_y, fx, fy, fz, tau_z); the
        # tracked target is the linear force
        force_target = u_arr[:, :, 2:5] if nuc == 6 else u_arr
    else:
        # weight distribution over the planted feet (the reference's
        # control warm start, centroidal_model.py:176-183): bounds the
        # bilateral-KKT force transients at touchdown
        force_target = np.zeros((n, n_c, 3))
        fz = plan.robot.mass * 9.81 / np.maximum(logic.sum(axis=1), 1.0)
        force_target[:, :, 2] = fz[:, None] * logic

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return WholeBodyTargets(
        contact_mask=t(logic), contact_ref=t(pos),
        foot_target=t(foot_target), com_target=t(com_target),
        mom_target=t(mom_target), force_target=t(force_target))


def _com_matched_config(spec: rb.RigidBodySpec, com_target: torch.Tensor,
                        feet: torch.Tensor,
                        geom: kin.LegGeometry) -> torch.Tensor:
    """Configuration with the feet at `feet` (IK) and the rigid-body CoM
    (not the base origin) at `com_target`: the CoM moves 1:1 with the base
    up to the IK's joint change, so a few fixed-point steps converge.
    com_target (..., 3), feet (..., n_legs, 3) -> q (..., nq)."""

    def assemble(base_pos):
        q_legs = kin.ik_all_legs(feet - base_pos[..., None, :], geom)
        return torch.cat([base_pos, torch.zeros_like(base_pos),
                          q_legs.reshape(q_legs.shape[:-2] + (-1,))], dim=-1)

    b = com_target
    q = assemble(b)
    for _ in range(6):
        b = b + (com_target - rb.com_position(spec, q))
        q = assemble(b)
    return q


def leg_geometry_from_spec(spec: rb.RigidBodySpec
                           ) -> Optional[kin.LegGeometry]:
    """A closed-form LegGeometry from a spec built in the 3-DoF point-leg
    pattern (HAA about x at the hip, HFE about y at the lateral offset,
    KFE about y at the knee: solo12_spec, bolt_spec); None for any other
    morphology (callers then take the numeric IK)."""
    if spec.contact_dim != 3 or spec.n_joints != 3 * spec.n_feet:
        return None
    hips, sides = [], []
    y_off = l_upper = l_lower = None
    for f, fb in enumerate(spec.foot_body):
        haa, hfe, kfe = fb - 2, fb - 1, fb
        if (spec.parent[haa] != 0 or spec.parent[hfe] != haa
                or spec.parent[kfe] != hfe):
            return None
        if not (np.allclose(spec.joint_axis[haa], [1, 0, 0])
                and np.allclose(spec.joint_axis[hfe], [0, 1, 0])
                and np.allclose(spec.joint_axis[kfe], [0, 1, 0])):
            return None
        hips.append(tuple(spec.joint_pos[haa]))
        off = spec.joint_pos[hfe]
        side = np.sign(off[1]) if abs(off[1]) > 1e-12 else np.sign(
            spec.joint_pos[haa][1])
        sides.append(float(side if side != 0 else 1.0))
        y_off = abs(float(off[1]))
        l_upper = -float(spec.joint_pos[kfe][2])
        l_lower = -float(spec.foot_pos[f][2])
    return kin.LegGeometry(y_off=y_off, l_upper=l_upper, l_lower=l_lower,
                           hips=tuple(hips), sides=tuple(sides))


def _numeric_config(spec: rb.RigidBodySpec, com_target: torch.Tensor,
                    foot_targets: torch.Tensor, q0: torch.Tensor,
                    iters: int = 25) -> torch.Tensor:
    """Whole-body IK by damped Gauss-Newton for one configuration (any
    morphology: the path for robots without closed-form legs, e.g. the
    talos 6-DoF legs).  Residual: feet -> targets, foot orientations ->
    flat (contact_dim=6), CoM -> com_target, base orientation -> level."""
    eye = torch.eye(spec.nq, dtype=q0.dtype, device=q0.device)

    def residual(q):
        parts = [(rb.foot_points(spec, q) - foot_targets).reshape(-1),
                 rb.com_position(spec, q) - com_target,
                 0.3 * q[3:6]]
        if spec.contact_dim == 6:
            rot = rb._flat_rot_err(rb.foot_orientations(spec, q))
            parts.insert(1, rot.reshape(-1))
        return torch.cat(parts)

    q = q0
    for _ in range(iters):
        r = residual(q)
        J = jacfwd(residual)(q)
        dq = torch.linalg.solve_ex(J.T @ J + 1e-8 * eye, J.T @ r)[0]
        q = q - dq
    return q


def default_joint_guess(spec: rb.RigidBodySpec) -> torch.Tensor:
    """(nj,) numeric-IK seed (float64, CPU): a small bend on every pitch
    (y-axis) joint, alternating sign down each chain so that knees flex
    rather than lock at the straight-leg singularity."""
    qj = np.zeros(spec.n_joints)
    for i in range(1, spec.n_bodies):
        if abs(spec.joint_axis[i][1]) > 0.5:
            depth = 0
            j = i
            while spec.parent[j] != 0:
                if abs(spec.joint_axis[j][1]) > 0.5:
                    depth += 1
                j = spec.parent[j]
            qj[i - 1] = 0.3 if depth % 2 else -0.15
    return torch.as_tensor(qj)


def _numeric_configs(spec, com_targets, foot_targets, q0, iters):
    return vmap(lambda c, f: _numeric_config(spec, c, f, q0, iters))(
        com_targets, foot_targets)


def standing_state(spec: rb.RigidBodySpec, targets: WholeBodyTargets,
                   geom: Optional[kin.LegGeometry] = None,
                   q_guess: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial state: joints from IK of the initial foot placements
    (closed form for 3-DoF point legs, damped least squares otherwise),
    the CoM at the initial CoM target, zero velocity."""
    geom = geom or leg_geometry_from_spec(spec)
    com0 = targets.com_target[0]
    if geom is not None:
        q = _com_matched_config(spec, com0, targets.foot_target[0], geom)
    else:
        if q_guess is None:
            q_guess = torch.cat([com0, torch.zeros_like(com0),
                                 default_joint_guess(spec).to(com0)])
        q = _numeric_config(spec, com0, targets.foot_target[0], q_guess)
    return torch.cat([q, torch.zeros(spec.nv, dtype=q.dtype,
                                     device=q.device)])


def quasi_static_torques(spec: rb.RigidBodySpec, q: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """(..., nj) exact quasi-static joint torques.

    At udot = 0 the floating-base rows of M udot = S'tau - h + Jc'f have no
    torque, so the contact forces must satisfy (Jc'f)[0:6] = h[0:6]; the
    minimum-norm planted-feet solution comes from the pseudoinverse, and
    the joint rows give tau = (h - Jc'f)[6:]."""
    dtype = q.dtype
    cd = spec.contact_dim
    nc = spec.n_feet * cd
    h = rb.bias_forces(spec, q, torch.zeros_like(q))
    jc = rb.contact_frame_jacobian(spec, q)
    jc = jc.reshape(jc.shape[:-3] + (nc, spec.nv))
    m3 = mask.to(dtype)[..., :, None].expand(mask.shape + (cd,)).reshape(
        mask.shape[:-1] + (nc,))
    a = jc.transpose(-1, -2)[..., 0:6, :] * m3[..., None, :]    # (..., 6, nc)
    eye = torch.eye(6, dtype=dtype, device=q.device)
    f = (a.transpose(-1, -2) @ torch.linalg.solve_ex(
        a @ a.transpose(-1, -2) + 1e-10 * eye, h[..., 0:6, None])[0])[..., 0]
    return (h - (jc.transpose(-1, -2) @ (m3 * f)[..., None])[..., 0])[..., 6:]


def gravity_torque_warm_start(spec: rb.RigidBodySpec,
                              targets: WholeBodyTargets,
                              geom: Optional[kin.LegGeometry] = None,
                              q_guess: Optional[torch.Tensor] = None,
                              ) -> torch.Tensor:
    """(N, nj) torque warm start: per-knot CoM-matched IK posture and its
    exact quasi-static inverse dynamics (the reference warm-starts FDDP
    from quasi-static postures, src/whole_body_control.py:168-201)."""
    mask = targets.contact_mask
    n = mask.shape[0]
    geom = geom or leg_geometry_from_spec(spec)
    if geom is not None:
        qs = _com_matched_config(spec, targets.com_target[:n],
                                 targets.foot_target, geom)
    else:
        x0 = standing_state(spec, targets, q_guess=q_guess)
        qs = _numeric_configs(spec, targets.com_target[:n],
                              targets.foot_target, x0[:spec.nq], 10)
    return quasi_static_torques(spec, qs, mask)


def kinematic_state_warm_start(spec: rb.RigidBodySpec,
                               targets: WholeBodyTargets,
                               geom: Optional[kin.LegGeometry] = None,
                               ) -> torch.Tensor:
    """(N+1, nx) state-trajectory warm start: per-knot CoM-matched IK
    postures at zero velocity (the reference's xs warm start of
    SolverFDDP, run_motion.py:24-27).  Pass it as solve_whole_body_ddp's
    X_traj for the FDDP gap-handling mode; it is not a rollout."""
    n = targets.contact_mask.shape[0]
    geom = geom or leg_geometry_from_spec(spec)
    foot_pad = torch.cat([targets.foot_target, targets.foot_target[-1:]])
    if geom is not None:
        qs = _com_matched_config(spec, targets.com_target, foot_pad, geom)
    else:
        x0 = standing_state(spec, targets)
        qs = _numeric_configs(spec, targets.com_target, foot_pad,
                              x0[:spec.nq], 10)
    return torch.cat([qs, torch.zeros((n + 1, spec.nv), dtype=qs.dtype,
                                      device=qs.device)], dim=1)


def _weights_vector(w: WholeBodyWeights, dtype, device) -> torch.Tensor:
    return torch.tensor([w.foot, w.com, w.lin_momentum, w.ang_momentum,
                         w.force, w.posture, w.base_rpy, w.velocity,
                         w.torque, w.terminal_scale], dtype=dtype,
                        device=device)


class WholeBodyOcp(NamedTuple):
    """The whole-body OCP's functions of one knot, as solver/ddp.py takes
    them (k a knot index, see `solver.ddp.take`)."""

    knot: Callable               # (x, u, k) -> (x_next, stage residual)
    dynamics: Callable           # (x, u, k) -> x_next
    stage_residual: Callable     # (x, u, k) -> (nr,)
    terminal_residual: Callable  # (x,) -> (nrT,)


def whole_body_ocp(spec: rb.RigidBodySpec, targets: WholeBodyTargets,
                   dt: float, q_ref: torch.Tensor,
                   weights: WholeBodyWeights = WholeBodyWeights(),
                   contact: rb.ContactDynamicsSettings =
                   rb.ContactDynamicsSettings()) -> WholeBodyOcp:
    """The dynamics (contact-KKT forward dynamics + semi-implicit Euler)
    and the weighted residuals of the whole-body OCP; q_ref is the posture
    the joints are regularized toward."""
    n = targets.contact_mask.shape[0]
    dtype, device = targets.com_target.dtype, targets.com_target.device
    nq = spec.nq
    sw = torch.sqrt(_weights_vector(weights, dtype, device))
    sdt = torch.sqrt(torch.tensor(dt, dtype=dtype, device=device))

    def state_residual(q, v, terms, com_t, mom_t, foot_t):
        """Weighted tracking residuals (the reference's residual-model
        cost stack, src/whole_body_control.py:46-152 and :305-344)."""
        return torch.cat([
            sw[0] * (terms.feet - foot_t).reshape(-1),
            sw[1] * (terms.com - com_t),
            sw[2] * (terms.momentum[0:3] - mom_t[0:3]),
            sw[3] * (terms.momentum[3:6] - mom_t[3:6]),
            sw[5] * (q[6:] - q_ref[6:]),
            sw[6] * q[3:6],
            sw[7] * v,
        ])

    def knot(x, u, k):
        q, v = x[:nq], x[nq:]
        mask = take(targets.contact_mask, k)
        terms = rb.dynamics_terms(spec, q, v, u, mask,
                                  take(targets.contact_ref, k), contact)
        q_next, v_next = rb.integrate_step(spec, q, v, terms.udot, dt)
        # flat feet carry [force(3), torque(3)]; the tracked target is
        # the linear contact force
        e_f = ((terms.forces[:, :3] - take(targets.force_target, k))
               * mask[:, None]).reshape(-1)
        r = sdt * torch.cat([
            state_residual(q, v, terms, take(targets.com_target, k),
                           take(targets.mom_target, k),
                           take(targets.foot_target, k)),
            sw[8] * u,
            sw[4] * e_f,
        ])
        return torch.cat([q_next, v_next]), r

    def dynamics(x, u, k):
        return knot(x, u, k)[0]

    def stage_residual(x, u, k):
        return knot(x, u, k)[1]

    def terminal_residual(x):
        q, v = x[:nq], x[nq:]
        terms = rb.DynamicsTerms(
            udot=None, forces=None, feet=rb.foot_points(spec, q),
            com=rb.com_position(spec, q),
            momentum=rb.centroidal_momentum(spec, q, v))
        # the terminal knot n has no foot target of its own: the JAX
        # package's out-of-range gather clamps it to knot n-1
        return sdt * sw[9] * state_residual(
            q, v, terms, targets.com_target[n], targets.mom_target[n],
            targets.foot_target[n - 1])

    return WholeBodyOcp(knot=knot, dynamics=dynamics,
                        stage_residual=stage_residual,
                        terminal_residual=terminal_residual)


def solve_whole_body_ddp(
        spec: rb.RigidBodySpec,
        targets: WholeBodyTargets,
        dt: float,
        x0: Optional[torch.Tensor] = None,
        U0: Optional[torch.Tensor] = None,
        weights: WholeBodyWeights = WholeBodyWeights(),
        settings: DdpSettings = DdpSettings(iterations=60, exact_quu=True),
        contact: rb.ContactDynamicsSettings = rb.ContactDynamicsSettings(),
        X_traj: Optional[torch.Tensor] = None,
) -> WholeBodySolution:
    """Solve the whole-body OCP with Gauss-Newton iLQR over the
    contact-KKT dynamics, on the device of `targets`.  x0 defaults to
    `standing_state`, U0 to `gravity_torque_warm_start`; X_traj (N+1, nx)
    turns on the FDDP mode (see `kinematic_state_warm_start`)."""
    if x0 is None:
        x0 = standing_state(spec, targets)
    if U0 is None:
        U0 = gravity_torque_warm_start(spec, targets)
    ocp = whole_body_ocp(spec, targets, dt, x0[:spec.nq], weights, contact)
    sol: DdpSolution = solve_ilqr_residual(
        ocp.dynamics, ocp.stage_residual, ocp.terminal_residual, x0, U0,
        settings, X_init=X_traj, knot=ocp.knot)

    # extraction (reference get_solution_trajectories,
    # src/whole_body_control.py:384-432)
    Q, V = sol.X[:, :spec.nq], sol.X[:, spec.nq:]
    mask = targets.contact_mask
    _, forces = rb.constrained_forward_dynamics(
        spec, Q[:-1], V[:-1], sol.U, mask, targets.contact_ref, contact)
    return WholeBodySolution(
        Q=Q, V=V, TAU=sol.U, forces=forces * mask[:, :, None],
        com=rb.com_position(spec, Q),
        momentum=rb.centroidal_momentum(spec, Q, V),
        feet=rb.foot_points(spec, Q), K=sol.K, cost=sol.cost,
        iterations=sol.iterations)


def interpolate_whole_body_solution(sol: WholeBodySolution, dt: float,
                                    dt_ctrl: float):
    """Upsample to the control rate (reference
    interpolate_whole_body_solution, src/whole_body_control.py:434-475:
    linear on q/qdot, ZOH on torques/forces/gains).  Returns a dict of
    numpy arrays, the wholeBody_interpolated_traj payload
    (run_motion.py:68-72)."""
    n_inner = int(round(dt / dt_ctrl))
    n, n_c, cd = sol.forces.shape
    return {
        "q": interpolate_linear(sol.Q, n_inner),
        "qdot": interpolate_linear(sol.V, n_inner),
        "tau_ff": interpolate_zero_order(sol.TAU, n_inner),
        "forces": interpolate_zero_order(sol.forces.reshape(n, n_c * cd),
                                         n_inner),
        "gains": interpolate_zero_order(sol.K.reshape(sol.K.shape[0], -1),
                                        n_inner),
    }
