"""Floating-base rigid-body dynamics in PyTorch (the Pinocchio/Crocoddyl
role).

Port of `centroidal_mpc_tpu/models/rigid_body.py`: a small, dense,
differentiable rigid-body engine over a fixed-topology kinematic tree.

  * body Jacobians are taken at the WORLD ORIGIN, so the mass matrix is
    one einsum M = sum_i J_i' I_i J_i over bodies;
  * bias forces use the d'Alembert form h = sum_i J_i'(I_i Jdot_i u +
    v_i x* I_i v_i - f_grav,i), with Jdot_i u from one `torch.func.jvp`
    through the Jacobian assembly;
  * contact-constrained forward dynamics solves Crocoddyl's KKT system
    (M udot - Jc' f = tau - h; Jc udot = -gamma - baumgarte) with
    inactive contacts masked to f = 0 rows, so shapes do not change with
    the gait phase.

Every function takes any number of leading axes (q (..., nq), u (...,
nv)), and every one is written out of place, so that it runs the same on
one configuration, on a batch of them and under `torch.func` (vmap,
jacfwd, jvp).  The kinematic tree is walked level by level: the bodies
at one depth are one batched product, not one product each.
`constrained_forward_dynamics` takes Jdot u and gamma from ONE jvp of the
body and contact Jacobians, which the JAX package takes in two.

State convention: q = [base position (3, world), base orientation (3,
roll-pitch-yaw of R = Rz Ry Rx), joint angles (nj)]; u = [omega_base (3,
body frame), v_base (3, body frame), joint rates (nj)].
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jvp

from centroidal_mpc_tpu_torch.ops.linalg import solve

GRAVITY = 9.81


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def _mat3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll); rpy (..., 3)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    rx = _mat3([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
    ry = _mat3([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
    rz = _mat3([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
    return rz @ ry @ rx


def rpy_rates_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """E(rpy) with omega_world = E @ rpy_dot for R = Rz Ry Rx."""
    p, y = rpy[..., 1], rpy[..., 2]
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    one, zero = torch.ones_like(p), torch.zeros_like(p)
    return _mat3([[cp * cy, -sy, zero], [cp * sy, cy, zero],
                  [-sp, zero, one]])


@dataclasses.dataclass(frozen=True, eq=False)
class RigidBodySpec:
    """Fixed-topology floating-base tree (numpy constants).

    Body 0 is the floating base.  Bodies 1..nb-1 connect to `parent[i]` by
    a revolute joint: `joint_pos[i]` is the joint origin in the parent
    frame, `joint_axis[i]` the rotation axis in the child (= joint) frame.
    Inertial data per body: mass, com (body frame), rotational inertia
    about the com (body frame).  `foot_body` / `foot_pos` locate the
    feet.  `tensors(device, dtype)` caches the constants as tensors.
    """

    parent: Tuple[int, ...]
    joint_pos: np.ndarray      # (nb, 3); row 0 unused
    joint_axis: np.ndarray     # (nb, 3); row 0 unused
    mass: np.ndarray           # (nb,)
    com: np.ndarray            # (nb, 3)
    inertia: np.ndarray        # (nb, 3, 3)
    foot_body: Tuple[int, ...]
    foot_pos: np.ndarray       # (n_feet, 3) in the foot body frame
    contact_dim: int = 3       # 3 = point foot; 6 = flat foot (position +
                               # orientation, Crocoddyl ContactModel3D/6D)
    _cache: Dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    def __post_init__(self):
        for arr in ("joint_pos", "joint_axis", "mass", "com", "inertia",
                    "foot_pos"):
            object.__setattr__(self, arr, np.asarray(getattr(self, arr),
                                                     np.float64))

    @property
    def n_bodies(self) -> int:
        return len(self.parent)

    @property
    def n_joints(self) -> int:
        return self.n_bodies - 1

    @property
    def nq(self) -> int:
        return 6 + self.n_joints

    @property
    def nv(self) -> int:
        return 6 + self.n_joints

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def n_feet(self) -> int:
        return len(self.foot_body)

    @property
    def total_mass(self) -> float:
        return float(self.mass.sum())

    def depth(self, i: int) -> int:
        d = 0
        while i != 0:
            i, d = self.parent[i], d + 1
        return d

    def tensors(self, device, dtype) -> "_SpecTensors":
        key = (torch.device(device), dtype)
        if key not in self._cache:
            self._cache[key] = _SpecTensors.build(self, key[0], dtype)
        return self._cache[key]


@dataclasses.dataclass(frozen=True)
class _SpecTensors:
    """A spec's constants on one device and dtype, and the index tensors of
    its level-by-level tree walk."""

    joint_pos: torch.Tensor    # (nb, 3)
    joint_axis: torch.Tensor   # (nb, 3)
    axis_k: torch.Tensor       # (nj, 3, 3) skew(axis) of each joint
    axis_kk: torch.Tensor      # (nj, 3, 3) its square
    mass: torch.Tensor         # (nb,)
    com: torch.Tensor          # (nb, 3)
    inertia: torch.Tensor      # (nb, 3, 3)
    foot_pos: torch.Tensor     # (n_feet, 3)
    foot_body: torch.Tensor    # (n_feet,) long
    ancestors: torch.Tensor    # (nb, 1, nj) bool: joint j moves body i
    # levels[d] = (bodies at depth d+1, their parents' slots in the
    # concatenation of the levels above); order maps a body to its slot
    levels: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    order: torch.Tensor        # (nb,) long

    @staticmethod
    def build(spec: RigidBodySpec, device, dtype) -> "_SpecTensors":
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        nb, nj = spec.n_bodies, spec.n_joints
        anc = np.zeros((nb, 1, nj), bool)
        for i in range(nb):
            j = i
            while j != 0:
                anc[i, 0, j - 1] = True
                j = spec.parent[j]
        depth = [spec.depth(i) for i in range(nb)]
        slot = {0: 0}
        levels = []
        for d in range(1, max(depth) + 1):
            bodies = [i for i in range(nb) if depth[i] == d]
            parents = [slot[spec.parent[i]] for i in bodies]
            for i in bodies:
                slot[i] = len(slot)
            levels.append((idx(bodies), idx(parents)))
        k = _skew(t(spec.joint_axis[1:]))
        return _SpecTensors(
            joint_pos=t(spec.joint_pos), joint_axis=t(spec.joint_axis),
            axis_k=k, axis_kk=k @ k, mass=t(spec.mass), com=t(spec.com),
            inertia=t(spec.inertia), foot_pos=t(spec.foot_pos),
            foot_body=idx(spec.foot_body),
            ancestors=torch.as_tensor(anc, device=device),
            levels=tuple(levels), order=idx([slot[i] for i in range(nb)]))


def _st(spec: RigidBodySpec, q: torch.Tensor) -> _SpecTensors:
    return spec.tensors(q.device, q.dtype)


# ---------------------------------------------------------------------------
# robot specs (numpy constants, copied from the JAX package)
# ---------------------------------------------------------------------------


def _rod_inertia(m, length):
    i = m * length * length / 12.0
    return np.diag([i, i, 2e-5])


def _point_leg_spec(g, base_mass, base_inertia, leg_masses, n_legs):
    """Base + n_legs x (HAA about x, HFE about y, KFE about y), point feet,
    geometry from a kinematics.LegGeometry."""
    hips = g.hip_positions()
    sides = g.side_signs()
    parent = [0]
    joint_pos = [np.zeros(3)]
    joint_axis = [np.zeros(3)]
    mass = [base_mass]
    com = [np.zeros(3)]
    inertia = [base_inertia]
    foot_body = []
    for leg in range(n_legs):
        base_idx = len(parent)
        # HAA: child of the base at the hip, axis x
        parent.append(0)
        joint_pos.append(hips[leg])
        joint_axis.append(np.array([1.0, 0.0, 0.0]))
        mass.append(leg_masses[0])
        com.append(np.array([0.0, sides[leg] * 0.02, 0.0]))
        inertia.append(np.diag([3e-5, 5e-5, 5e-5]))
        # HFE: child of HAA at the lateral offset, axis y
        parent.append(base_idx)
        joint_pos.append(np.array([0.0, sides[leg] * g.y_off, 0.0]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(leg_masses[1])
        com.append(np.array([0.0, 0.0, -g.l_upper / 2]))
        inertia.append(_rod_inertia(leg_masses[1], g.l_upper))
        # KFE: child of the upper link at the knee, axis y
        parent.append(base_idx + 1)
        joint_pos.append(np.array([0.0, 0.0, -g.l_upper]))
        joint_axis.append(np.array([0.0, 1.0, 0.0]))
        mass.append(leg_masses[2])
        com.append(np.array([0.0, 0.0, -g.l_lower / 2]))
        inertia.append(_rod_inertia(leg_masses[2], g.l_lower))
        foot_body.append(base_idx + 2)
    return RigidBodySpec(parent=tuple(parent), joint_pos=np.array(joint_pos),
                         joint_axis=np.array(joint_axis),
                         mass=np.array(mass), com=np.array(com),
                         inertia=np.array(inertia),
                         foot_body=tuple(foot_body),
                         foot_pos=np.tile([0.0, 0.0, -g.l_lower],
                                          (n_legs, 1)))


@functools.lru_cache(maxsize=None)
def solo12_spec() -> RigidBodySpec:
    """Solo12: base + 4x(hip, upper, lower), point feet (total 2.5 kg as
    config/robots.py; base inertia from the published URDF, leg links as
    uniform rods).  Geometry matches kinematics.SOLO12_LEGS.  Body order:
    base, then FR(haa, upper, lower), FL, HR, HL."""
    from centroidal_mpc_tpu_torch.models.kinematics import SOLO12_LEGS
    return _point_leg_spec(SOLO12_LEGS, 1.16115,
                           np.diag([0.00578574, 0.01938108, 0.02476124]),
                           (0.140, 0.1434, 0.0517), 4)


@functools.lru_cache(maxsize=None)
def bolt_spec() -> RigidBodySpec:
    """Bolt point-foot biped: base + 2x(HAA, HFE, KFE), geometry of
    kinematics.BOLT_LEGS, a trunk-heavy mass split (1.3 kg in all); leg
    order FL, FR (reference conf_bolt.py ee_frame_names)."""
    from centroidal_mpc_tpu_torch.models.kinematics import BOLT_LEGS
    leg_masses = (0.08, 0.08, 0.04)
    return _point_leg_spec(BOLT_LEGS, 1.3 - 2.0 * sum(leg_masses),
                           np.diag([0.003, 0.004, 0.003]), leg_masses, 2)


@functools.lru_cache(maxsize=None)
def talos_spec() -> RigidBodySpec:
    """Talos legs: torso base + 2x6-joint legs (hip yaw z, hip roll x, hip
    pitch y, knee y, ankle pitch y, ankle roll x), flat feet (6D contact)
    0.107 m below the ankle; thigh 0.38 m, shin 0.325 m, 45 kg in all.
    Leg order RF, LF (reference conf_talos.py)."""
    hip_y, hip_drop = 0.085, 0.075          # hips sit below the pelvis base
    l_thigh, l_shin, l_ankle = 0.38, 0.325, 0.107
    parent = [0]
    joint_pos = [np.zeros(3)]
    joint_axis = [np.zeros(3)]
    mass = [26.0]
    com = [np.array([-0.02, 0.0, 0.25])]    # torso com above the pelvis
    inertia = [np.diag([1.2, 1.0, 0.35])]

    def rod_inertia(m, length, r=0.05):
        i = m * (length * length / 12.0 + r * r / 4.0)
        return np.diag([i, i, m * r * r / 2.0])

    x_axis, y_axis, z_axis = (np.array([1.0, 0.0, 0.0]),
                              np.array([0.0, 1.0, 0.0]),
                              np.array([0.0, 0.0, 1.0]))
    foot_body = []
    for side in (-1.0, 1.0):                 # RF then LF
        base_idx = len(parent)
        links = (  # (joint origin, axis, mass, com, inertia)
            (np.array([0.0, side * hip_y, -hip_drop]), z_axis, 1.2,
             np.zeros(3), np.diag([4e-3, 4e-3, 4e-3])),
            (np.zeros(3), x_axis, 1.5, np.zeros(3),
             np.diag([5e-3, 5e-3, 5e-3])),
            (np.zeros(3), y_axis, 4.0, np.array([0.0, 0.0, -l_thigh / 2]),
             rod_inertia(4.0, l_thigh)),
            (np.array([0.0, 0.0, -l_thigh]), y_axis, 2.2,
             np.array([0.0, 0.0, -l_shin / 2]), rod_inertia(2.2, l_shin)),
            (np.array([0.0, 0.0, -l_shin]), y_axis, 0.3, np.zeros(3),
             np.diag([1e-3, 1e-3, 1e-3])),
            (np.zeros(3), x_axis, 0.3, np.array([0.02, 0.0, -l_ankle / 2]),
             np.diag([1e-3, 2e-3, 2e-3])),
        )
        for j, (jp, ax, m, c, ine) in enumerate(links):
            parent.append(0 if j == 0 else base_idx + j - 1)
            joint_pos.append(jp)
            joint_axis.append(ax)
            mass.append(m)
            com.append(c)
            inertia.append(ine)
        foot_body.append(base_idx + 5)
    return RigidBodySpec(parent=tuple(parent), joint_pos=np.array(joint_pos),
                         joint_axis=np.array(joint_axis),
                         mass=np.array(mass), com=np.array(com),
                         inertia=np.array(inertia),
                         foot_body=tuple(foot_body),
                         foot_pos=np.tile([0.0, 0.0, -l_ankle], (2, 1)),
                         contact_dim=6)


def robot_spec(name: str) -> RigidBodySpec:
    """Whole-body spec for a RobotSpec name ('solo12' | 'bolt' | 'talos');
    one shared instance a robot, so its tensor cache is shared too."""
    try:
        return {"solo12": solo12_spec, "bolt": bolt_spec,
                "talos": talos_spec}[name]()
    except KeyError:
        raise KeyError(f"no whole-body RigidBodySpec for robot {name!r}")


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------


def forward_kinematics(spec: RigidBodySpec, q: torch.Tensor):
    """World poses of every body: (..., nb, 3, 3) rotations, (..., nb, 3)
    origins.  One batched product a tree level."""
    st = _st(spec, q)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    th = q[..., 6:, None, None]
    # Rodrigues rotation of every joint about its axis
    rj = eye + torch.sin(th) * st.axis_k + (1.0 - torch.cos(th)) * st.axis_kk
    R = rpy_to_matrix(q[..., 3:6]).unsqueeze(-3)
    p = q[..., None, 0:3]
    for bodies, parents in st.levels:
        r_par = R.index_select(-3, parents)
        jp = st.joint_pos.index_select(0, bodies)
        p_new = (p.index_select(-2, parents)
                 + (r_par @ jp[:, :, None])[..., 0])
        R = torch.cat([R, r_par @ rj.index_select(-3, bodies - 1)], dim=-3)
        p = torch.cat([p, p_new], dim=-2)
    return R.index_select(-3, st.order), p.index_select(-2, st.order)


def _jacobians_from_fk(spec: RigidBodySpec, q, R, p) -> torch.Tensor:
    st = _st(spec, q)
    a_w = (R[..., 1:, :, :] @ st.joint_axis[1:, :, None])[..., 0]
    cols = torch.cat([a_w, torch.linalg.cross(p[..., 1:, :], a_w)],
                     dim=-1).transpose(-1, -2)                # (..., 6, nj)
    joints = torch.where(st.ancestors, cols.unsqueeze(-3),
                         torch.zeros((), dtype=q.dtype, device=q.device))
    # base block: omega_w = R0 w_b ; v_O = R0 v_b + p0 x omega_w
    R0, p0 = R[..., 0, :, :], p[..., 0, :]
    zero = torch.zeros_like(R0)
    base = torch.cat([torch.cat([R0, zero], dim=-1),
                      torch.cat([_skew(p0) @ R0, R0], dim=-1)], dim=-2)
    base = base.unsqueeze(-3).expand(joints.shape[:-1] + (6,))
    return torch.cat([base, joints], dim=-1)


def body_jacobians(spec: RigidBodySpec, q: torch.Tensor) -> torch.Tensor:
    """(..., nb, 6, nv) world-origin spatial Jacobians: v_i = J_i(q) @ u.

    Spatial velocity (omega_world; v_O), v_O the velocity of the body-fixed
    point at the world origin.  Column blocks: the base twist (body frame)
    then each revolute rate, joint j's world column s_j = (a_j; p_j x a_j)
    on the bodies it moves."""
    R, p = forward_kinematics(spec, q)
    return _jacobians_from_fk(spec, q, R, p)


def _coms(spec, q, R, p):
    return p + (R @ _st(spec, q).com[..., None])[..., 0]


def _inertias_from_fk(spec, q, R, p):
    st = _st(spec, q)
    ch = _skew(_coms(spec, q, R, p))
    ic_w = R @ st.inertia @ R.transpose(-1, -2)
    m = st.mass[:, None, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([ic_w - m * ch @ ch, m * ch], dim=-1)
    bot = torch.cat([m * ch.transpose(-1, -2), (m * eye).expand_as(ch)],
                    dim=-1)
    return torch.cat([top, bot], dim=-2)


def spatial_inertias_world(spec: RigidBodySpec,
                           q: torch.Tensor) -> torch.Tensor:
    """(..., nb, 6, 6) spatial inertias at the world origin."""
    R, p = forward_kinematics(spec, q)
    return _inertias_from_fk(spec, q, R, p)


def _mass_from(J, I6):
    M = torch.einsum("...bri,...brs,...bsj->...ij", J, I6, J)
    return 0.5 * (M + M.transpose(-1, -2))


def mass_matrix(spec: RigidBodySpec, q: torch.Tensor) -> torch.Tensor:
    """(..., nv, nv) generalized mass matrix M(q) = sum_i J_i' I_i J_i."""
    R, p = forward_kinematics(spec, q)
    return _mass_from(_jacobians_from_fk(spec, q, R, p),
                      _inertias_from_fk(spec, q, R, p))


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def _kinematic_qdot(spec: RigidBodySpec, q: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Coordinate rates from the generalized velocity."""
    R0 = rpy_to_matrix(q[..., 3:6])
    omega_w = _matvec(R0, u[..., 0:3])
    pos_dot = _matvec(R0, u[..., 3:6])
    rpy_dot = solve(rpy_rates_matrix(q[..., 3:6]), omega_w[..., None])[..., 0]
    return torch.cat([pos_dot, rpy_dot, u[..., 6:]], dim=-1)


def _bias_from(spec, q, u, R, p, J, Jdot, I6):
    """h from the Jacobians, their rate along qdot and the inertias."""
    st = _st(spec, q)
    v = torch.einsum("...brj,...j->...br", J, u)          # (..., nb, 6)
    mom = _matvec(I6, v)                                   # spatial momenta
    w, vo = v[..., 0:3], v[..., 3:6]
    n, f = mom[..., 0:3], mom[..., 3:6]
    vxf = torch.cat([torch.linalg.cross(w, n) + torch.linalg.cross(vo, f),
                     torch.linalg.cross(w, f)], dim=-1)
    bias_f = _matvec(I6, torch.einsum("...brj,...j->...br", Jdot, u)) + vxf
    # gravity wrench at the world origin per body: force m g at the com
    coms = _coms(spec, q, R, p)
    g_vec = torch.tensor([0.0, 0.0, -GRAVITY], dtype=q.dtype,
                         device=q.device)
    fg = (st.mass[:, None] * g_vec).expand_as(coms)
    grav = torch.cat([torch.linalg.cross(coms, fg), fg], dim=-1)
    return torch.einsum("...brj,...br->...j", J, bias_f - grav)


def bias_forces(spec: RigidBodySpec, q: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """h(q, u): Coriolis/centrifugal + gravity generalized forces
    (d'Alembert over bodies; Jdot u from one jvp through body_jacobians
    along the coordinate rates; the reference's Pinocchio RNEA role)."""
    qdot = _kinematic_qdot(spec, q, u)
    J, Jdot = jvp(lambda qq: body_jacobians(spec, qq), (q,), (qdot,))
    R, p = forward_kinematics(spec, q)
    return _bias_from(spec, q, u, R, p, J, Jdot,
                      _inertias_from_fk(spec, q, R, p))


def _feet_from(spec, q, R, p):
    st = _st(spec, q)
    return (p.index_select(-2, st.foot_body)
            + _matvec(R.index_select(-3, st.foot_body), st.foot_pos))


def foot_points(spec: RigidBodySpec, q: torch.Tensor) -> torch.Tensor:
    """(..., n_feet, 3) world foot positions."""
    R, p = forward_kinematics(spec, q)
    return _feet_from(spec, q, R, p)


def _contact_from(spec, q, J, feet, point=False):
    """(..., n_feet, contact_dim, nv): the point-velocity rows v_p = v_O +
    omega x p_f, i.e. J_lin - skew(p_f) J_ang, and for flat feet (unless
    `point`) the angular rows."""
    Jf = J.index_select(-3, _st(spec, q).foot_body)
    lin = Jf[..., 3:6, :] - _skew(feet) @ Jf[..., 0:3, :]
    if point or spec.contact_dim == 3:
        return lin
    return torch.cat([lin, Jf[..., 0:3, :]], dim=-2)


def contact_jacobian(spec: RigidBodySpec, q: torch.Tensor) -> torch.Tensor:
    """(..., n_feet, 3, nv) world-frame point-velocity Jacobians
    Jc = J_lin - skew(p_f) J_ang."""
    R, p = forward_kinematics(spec, q)
    J = _jacobians_from_fk(spec, q, R, p)
    return _contact_from(spec, q, J, _feet_from(spec, q, R, p), point=True)


def foot_orientations(spec: RigidBodySpec, q: torch.Tensor) -> torch.Tensor:
    """(..., n_feet, 3, 3) world rotations of the foot bodies."""
    R, _ = forward_kinematics(spec, q)
    return R.index_select(-3, _st(spec, q).foot_body)


def contact_frame_jacobian(spec: RigidBodySpec,
                           q: torch.Tensor) -> torch.Tensor:
    """(..., n_feet, contact_dim, nv) contact Jacobians: point feet the
    point-velocity rows, flat feet (contact_dim=6, Crocoddyl
    ContactModel6D) [point velocity (3); world angular velocity (3)]."""
    R, p = forward_kinematics(spec, q)
    J = _jacobians_from_fk(spec, q, R, p)
    return _contact_from(spec, q, J, _feet_from(spec, q, R, p))


def _flat_rot_err(Rf):
    """Small-angle rotation error toward the flat ground frame: 0.5 *
    vee(R - R'), the first-order log of R about identity."""
    return 0.5 * torch.stack([Rf[..., 2, 1] - Rf[..., 1, 2],
                              Rf[..., 0, 2] - Rf[..., 2, 0],
                              Rf[..., 1, 0] - Rf[..., 0, 1]], dim=-1)


def centroidal_momentum(spec: RigidBodySpec, q: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """(..., 6) centroidal momentum [linear(3), angular about the com(3)]
    (the reference extracts it per knot with Pinocchio,
    src/whole_body_control.py:396-399)."""
    R, p = forward_kinematics(spec, q)
    J = _jacobians_from_fk(spec, q, R, p)
    I6 = _inertias_from_fk(spec, q, R, p)
    return _momentum_from(I6, J, u, _com_from(spec, q, R, p))


def _momentum_from(I6, J, u, com):
    """[linear; angular about the com] from the world-origin momentum."""
    h_o = torch.einsum("...brs,...bsj,...j->...r", I6, J, u)
    lin = h_o[..., 3:6]
    return torch.cat([lin, h_o[..., 0:3] - torch.linalg.cross(com, lin)],
                     dim=-1)


def _com_from(spec, q, R, p):
    m = _st(spec, q).mass
    return (m[:, None] * _coms(spec, q, R, p)).sum(-2) / m.sum()


def com_position(spec: RigidBodySpec, q: torch.Tensor) -> torch.Tensor:
    """(..., 3) whole-body centre of mass."""
    R, p = forward_kinematics(spec, q)
    return _com_from(spec, q, R, p)


@dataclasses.dataclass(frozen=True)
class ContactDynamicsSettings:
    baumgarte_kp: float = 100.0    # position stabilization [1/s^2]
    baumgarte_kd: float = 20.0     # velocity stabilization [1/s]
    kkt_damping: float = 1e-9


def constrained_forward_dynamics(
        spec: RigidBodySpec, q: torch.Tensor, u: torch.Tensor,
        tau: torch.Tensor, contact_mask: torch.Tensor,
        contact_ref: torch.Tensor,
        settings: ContactDynamicsSettings = ContactDynamicsSettings()):
    """Contact-constrained forward dynamics (Crocoddyl's KKT system).

        [ M   -Jc' ] [udot]   [ S' tau - h ]
        [ Jc    0  ] [ f  ] = [ -gamma - baumgarte ]

    solved as one dense system with inactive contacts masked to identity
    rows (f_i = 0).  contact_mask (..., n_feet) 1/0; contact_ref (...,
    n_feet, 3) world anchors for the Baumgarte term.  Flat feet
    (contact_dim=6) also hold the foot's angular velocity, with an
    orientation Baumgarte term toward the flat ground frame.  Returns
    (udot (..., nv), forces (..., n_feet, contact_dim))."""
    terms = dynamics_terms(spec, q, u, tau, contact_mask, contact_ref,
                           settings)
    return terms.udot, terms.forces


class DynamicsTerms(NamedTuple):
    """`constrained_forward_dynamics` and the task quantities of the same
    configuration, from one tree walk (the whole-body DDP's knot)."""

    udot: torch.Tensor       # (..., nv)
    forces: torch.Tensor     # (..., n_feet, contact_dim)
    feet: torch.Tensor       # (..., n_feet, 3)
    com: torch.Tensor        # (..., 3)
    momentum: torch.Tensor   # (..., 6) centroidal [linear, angular]


def dynamics_terms(spec: RigidBodySpec, q: torch.Tensor, u: torch.Tensor,
                   tau: torch.Tensor, contact_mask: torch.Tensor,
                   contact_ref: torch.Tensor,
                   settings: ContactDynamicsSettings = ContactDynamicsSettings()
                   ) -> DynamicsTerms:
    """The contact-KKT forward dynamics with the feet, the CoM and the
    centroidal momentum at q, u: the values of
    `constrained_forward_dynamics`, `foot_points`, `com_position` and
    `centroidal_momentum`, sharing one forward kinematics and one jvp."""
    dtype = q.dtype
    nv, nf, cd = spec.nv, spec.n_feet, spec.contact_dim
    nc = nf * cd
    R, p = forward_kinematics(spec, q)
    I6 = _inertias_from_fk(spec, q, R, p)
    qdot = _kinematic_qdot(spec, q, u)

    def jacobians(qq):
        r, pp = forward_kinematics(spec, qq)
        J = _jacobians_from_fk(spec, qq, r, pp)
        return J, _contact_from(spec, qq, J, _feet_from(spec, qq, r, pp))

    (J, Jc), (Jdot, Jc_dot) = jvp(jacobians, (q,), (qdot,))
    M = _mass_from(J, I6)
    h = _bias_from(spec, q, u, R, p, J, Jdot, I6)
    Jc = Jc.reshape(Jc.shape[:-3] + (nc, nv))
    gamma = _matvec(Jc_dot.reshape(Jc.shape), u)
    feet = _feet_from(spec, q, R, p)
    pos_err = feet - contact_ref
    if cd == 6:
        rot_err = _flat_rot_err(R.index_select(-3, _st(spec, q).foot_body))
        err = torch.cat([pos_err, rot_err], dim=-1)
    else:
        err = pos_err
    err = err.reshape(err.shape[:-2] + (nc,))
    rhs_c = -(gamma + settings.baumgarte_kd * _matvec(Jc, u)
              + settings.baumgarte_kp * err)

    mask = contact_mask.to(dtype)[..., :, None].expand(
        contact_mask.shape + (cd,)).reshape(contact_mask.shape[:-1] + (nc,))
    Jm = mask[..., :, None] * Jc
    # inactive rows: f_i = 0 by an identity diagonal; active rows get a
    # tiny dual damping for rank safety at singular leg extensions
    lower = torch.diag_embed(torch.where(
        mask > 0.5, torch.full_like(mask, -settings.kkt_damping),
        torch.ones_like(mask)))
    lead = torch.broadcast_shapes(M.shape[:-2], Jm.shape[:-2],
                                  tau.shape[:-1], contact_ref.shape[:-2])
    kkt = torch.cat([
        torch.cat([M.expand(lead + (nv, nv)),
                   -Jm.transpose(-1, -2).expand(lead + (nv, nc))], dim=-1),
        torch.cat([Jm.expand(lead + (nc, nv)),
                   lower.expand(lead + (nc, nc))], dim=-1)], dim=-2)
    tau_gen = torch.cat([torch.zeros(tau.shape[:-1] + (6,), dtype=dtype,
                                     device=q.device), tau], dim=-1)
    rhs = torch.cat([(tau_gen - h).expand(lead + (nv,)),
                     (mask * rhs_c).expand(lead + (nc,))], dim=-1)
    sol = solve(kkt, rhs[..., None])[..., 0]
    # the task quantities (centroidal_momentum, com_position)
    com = _com_from(spec, q, R, p)
    momentum = _momentum_from(I6, J, u, com)
    return DynamicsTerms(udot=sol[..., :nv],
                         forces=sol[..., nv:].reshape(lead + (nf, cd)),
                         feet=feet, com=com, momentum=momentum)


class PlantTerms(NamedTuple):
    """The unconstrained dynamics at (q, u) and what a simulated plant
    reads there, from one tree walk (`plant_terms`)."""

    M: torch.Tensor          # (..., nv, nv) mass matrix
    bias: torch.Tensor       # (..., nv) h(q, u): Coriolis and gravity
    J: torch.Tensor          # (..., nb, 6, nv) world-origin Jacobians
    Jc: torch.Tensor         # (..., n_feet, 3, nv) point-foot Jacobians
    feet: torch.Tensor       # (..., n_feet, 3)
    com: torch.Tensor        # (..., 3)
    momentum: torch.Tensor   # (..., 6) centroidal [linear, angular]


def plant_terms(spec: RigidBodySpec, q: torch.Tensor,
                u: torch.Tensor) -> PlantTerms:
    """The values of `mass_matrix`, `bias_forces`, `body_jacobians`,
    `contact_jacobian`, `foot_points`, `com_position` and
    `centroidal_momentum` at q, u, from ONE jvp of the forward kinematics
    and Jacobians along the coordinate rates (its primal gives the poses
    and J, its tangent Jdot u's Jacobian rate)."""
    def walk(qq):
        R, p = forward_kinematics(spec, qq)
        return R, p, _jacobians_from_fk(spec, qq, R, p)

    (R, p, J), (_, _, Jdot) = jvp(walk, (q,), (_kinematic_qdot(spec, q, u),))
    I6 = _inertias_from_fk(spec, q, R, p)
    feet = _feet_from(spec, q, R, p)
    com = _com_from(spec, q, R, p)
    return PlantTerms(M=_mass_from(J, I6),
                      bias=_bias_from(spec, q, u, R, p, J, Jdot, I6), J=J,
                      Jc=_contact_from(spec, q, J, feet, point=True),
                      feet=feet, com=com,
                      momentum=_momentum_from(I6, J, u, com))


def integrate_step(spec: RigidBodySpec, q: torch.Tensor, u: torch.Tensor,
                   udot: torch.Tensor, dt: float):
    """Semi-implicit Euler: update the velocity first, then the
    configuration."""
    u_next = u + dt * udot
    q_next = q + dt * _kinematic_qdot(spec, q, u_next)
    return q_next, u_next
