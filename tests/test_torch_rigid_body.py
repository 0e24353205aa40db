"""The rigid-body engine of the PyTorch port (models/rigid_body.py)
against the JAX package's, float64 on the CPU: every function for solo12,
bolt and talos at 8 seeded configurations (q, v, tau, contact masks
mixed), 1e-10 relative to the largest entry; and forward-mode Jacobians
(vmap over knots of jacfwd) of the contact dynamics and of the
whole-body stage residual against JAX's jacfwd, 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import torch_parity_util
from centroidal_mpc_tpu.models import rigid_body as jrb
from centroidal_mpc_tpu_torch import convert
from centroidal_mpc_tpu_torch.models import rigid_body as trb
from centroidal_mpc_tpu_torch.ops.linalg import solve

ROBOTS = ("solo12", "bolt", "talos")
N_CONFIGS = 8
RTOL = 1e-10
JAC_RTOL = 1e-9


def configs(name, seed=0):
    """8 configurations of a robot: (q, v, tau, contact mask, contact
    anchors) as numpy float64, masks mixing planted and swinging feet."""
    spec = jrb.robot_spec(name)
    rng = np.random.default_rng(seed)
    n = N_CONFIGS
    q = 0.3 * rng.standard_normal((n, spec.nq))
    q[:, 2] += 0.3
    v = rng.standard_normal((n, spec.nv))
    tau = rng.standard_normal((n, spec.n_joints))
    mask = (rng.random((n, spec.n_feet)) > 0.4).astype(np.float64)
    mask[0] = 1.0
    mask[1] = 0.0
    ref = 0.1 * rng.standard_normal((n, spec.n_feet, 3))
    return q, v, tau, mask, ref


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def check(jout, tout, rtol=RTOL):
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert a.shape == tuple(b.shape)
        assert rel_err(a, b.numpy()) < rtol, rel_err(a, b.numpy())


# (function, which of (v, tau, mask, ref) it takes after q)
FUNCTIONS = {
    "forward_kinematics": (), "body_jacobians": (),
    "spatial_inertias_world": (), "mass_matrix": (), "bias_forces": ("v",),
    "foot_points": (), "contact_jacobian": (), "contact_frame_jacobian": (),
    "foot_orientations": (), "centroidal_momentum": ("v",),
    "com_position": (),
}


@pytest.mark.parametrize("name", ROBOTS)
@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
def test_function_matches_jax(name, fn):
    q, v, *_ = configs(name)
    extra = {"v": v}
    jspec, tspec = jrb.robot_spec(name), trb.robot_spec(name)
    jargs = [jnp.asarray(q)] + [jnp.asarray(extra[a]) for a in FUNCTIONS[fn]]
    targs = [torch.tensor(q)] + [torch.tensor(extra[a]) for a in FUNCTIONS[fn]]
    jout = jax.vmap(lambda *a: getattr(jrb, fn)(jspec, *a))(*jargs)
    # the port's functions take the 8 configurations as leading axes
    check(jout, getattr(trb, fn)(tspec, *targs))


@pytest.mark.parametrize("name", ROBOTS)
def test_constrained_forward_dynamics_matches_jax(name):
    q, v, tau, mask, ref = configs(name)
    jspec, tspec = jrb.robot_spec(name), trb.robot_spec(name)
    jout = jax.vmap(lambda *a: jrb.constrained_forward_dynamics(jspec, *a))(
        *map(jnp.asarray, (q, v, tau, mask, ref)))
    tout = trb.constrained_forward_dynamics(
        tspec, *map(torch.tensor, (q, v, tau, mask, ref)))
    check(jout, tout)
    # the shared-walk terms agree with the functions they stand for
    terms = trb.dynamics_terms(tspec, *map(torch.tensor,
                                           (q, v, tau, mask, ref)))
    tq, tv = torch.tensor(q), torch.tensor(v)
    for got, want in ((terms.udot, tout[0]), (terms.forces, tout[1]),
                      (terms.feet, trb.foot_points(tspec, tq)),
                      (terms.com, trb.com_position(tspec, tq)),
                      (terms.momentum,
                       trb.centroidal_momentum(tspec, tq, tv))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ROBOTS)
def test_integrate_step_and_one_config_match_jax(name):
    """integrate_step, and each function on one configuration (no
    leading axis) equal to its row of the batched call."""
    q, v, tau, mask, ref = configs(name)
    jspec, tspec = jrb.robot_spec(name), trb.robot_spec(name)
    udot = np.asarray(jax.vmap(
        lambda *a: jrb.constrained_forward_dynamics(jspec, *a)[0])(
            *map(jnp.asarray, (q, v, tau, mask, ref))))
    jout = jax.vmap(lambda a, b, c: jrb.integrate_step(jspec, a, b, c, 0.01))(
        *map(jnp.asarray, (q, v, udot)))
    tout = trb.integrate_step(tspec, *map(torch.tensor, (q, v, udot)), 0.01)
    check(jout, tout)
    batched = trb.constrained_forward_dynamics(
        tspec, *map(torch.tensor, (q, v, tau, mask, ref)))
    for i in range(N_CONFIGS):
        one = trb.constrained_forward_dynamics(
            tspec, *(torch.tensor(a[i]) for a in (q, v, tau, mask, ref)))
        check(tuple(b[i].numpy() for b in batched), one, 1e-12)


def test_robot_specs_match_jax():
    for name in ROBOTS:
        js, ts = jrb.robot_spec(name), trb.robot_spec(name)
        assert ts.parent == js.parent and ts.foot_body == js.foot_body
        assert ts.contact_dim == js.contact_dim and ts.nq == js.nq
        for f in ("joint_pos", "joint_axis", "mass", "com", "inertia",
                  "foot_pos"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        assert trb.robot_spec(name) is ts
    with pytest.raises(KeyError):
        trb.robot_spec("anymal")


@pytest.mark.parametrize("name", ("solo12", "talos"))
def test_vmap_jacfwd_of_contact_dynamics_matches_jax(name):
    """d(udot, f)/d(q, v, tau) over 8 knots: the port's vmap(jacfwd) (its
    nested forward mode through the bias jvp and the KKT solve) against
    JAX's, for point feet (solo12; bolt has the same contact model) and
    flat feet (talos)."""
    q, v, tau, mask, ref = configs(name, seed=1)
    jspec, tspec = jrb.robot_spec(name), trb.robot_spec(name)
    nq, nv = jspec.nq, jspec.nv
    z = np.concatenate([q, v, tau], axis=1)

    def jf(zz, m, r):
        return jrb.constrained_forward_dynamics(
            jspec, zz[:nq], zz[nq:nq + nv], zz[nq + nv:], m, r)

    def tf(zz, m, r):
        return trb.constrained_forward_dynamics(
            tspec, zz[:nq], zz[nq:nq + nv], zz[nq + nv:], m, r)

    jout = jax.jit(jax.vmap(jax.jacfwd(jf)))(*map(jnp.asarray,
                                                  (z, mask, ref)))
    tout = vmap(jacfwd(tf))(*map(torch.tensor, (z, mask, ref)))
    check(jout, tout, JAC_RTOL)


def test_vmap_jacfwd_of_stage_residual_matches_jax():
    """The whole-body DDP's stage residual and dynamics at knots of a
    1-step solo12 trot (all feet planted, two swinging): the port's
    whole_body_ocp against the same residual written with the JAX
    package's functions (centroidal_mpc_tpu/models/whole_body_ddp.py:
    377-412), value and jacfwd over z = [x, u] a knot."""
    from centroidal_mpc_tpu.config import gaits
    from centroidal_mpc_tpu.config.robots import SOLO12
    from centroidal_mpc_tpu.contact.plan import build_contact_plan
    from centroidal_mpc_tpu.contact.swing import compute_swing_trajectories
    from centroidal_mpc_tpu.models import whole_body_ddp as jwbd
    from centroidal_mpc_tpu_torch.models import whole_body_ddp as twbd
    from centroidal_mpc_tpu_torch.solver.ddp import take

    gait = gaits.GaitSpec(gaits.TROT, step_length=0.06, step_height=0.05,
                          step_knots=8, support_knots=4, nb_steps=1)
    plan = build_contact_plan(SOLO12, gait, 0.01, dtype=jnp.float64)
    swing = compute_swing_trajectories(plan, 0.001)
    jt = jwbd.build_targets(plan, swing, 0.001, dtype=jnp.float64)
    tt = convert.from_numpy(twbd.WholeBodyTargets,
                            torch_parity_util.np_fields(jt), "cpu")
    jspec, tspec = jrb.solo12_spec(), trb.solo12_spec()
    nq = jspec.nq
    ks = np.array([0, 6])
    assert np.asarray(jt.contact_mask)[ks].sum(1).tolist() == [4.0, 2.0]
    rng = np.random.default_rng(2)
    x0 = np.asarray(jwbd.standing_state(jspec, jt))
    X = x0 + 0.05 * rng.standard_normal((len(ks), jspec.nx))
    U = rng.standard_normal((len(ks), jspec.n_joints))
    w = jwbd._weights_vector(jwbd.WholeBodyWeights(), jnp.float64)
    sdt = jnp.sqrt(jnp.asarray(0.01))
    q_ref = jnp.asarray(x0[:nq])

    def j_residual(x, u, k):   # whole_body_ddp.py:377-412
        q, v = x[:nq], x[nq:]
        udot, f = jrb.constrained_forward_dynamics(
            jspec, q, v, u, jt.contact_mask[k], jt.contact_ref[k])
        q_next, v_next = jrb.integrate_step(jspec, q, v, udot, 0.01)
        feet = jrb.foot_points(jspec, q)
        mom = jrb.centroidal_momentum(jspec, q, v)
        e_f = ((f[:, :3] - jt.force_target[k])
               * jt.contact_mask[k][:, None]).reshape(-1)
        r = sdt * jnp.concatenate([
            jnp.sqrt(w[0]) * (feet - jt.foot_target[k]).reshape(-1),
            jnp.sqrt(w[1]) * (jrb.com_position(jspec, q) - jt.com_target[k]),
            jnp.sqrt(w[2]) * (mom[0:3] - jt.mom_target[k, 0:3]),
            jnp.sqrt(w[3]) * (mom[3:6] - jt.mom_target[k, 3:6]),
            jnp.sqrt(w[5]) * (q[6:] - q_ref[6:]),
            jnp.sqrt(w[6]) * q[3:6],
            jnp.sqrt(w[7]) * v,
            jnp.sqrt(w[8]) * u,
            jnp.sqrt(w[4]) * e_f])
        return jnp.concatenate([q_next, v_next]), r

    ocp = twbd.whole_body_ocp(tspec, tt, 0.01, torch.tensor(x0[:nq]))
    def jz(z, k):
        return j_residual(z[:jspec.nx], z[jspec.nx:], k)

    def tz(z, k):
        return ocp.knot(z[:tspec.nx], z[tspec.nx:], k)

    Z = np.concatenate([X, U], axis=1)
    jval, jjac = jax.jit(jax.vmap(lambda z, k: (jz(z, k), jax.jacfwd(jz)(
        z, k))))(jnp.asarray(Z), ks)
    check(jval, vmap(tz)(torch.tensor(Z), torch.tensor(ks)))
    check(jjac, vmap(jacfwd(tz))(torch.tensor(Z), torch.tensor(ks)),
          JAC_RTOL)
    # take() reads the same knot as a Python int and as a tensor index
    assert torch.equal(take(tt.foot_target, 3),
                       vmap(lambda k: take(tt.foot_target, k))(
                           torch.tensor([3]))[0])


def test_solve_tangents_hold_under_vmap_of_jacfwd():
    """ops.linalg.solve: the tangents of a batch of systems that pivot
    differently, under vmap(jacfwd), equal each system's own jacfwd (the
    case where torch.linalg.solve's own forward rule goes wrong)."""
    gen = torch.Generator().manual_seed(0)
    Z = torch.randn(6, 15, generator=gen, dtype=torch.float64)

    def system(z):
        n = 5
        perm = torch.tensor([[0, 1., 0, 0, 0], [1, 0, 0, 0, 0],
                             [0, 0, 0, 1, 0], [0, 0, 1, 0, 0],
                             [0, 0, 0, 0, 0]], dtype=z.dtype)
        a = (0.3 * torch.outer(z[:n], z[n:2 * n]) + perm
             + torch.diag(torch.stack([z[0] * 0 + 1, z[1] * 0, z[2] + 2,
                                       z[3] * 0 + 1e-9, z[4] + 3])))
        return solve(a, z[2 * n:, None])[:, 0]

    batched = vmap(jacfwd(system))(Z)
    one_by_one = torch.stack([jacfwd(system)(z) for z in Z])
    torch.testing.assert_close(batched, one_by_one, rtol=1e-12, atol=1e-12)


def test_singular_solve_gives_non_finite_values_not_an_error():
    """As jnp.linalg.solve: a singular system (a line-search candidate
    whose state has blown up) yields inf/NaN, which the DDP's line search
    maps to an infinite merit, instead of raising."""
    A = torch.zeros((2, 3, 3), dtype=torch.float64)
    A[1] = torch.eye(3, dtype=torch.float64)
    x = solve(A, torch.ones((2, 3, 1), dtype=torch.float64))
    assert not bool(torch.isfinite(x[0]).all())
    assert torch.equal(x[1], torch.ones((3, 1), dtype=torch.float64))
