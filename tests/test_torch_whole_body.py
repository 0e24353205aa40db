"""The whole-body layer of the PyTorch port against the JAX package's,
float64 on the CPU: closed-form leg kinematics, the numpy copies
(polynomials, interpolation, artifacts, swing), the kinematic stage 3
(`track_centroidal_solution`, `export_robot_dat`), the whole-body DDP's
targets and warm-start helpers, and `solve_whole_body_ddp` on the 1-step
trot of tests/test_whole_body_ddp.py against the JAX package's solve in
tests/data/jax_pipeline_solo12_trot_n50.npz (no JAX compile of the
solve, ~5 min on a CPU).  `slow`: the same against a live JAX solve,
and talos."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_util
from centroidal_mpc_tpu.config import gaits as jgaits
from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.config.robots import SOLO12 as J_SOLO12
from centroidal_mpc_tpu.config.robots import TALOS as J_TALOS
from centroidal_mpc_tpu.contact import swing as jswing
from centroidal_mpc_tpu.contact.plan import build_contact_plan as j_plan
from centroidal_mpc_tpu.models import kinematics as jkin
from centroidal_mpc_tpu.models import rigid_body as jrb
from centroidal_mpc_tpu.models import whole_body as jwb
from centroidal_mpc_tpu.models import whole_body_ddp as jwbd
from centroidal_mpc_tpu.utils import artifacts as jart
from centroidal_mpc_tpu.utils import interpolation as jinterp
from centroidal_mpc_tpu.utils import polynomials as jpoly
from centroidal_mpc_tpu_torch.config import gaits as tgaits
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.config.robots import SOLO12 as T_SOLO12
from centroidal_mpc_tpu_torch.config.robots import TALOS as T_TALOS
from centroidal_mpc_tpu_torch.contact import swing as tswing
from centroidal_mpc_tpu_torch.contact.plan import build_contact_plan as t_plan
from centroidal_mpc_tpu_torch.models import kinematics as tkin
from centroidal_mpc_tpu_torch.models import rigid_body as trb
from centroidal_mpc_tpu_torch.models import whole_body as twb
from centroidal_mpc_tpu_torch.models import whole_body_ddp as twbd
from centroidal_mpc_tpu_torch.solver.ddp import DdpSettings
from centroidal_mpc_tpu_torch.utils import artifacts as tart
from centroidal_mpc_tpu_torch.utils import interpolation as tinterp
from centroidal_mpc_tpu_torch.utils import polynomials as tpoly

TOL = 1e-12
DDP_TOL = 1e-9
DT, DT_CTRL = 0.01, 0.001
TARGET_FIELDS = ("contact_mask", "contact_ref", "foot_target", "com_target",
                 "mom_target", "force_target")


def close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# kinematics and the numpy copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geom", ["SOLO12_LEGS", "BOLT_LEGS"])
def test_leg_kinematics_match_jax(geom):
    jg, tg = getattr(jkin, geom), getattr(tkin, geom)
    rng = np.random.default_rng(0)
    n_legs = jg.n_legs
    q = 0.6 * rng.standard_normal((6, n_legs, 3))
    forces = 10.0 * rng.standard_normal((6, n_legs, 3))
    feet = np.asarray(jax.vmap(lambda a: jkin.fk_all_legs(a, jg))(q))
    close(tkin.fk_all_legs(torch.tensor(q), tg), feet)
    # IK of the FK's feet, perturbed
    targets = feet + 0.02 * rng.standard_normal(feet.shape)
    close(tkin.ik_all_legs(torch.tensor(targets), tg),
          jax.vmap(lambda a: jkin.ik_all_legs(a, jg))(targets))
    close(tkin.feet_contact_torques(torch.tensor(q), torch.tensor(forces),
                                    tg),
          jax.vmap(lambda a, f: jkin.feet_contact_torques(a, f, jg))(
              q, forces))
    side = jg.side_signs()[0]
    close(tkin.leg_jacobian(torch.tensor(q[:, 0]), side, tg),
          jax.vmap(lambda a: jkin.leg_jacobian(a, side, jg))(q[:, 0]))
    close(tkin.leg_fk(torch.tensor(q[0, 0]), side, tg),
          jkin.leg_fk(q[0, 0], side, jg))
    close(tkin.leg_ik(torch.tensor(targets[0, 0]), side, -1.0, tg),
          jkin.leg_ik(targets[0, 0], side, -1.0, jg))
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)


def test_polynomials_interpolation_and_artifacts_match_jax(tmp_path):
    for fn in ("poly3_traj", "poly5_traj"):
        for a, b in zip(getattr(tpoly, fn)([0.1, -0.2], [0.5, 0.3], 0.08,
                                           0.001),
                        getattr(jpoly, fn)([0.1, -0.2], [0.5, 0.3], 0.08,
                                           0.001)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(1)
    X, U = rng.standard_normal((11, 9)), rng.standard_normal((10, 12))
    got = tinterp.interpolate_scp_solution(torch.tensor(X), torch.tensor(U))
    want = jinterp.interpolate_scp_solution(X, U)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        tinterp.interpolate_zero_order(torch.tensor(U), 10),
        jinterp.interpolate_zero_order(U, 10))
    for name in ("WHOLEBODY_TO_CENTROIDAL", "CENTROIDAL_TO_WHOLEBODY",
                 "SCP_INTERPOLATED_NOMINAL", "SCP_INTERPOLATED_STOCHASTIC",
                 "WHOLEBODY_INTERPOLATED"):
        assert getattr(tart, name) == getattr(jart, name)
    store = tart.ArtifactStore(tmp_path / "sub")
    store.save("thing", a=torch.arange(3), b=np.eye(2))
    assert store.exists("thing") and store.maybe_load("missing") is None
    # a store written by the port reads like one written by JAX
    loaded = jart.ArtifactStore(tmp_path / "sub").load("thing")
    np.testing.assert_array_equal(loaded["a"], np.arange(3))
    np.testing.assert_array_equal(loaded["b"], np.eye(2))


@pytest.mark.parametrize("name", ["solo12_trot_n50", "bolt_pace",
                                  "solo12_bound"])
def test_swing_trajectories_match_jax(name):
    jp, tp = jpresets.PRESETS[name], tpresets.PRESETS[name]
    jplan = j_plan(jp.robot, jp.gait, jp.dt, dtype=jnp.float64)
    tplan = t_plan(tp.robot, tp.gait, tp.dt, dtype=torch.float64,
                   device="cpu")
    got = tswing.compute_swing_trajectories(tplan, tp.dt_ctrl).as_dict()
    want = jswing.compute_swing_trajectories(jplan, jp.dt_ctrl).as_dict()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# stage 3, kinematic
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def n50():
    """solo12_trot_n50's plans in both packages and the JAX pipeline's
    nominal SCP solution."""
    ref = np.load(torch_parity_util.PIPELINE_REF)
    jp, tp = jpresets.SOLO12_TROT_N50, tpresets.SOLO12_TROT_N50
    jplan = j_plan(jp.robot, jp.gait, jp.dt, dtype=jnp.float64)
    tplan = t_plan(tp.robot, tp.gait, tp.dt, dtype=torch.float64,
                   device="cpu")
    return (jplan, tplan, jswing.compute_swing_trajectories(jplan, 0.001),
            tswing.compute_swing_trajectories(tplan, 0.001), ref)


def test_track_centroidal_solution_and_dat_export_match_jax(n50, tmp_path):
    jplan, tplan, jsw, tsw, ref = n50
    X, U = ref["nom_X"], ref["nom_U"]
    want = jwb.track_centroidal_solution(jplan, jsw, jnp.asarray(X),
                                         jnp.asarray(U), DT_CTRL,
                                         base_height_offset=0.01)
    got = twb.track_centroidal_solution(tplan, tsw, torch.tensor(X),
                                        torch.tensor(U), DT_CTRL,
                                        base_height_offset=0.01)
    for f in ("base_pos", "q", "qdot", "tau_ff", "feet", "kp", "kd"):
        close(getattr(got, f), getattr(want, f))
    jfiles = jwb.export_robot_dat(want, tmp_path / "jax")
    tfiles = twb.export_robot_dat(got, tmp_path / "port")
    assert sorted(os.path.basename(f) for f in tfiles.values()) == sorted(
        os.path.basename(f) for f in jfiles.values())
    for k in jfiles:
        close(np.loadtxt(tfiles[k]), np.loadtxt(jfiles[k]))
    # the pipeline's own stage-3 numbers (offset 0)
    traj = twb.track_centroidal_solution(tplan, tsw, torch.tensor(X),
                                         torch.tensor(U), DT_CTRL)
    for f in ("q", "qdot", "tau_ff"):
        close(getattr(traj, f), ref[f"kin_{f}"])


# ---------------------------------------------------------------------------
# whole-body DDP: targets and warm-start helpers
# ---------------------------------------------------------------------------

TROT1 = dict(step_length=0.06, step_height=0.05, step_knots=8,
             support_knots=4, nb_steps=1)


@pytest.fixture(scope="module")
def trot1():
    """The 1-step trot of tests/test_whole_body_ddp.py:27-35 in both
    packages, with its stage-1 targets."""
    jplan = j_plan(J_SOLO12, jgaits.GaitSpec(jgaits.TROT, **TROT1), DT,
                   dtype=jnp.float64)
    tplan = t_plan(T_SOLO12, tgaits.GaitSpec(tgaits.TROT, **TROT1), DT,
                   dtype=torch.float64, device="cpu")
    jsw = jswing.compute_swing_trajectories(jplan, DT_CTRL)
    tsw = tswing.compute_swing_trajectories(tplan, DT_CTRL)
    jt = jwbd.build_targets(jplan, jsw, DT_CTRL, dtype=jnp.float64)
    tt = twbd.build_targets(tplan, tsw, DT_CTRL)
    return jplan, tplan, jsw, tsw, jt, tt


def test_build_targets_match_jax(trot1, n50):
    *_, jt, tt = trot1
    for f in TARGET_FIELDS:
        close(getattr(tt, f), getattr(jt, f), 0.0)
    # stage-3 mode from an SCP solution
    jplan, tplan, jsw, tsw, ref = n50
    jt3 = jwbd.build_targets(jplan, jsw, DT_CTRL,
                             X_centroidal=jnp.asarray(ref["nom_X"]),
                             U_centroidal=jnp.asarray(ref["nom_U"]),
                             dtype=jnp.float64)
    tt3 = twbd.build_targets(tplan, tsw, DT_CTRL,
                             X_centroidal=torch.tensor(ref["nom_X"]),
                             U_centroidal=torch.tensor(ref["nom_U"]))
    for f in TARGET_FIELDS:
        close(getattr(tt3, f), getattr(jt3, f), 0.0)


def test_warm_start_helpers_match_jax(trot1):
    *_, jt, tt = trot1
    jspec, tspec = jrb.solo12_spec(), trb.solo12_spec()
    assert dataclasses.asdict(twbd.leg_geometry_from_spec(tspec)) == \
        dataclasses.asdict(jwbd.leg_geometry_from_spec(jspec))
    assert twbd.leg_geometry_from_spec(trb.talos_spec()) is None
    jx0 = jwbd.standing_state(jspec, jt)
    tx0 = twbd.standing_state(tspec, tt)
    close(tx0, jx0)
    close(twbd.quasi_static_torques(tspec, tx0[:18], tt.contact_mask[0]),
          jwbd.quasi_static_torques(jspec, jx0[:18], jt.contact_mask[0]),
          1e-10)
    close(twbd.gravity_torque_warm_start(tspec, tt),
          jwbd.gravity_torque_warm_start(jspec, jt), 1e-10)
    close(twbd.kinematic_state_warm_start(tspec, tt),
          jwbd.kinematic_state_warm_start(jspec, jt))
    close(twbd.default_joint_guess(trb.talos_spec()),
          jwbd.default_joint_guess(jrb.talos_spec()), 0.0)


def test_talos_numeric_standing_state_matches_jax():
    """The damped-least-squares IK path (talos: 6-DoF legs, flat feet)."""
    gait = dataclasses.replace(jpresets.TALOS_PACE.gait, step_length=0.0,
                               step_knots=5, support_knots=2, nb_steps=1)
    jplan = j_plan(J_TALOS, gait, 0.03, dtype=jnp.float64)
    tplan = t_plan(T_TALOS, dataclasses.replace(
        tpresets.TALOS_PACE.gait, step_length=0.0, step_knots=5,
        support_knots=2, nb_steps=1), 0.03, dtype=torch.float64,
        device="cpu")
    jt = jwbd.build_targets(jplan, jswing.compute_swing_trajectories(
        jplan, DT_CTRL), DT_CTRL, dtype=jnp.float64)
    tt = twbd.build_targets(tplan, tswing.compute_swing_trajectories(
        tplan, DT_CTRL), DT_CTRL)
    close(twbd.standing_state(trb.talos_spec(), tt),
          jwbd.standing_state(jrb.talos_spec(), jt), 1e-10)


# ---------------------------------------------------------------------------
# whole-body DDP solves
# ---------------------------------------------------------------------------


def assert_solution(sol, Q, V, TAU, cost, iterations, tol=DDP_TOL):
    assert sol.iterations == iterations
    close(sol.Q, Q, tol)
    close(sol.V, V, tol)
    close(sol.TAU, TAU, tol)
    np.testing.assert_allclose(float(sol.cost), float(cost), rtol=1e-10)


def test_whole_body_ddp_matches_the_jax_solve(trot1):
    """solve_whole_body_ddp with its defaults (60 iterations, exact Quu)
    on the 1-step trot: the JAX package's solve stops at 38."""
    _, tplan, _, _, _, tt = trot1
    ref = np.load(torch_parity_util.PIPELINE_REF)
    spec = trb.solo12_spec()
    sol = twbd.solve_whole_body_ddp(spec, tt, DT)
    assert_solution(sol, ref["trot1_Q"], ref["trot1_V"], ref["trot1_TAU"],
                    ref["trot1_cost"], int(ref["trot1_iterations"]))
    # the extraction and the 1 kHz payload
    n = tplan.horizon
    assert sol.forces.shape == (n, 4, 3) and sol.K.shape == (n, 12, 36)
    close(sol.centroidal_states()[:, :3], sol.com, 0.0)
    close(sol.feet, trb.foot_points(spec, sol.Q), 0.0)
    traj = twbd.interpolate_whole_body_solution(sol, DT, DT_CTRL)
    assert traj["q"].shape == (n * 10, spec.nq)
    assert traj["tau_ff"].shape == (n * 10, spec.n_joints)
    assert traj["forces"].shape == (n * 10, 12)
    assert traj["gains"].shape == (n * 10, 12 * 36)
    # the solved X is a rollout of the solved U (iLQR invariant)
    udot, _ = trb.constrained_forward_dynamics(
        spec, sol.Q[5], sol.V[5], sol.TAU[5], tt.contact_mask[5],
        tt.contact_ref[5])
    qn, vn = trb.integrate_step(spec, sol.Q[5], sol.V[5], udot, DT)
    close(qn, sol.Q[6], 1e-10)
    close(vn, sol.V[6], 1e-10)


@pytest.mark.slow  # XLA:CPU's compile of the JAX solve, ~5 min
def test_whole_body_ddp_matches_live_jax(trot1):
    """The same solve against the JAX package run here, in FDDP mode from
    the kinematic state warm start (tests/test_whole_body_ddp.py:
    151-176's pattern) and from the default start."""
    *_, jt, tt = trot1
    jspec, tspec = jrb.solo12_spec(), trb.solo12_spec()
    from centroidal_mpc_tpu.solver.ddp import DdpSettings as JDdpSettings
    for fddp in (False, True):
        jx = jwbd.kinematic_state_warm_start(jspec, jt) if fddp else None
        tx = twbd.kinematic_state_warm_start(tspec, tt) if fddp else None
        want = jwbd.solve_whole_body_ddp(
            jspec, jt, DT, X_traj=jx,
            settings=JDdpSettings(iterations=40, exact_quu=True))
        got = twbd.solve_whole_body_ddp(
            tspec, tt, DT, X_traj=tx,
            settings=DdpSettings(iterations=40, exact_quu=True))
        assert_solution(got, want.Q, want.V, want.TAU, want.cost,
                        int(want.iterations))


@pytest.mark.slow  # XLA:CPU's compile of the wrench6 solve, ~5 min
def test_talos_whole_body_ddp_matches_live_jax():
    """tests/test_whole_body_biped.py:205-213's talos pace (flat feet,
    6-DoF legs, the numeric IK warm start), 30 iterations."""
    from centroidal_mpc_tpu.solver.ddp import DdpSettings as JDdpSettings
    jg = jgaits.GaitSpec(jgaits.PACE, step_length=0.0, step_height=0.05,
                         step_knots=5, support_knots=2, nb_steps=1)
    tg = tgaits.GaitSpec(tgaits.PACE, step_length=0.0, step_height=0.05,
                         step_knots=5, support_knots=2, nb_steps=1)
    jplan = j_plan(J_TALOS, jg, 0.03, dtype=jnp.float64)
    tplan = t_plan(T_TALOS, tg, 0.03, dtype=torch.float64, device="cpu")
    jt = jwbd.build_targets(jplan, jswing.compute_swing_trajectories(
        jplan, DT_CTRL), DT_CTRL, dtype=jnp.float64)
    tt = twbd.build_targets(tplan, tswing.compute_swing_trajectories(
        tplan, DT_CTRL), DT_CTRL)
    want = jwbd.solve_whole_body_ddp(
        jrb.talos_spec(), jt, 0.03,
        settings=JDdpSettings(iterations=30, exact_quu=True))
    got = twbd.solve_whole_body_ddp(
        trb.talos_spec(), tt, 0.03,
        settings=DdpSettings(iterations=30, exact_quu=True))
    assert got.forces.shape == (tplan.horizon, 2, 6)
    assert_solution(got, want.Q, want.V, want.TAU, want.cost,
                    int(want.iterations), 1e-8)
