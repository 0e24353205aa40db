"""The port's full-physics plant (sim/physics.py, Terrain.arrays) against
the JAX package's, float64 on the CPU.

The contact laws, the surface query and the terrain's planes agree to
round-off.  The closed loop is held on the standing trot of
tests/test_physics_sim.py:26-41 with the same references and the same
explicit pushes (the two packages' random draws cannot be matched).  Its
friction anchors switch discretely, so round-off can part the two
trajectories: the unpushed episode stays within 1e-11 of max|.| for its
first 200 steps and parts near step 216 (1.1e-5 of max|h| at the end,
on an 8-core x86 CPU); the pushed one stays within 1e-9 throughout.  So
the first WINDOW steps are held to 1e-9 of max|.|, the whole episode to
1e-4.  The statistics (slippage, its series, the tracking cost, `fell`)
agree to round-off on the same simulated episodes.  The physical-property
tests of tests/test_physics_sim.py:44-122 run on the port alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu import presets as jpresets
from centroidal_mpc_tpu.config import gaits as jgaits
from centroidal_mpc_tpu.contact import terrain as jter
from centroidal_mpc_tpu.contact.swing import (
    compute_swing_trajectories as jswing)
from centroidal_mpc_tpu.models import rigid_body as jrb
from centroidal_mpc_tpu.models.centroidal import (
    compute_trajectory_data as jtraj)
from centroidal_mpc_tpu.models.whole_body import (
    track_centroidal_solution as jtrack)
from centroidal_mpc_tpu.sim import physics as jphys
from centroidal_mpc_tpu_torch import convert
from centroidal_mpc_tpu_torch.config import gaits, presets
from centroidal_mpc_tpu_torch.contact import terrain as ter
from centroidal_mpc_tpu_torch.contact.swing import compute_swing_trajectories
from centroidal_mpc_tpu_torch.models import rigid_body as rb
from centroidal_mpc_tpu_torch.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu_torch.models.whole_body import (
    track_centroidal_solution)
from centroidal_mpc_tpu_torch.sim import physics as phys

from torch_parity_util import np_fields

TOL = 1e-12
WINDOW = 200          # steps held to STEP_TOL of max|.|
STEP_TOL = 1e-9
EPISODE_TOL = 1e-4    # the whole episode, relative to max|.|
STEEP = 0.40          # tests/test_terrain.py's tilt, above the pyramid's
# the four terrains of the contact-law and surface tests
TERRAINS = {
    "flat": (jter.FLAT, ter.FLAT),
    "trot_debris": (jter.TROT_DEBRIS, ter.TROT_DEBRIS),
    "steep_stone": tuple(m.Terrain(stones=(m.Stepstone(
        center=(0.0, 0.0), height=0.02, roll=STEEP),)) for m in (jter, ter)),
}


def _standing(mod_presets, mod_gaits):
    """The standing trot of tests/test_physics_sim.py:26-41."""
    gait = mod_gaits.GaitSpec(mod_gaits.TROT, step_length=0.0,
                              step_height=0.03, step_knots=8,
                              support_knots=4, nb_steps=1)
    return dataclasses.replace(mod_presets.SOLO12_TROT, gait=gait)


@pytest.fixture(scope="module")
def closed_loop():
    """The fixture of tests/test_physics_sim.py:26-41 in the JAX package,
    its references converted to the port, and x0."""
    prob = jpresets.build_problem(_standing(jpresets, jgaits),
                                  dtype=jnp.float64)
    wb = jtrack(prob.plan, jswing(prob.plan, 0.001), prob.X0, prob.U0,
                0.001)
    data = jtraj(prob.model, prob.plan.schedule, prob.X0, prob.U0)
    jrefs = jphys.build_references(wb, prob.X0, data.K, prob.plan.schedule)
    spec = jrb.solo12_spec()
    q0 = jnp.concatenate([jrefs.h_des[0, :3], jnp.zeros(3), jrefs.q_des[0]])
    x0 = np.array(jnp.concatenate([q0, jnp.zeros(spec.nv)]))
    refs = convert.from_numpy(phys.ClosedLoopReferences, np_fields(jrefs),
                              "cpu")
    return jrefs, refs, x0


@pytest.fixture(scope="module")
def episodes(closed_loop):
    """One unpushed and one pushed episode in both packages, the same
    explicit pushes."""
    jrefs, refs, x0 = closed_loop
    forces = np.array([[0.0, 0.0, 0.0], [1.0, 6.0, -2.0]])
    starts = np.array([0, 40])
    jh, jf, jr = jax.jit(jax.vmap(lambda f, s: jphys.simulate_episode(
        jrb.solo12_spec(), jrefs, jnp.asarray(x0), f, s, 200)))(
            jnp.asarray(forces), jnp.asarray(starts))
    th, tf, tr = phys.simulate_episode(
        rb.solo12_spec(), refs, torch.as_tensor(x0), torch.as_tensor(forces),
        torch.as_tensor(starts), 200)
    return ((np.asarray(jh), np.asarray(jf), np.asarray(jr)),
            (th.numpy(), tf.numpy(), tr.numpy()), forces, starts, x0)


def _contact_inputs(name):
    """Feet, velocities and anchors around each terrain's surfaces:
    tests/test_physics_sim.py:44-72's four feet (flat), feet over the trot
    stones and off them, and tests/test_terrain.py:252-271's foot pressed
    into the steep stone, each with random neighbours (numpy seed)."""
    rng = np.random.default_rng(7)
    if name == "flat":
        feet = np.array([[0.0, 0.0, -0.002], [0.1, 0.0, -0.002],
                         [0.2, 0.0, 0.05], [0.3, 0.0, -0.001]])
        vel = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.0, 0.0],
                        [0.0, 0.0, 1.0]])
        anchors = feet + np.array([[0.0, 0.0, 0.0], [-0.05, 0.0, 0.0],
                                   [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    elif name == "trot_debris":
        feet = np.array([[0.25, 0.15, 0.008], [0.47, -0.16, 0.017],
                         [0.0, 0.0, -0.001], [0.29, -0.14, 0.02]])
        vel = 0.3 * rng.standard_normal((4, 3))
        anchors = feet + 0.01 * rng.standard_normal((4, 3))
    else:
        n = jter.Stepstone(center=(0.0, 0.0), height=0.02,
                           roll=STEEP).normal()
        p = np.array([0.0, 0.0, 0.02])
        feet = np.stack([p - 0.002 * n, p + 0.03 * np.array([1, 1, 0])
                         - 0.001 * n, p + 0.01 * n, np.array([0.2, 0.2,
                                                              -0.001])])
        vel = np.zeros((4, 3))
        vel[1] = (0.4, -0.2, 0.1)
        anchors = np.stack([p, feet[1] - 0.02, feet[2], feet[3]])
    near = np.tile(feet, (8, 1)) + 0.004 * rng.standard_normal((32, 3))
    return (np.concatenate([feet, near]),
            np.concatenate([vel, 0.5 * rng.standard_normal((32, 3))]),
            np.concatenate([anchors,
                            near + 0.02 * rng.standard_normal((32, 3))]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(TERRAINS) + ["bound_debris",
                                                     "pace_debris"])
def test_terrain_arrays_match_jax(name, dtype):
    """Terrain.arrays leaf for leaf: flat ground first (half-extents
    1e9), then the stones, cast from float64 as the JAX package casts."""
    jt, tt = TERRAINS.get(name) or (jter.DEBRIS_BY_GAIT[name[:-7].upper()],
                                    ter.DEBRIS_BY_GAIT[name[:-7].upper()])
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    want = jt.arrays(np_dtype)
    got = tt.arrays("cpu", dtype)
    for f in ("p0", "normal", "rot", "half"):
        leaf = getattr(got, f)
        assert leaf.dtype == dtype and leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), getattr(want, f))
    assert got.half[0].tolist() == [1e9, 1e9]


@pytest.mark.parametrize("name", sorted(TERRAINS))
def test_surface_query_and_contact_forces_match_jax(name):
    jt, tt = TERRAINS[name]
    feet, vel, anchors = _contact_inputs(name)
    jarr, tarr = jt.arrays(), tt.arrays("cpu")
    want = jphys.surface_query(jarr, jnp.asarray(feet))
    got = phys.surface_query(tarr, torch.as_tensor(feet))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    # the batch form: leading axes over the feet
    batched = phys.surface_query(tarr,
                                 torch.as_tensor(feet).reshape(-1, 4, 3))
    np.testing.assert_array_equal(batched[2].reshape(-1).numpy(),
                                  got[2].numpy())
    s = jphys.PhysicsSettings()
    jf, ja = jphys._contact_forces(s, jnp.asarray(feet), jnp.asarray(vel),
                                   jnp.asarray(anchors), jnp.float64, jarr)
    tf, ta = phys._contact_forces(phys.PhysicsSettings(),
                                  torch.as_tensor(feet),
                                  torch.as_tensor(vel),
                                  torch.as_tensor(anchors), tarr)
    scale = max(1.0, float(np.abs(jf).max()))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=TOL * scale)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=TOL)
    # the laws: normal force never negative, friction inside the cone
    _, n, _ = got
    fn = (tf * n).sum(-1)
    ft = (tf - n * fn[:, None]).norm(dim=-1)
    assert float(fn.min()) >= 0.0
    assert bool((ft <= s.mu * fn + 1e-9).all())


def test_contact_force_laws():
    """tests/test_physics_sim.py:44-72 on the port: a static foot gets
    kp * depth; a dragged one saturates the cone; an airborne one gets no
    force and re-anchors where it is; a fast-separating one gets 0."""
    s = phys.PhysicsSettings()
    feet, vel, anchors = (torch.as_tensor(a[:4])
                          for a in _contact_inputs("flat"))
    f, new_anchors = phys._contact_forces(s, feet, vel, anchors,
                                          ter.FLAT.arrays("cpu"))
    np.testing.assert_allclose(float(f[0, 2]), s.ground_kp * 0.002)
    assert abs(float(f[0, 0])) < 1e-12
    ft = float(f[1, :2].norm())
    assert 0.9 * s.mu * float(f[1, 2]) < ft <= s.mu * float(f[1, 2]) + 1e-9
    np.testing.assert_allclose(f[2].numpy(), 0.0)
    np.testing.assert_allclose(new_anchors[2].numpy(), feet[2].numpy())
    assert float(f[3, 2]) == 0.0


@pytest.fixture(scope="module")
def port_refs():
    """The standing trot's references through the port's own chain
    (build_problem, swing, kinematic layer, compute_trajectory_data,
    build_references)."""
    prob = presets.build_problem(_standing(presets, gaits),
                                 dtype=torch.float64, device="cpu")
    wb = track_centroidal_solution(
        prob.plan, compute_swing_trajectories(prob.plan, 0.001), prob.X0,
        prob.U0, 0.001)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, prob.X0,
                                   prob.U0)
    return phys.build_references(wb, prob.X0, data.K, prob.plan.schedule)


def test_build_references_matches_jax(closed_loop, port_refs):
    """The port's chain gives the JAX package's references."""
    jrefs, _, _ = closed_loop
    refs = port_refs
    for f in dataclasses.fields(refs):
        got, want = getattr(refs, f.name), np.asarray(getattr(jrefs, f.name))
        assert got.shape == want.shape and got.dtype == torch.float64, f.name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(want).max()),
                                   err_msg=f.name)


def _first_parting(a, b, tol):
    """The first step of each episode where |a - b| passes tol (-1:
    none)."""
    err = np.abs(a - b).reshape(a.shape[0], a.shape[1], -1).max(-1)
    return [int(np.argmax(e > tol)) if (e > tol).any() else -1 for e in err]


@pytest.mark.parametrize("out", ["h", "feet", "rpy"])
def test_simulate_episode_matches_jax(episodes, out):
    jax_out, port_out, *_ = episodes
    i = ("h", "feet", "rpy").index(out)
    want, got = jax_out[i], port_out[i]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    parting = _first_parting(got, want, STEP_TOL * scale)
    np.testing.assert_allclose(
        got[:, :WINDOW], want[:, :WINDOW], rtol=0, atol=STEP_TOL * scale,
        err_msg=f"{out}: first step past {STEP_TOL} of max: {parting}")
    np.testing.assert_allclose(got, want, rtol=0, atol=EPISODE_TOL * scale,
                               err_msg=f"{out}: parting steps {parting}")


@pytest.mark.parametrize("terrain", ["flat", "trot_debris"])
def test_statistics_match_jax(closed_loop, episodes, terrain):
    """foot_slippage, foot_slippage_series, tracking_cost and fell of the
    same simulated episodes (the JAX package's) in both packages."""
    jrefs, refs, x0 = closed_loop
    (jh, jf, jr), _, forces, starts, _ = episodes
    jt, tt = TERRAINS[terrain]
    jres = jphys.PhysicsSimResult(
        h=jnp.asarray(jh), feet=jnp.asarray(jf), base_rpy=jnp.asarray(jr),
        fell=jnp.asarray(jh[:, :, 2].min(1) < 0.5 * x0[2]),
        push_force=jnp.asarray(forces), push_start=jnp.asarray(starts))
    tres = phys.PhysicsSimResult(
        h=torch.as_tensor(jh), feet=torch.as_tensor(jf),
        base_rpy=torch.as_tensor(jr), fell=torch.as_tensor(np.asarray(
            jres.fell)), push_force=torch.as_tensor(forces),
        push_start=torch.as_tensor(starts))
    jarr, tarr = jt.arrays(), tt.arrays("cpu")
    pairs = [
        (phys.foot_slippage(tres, refs, terrain=tarr),
         jphys.foot_slippage(jres, jrefs, terrain=jarr)),
        (phys.foot_slippage_series(tres, refs, terrain=tarr),
         jphys.foot_slippage_series(jres, jrefs, terrain=jarr)),
        (phys.tracking_cost(tres, refs), jphys.tracking_cost(jres, jrefs)),
        (phys.tracking_cost(tres, refs, weights=np.arange(1.0, 10.0)),
         jphys.tracking_cost(jres, jrefs, weights=np.arange(1.0, 10.0)))]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-15)
    assert float(pairs[0][0].sum()) > 0.0      # the episodes do slip


def test_simulate_episode_fell_and_leading_axes(closed_loop):
    """run_physics_monte_carlo's episodes equal simulate_episode on its own
    draws, one episode alone equals its row of the batch, and `fell`
    compares the base height with half of x0's."""
    _, refs, x0 = closed_loop
    refs = dataclasses.replace(refs, **{
        k: getattr(refs, k)[:60] for k in ("q_des", "qd_des", "tau_ff",
                                           "h_des", "K_lqr", "logic")})
    gen = torch.Generator().manual_seed(5)
    res = phys.run_physics_monte_carlo(rb.solo12_spec(), refs,
                                       torch.as_tensor(x0), gen, 3)
    assert res.h.shape == (3, 60, 9) and res.feet.shape == (3, 60, 4, 3)
    assert res.push_start.max() < 1 and res.fell.dtype == torch.bool
    h1, _, _ = phys.simulate_episode(rb.solo12_spec(), refs,
                                     torch.as_tensor(x0), res.push_force[1],
                                     res.push_start[1], 200)
    np.testing.assert_allclose(h1.numpy(), res.h[1].numpy(), rtol=0,
                               atol=1e-12)
    assert not bool(res.fell.any())


def test_drop_settles_to_rest(closed_loop, port_refs):
    """tests/test_physics_sim.py:75-93: a robot dropped from 1 cm above
    its stance settles: |pz| < 0.1 over the last 50 steps, CoM height in
    (0.15, 0.30)."""
    _, _, x0 = closed_loop
    refs = port_refs
    hold = dataclasses.replace(
        refs, q_des=refs.q_des[0].expand(600, -1),
        qd_des=torch.zeros(600, refs.qd_des.shape[1], dtype=torch.float64),
        tau_ff=refs.tau_ff[0].expand(600, -1),
        h_des=refs.h_des[0].expand(600, -1),
        K_lqr=refs.K_lqr[0].expand(600, -1, -1),
        logic=torch.ones(600, 4, dtype=torch.float64))
    x_drop = torch.as_tensor(x0).clone()
    x_drop[2] += 0.01
    h, _, _ = phys.simulate_episode(rb.solo12_spec(), hold, x_drop,
                                    torch.zeros(3, dtype=torch.float64),
                                    torch.tensor(10**9), 1)
    assert float(h[-50:, 5].abs().max()) < 0.1
    assert 0.15 < float(h[-1, 2]) < 0.30


def test_closed_loop_gait_tracks(episodes):
    """tests/test_physics_sim.py:96-104 on the port's unpushed episode."""
    _, (h, _, rpy), *_ = episodes
    assert h[0, :, 2].min() > 0.12
    assert np.abs(h[0, -1, 0:2]).max() < 0.10
    assert np.abs(rpy[0]).max() < 0.5


def test_monte_carlo_pushes_and_stats(closed_loop, port_refs):
    """tests/test_physics_sim.py:107-122 on the port, its pushes from a
    torch.Generator."""
    _, _, x0 = closed_loop
    refs = port_refs
    res = phys.run_physics_monte_carlo(rb.solo12_spec(), refs,
                                       torch.as_tensor(x0),
                                       torch.Generator().manual_seed(3), 4)
    assert res.h.shape[0] == 4
    assert not bool(res.fell.any())
    slip = phys.foot_slippage(res, refs)
    cost = phys.tracking_cost(res, refs)
    assert slip.shape == (4,) and float(slip.min()) >= 0.0
    assert float((cost[:, 1:] - cost[:, :-1]).min()) >= -1e-9
    assert float((res.h[0] - res.h[1]).abs().max()) > 1e-4


def test_swing_references_have_no_holes(port_refs):
    """tests/test_physics_sim.py:125-132 on the port's references."""
    refs = port_refs
    assert float(refs.qd_des.abs().max()) < 50.0
    assert float((refs.q_des[1:] - refs.q_des[:-1]).abs().max()) < 0.05
