"""Uneven terrain in the PyTorch port against the JAX package: stepstone
geometry, the contact plan snapped onto debris (raised footholds, rotated
contact frames) and the block QP's rotated friction pyramids."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import gaits as jgaits
from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.config.robots import SOLO12 as JSOLO12
from centroidal_mpc_tpu.contact import terrain as jter
from centroidal_mpc_tpu_torch.config import gaits as tgaits
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.contact import terrain as tter

from torch_parity_util import assert_tree_close, np_fields, qp_pair, to_np

STEEP = 0.40   # steeper than the pyramid half-angle (tests/test_terrain.py)


def _standing(ter):
    """tests/test_terrain.py's tilted standing terrain: stones under
    solo12's two left feet, rolled about x, in either package's types."""
    stance = JSOLO12.stance_positions_array()
    return ter.Terrain(stones=tuple(
        ter.Stepstone(center=(p[0], p[1]), height=0.02, size=(0.12, 0.12),
                      roll=STEEP) for p in stance if p[1] > 0))


def _standing_gait(gaits):
    return gaits.GaitSpec(gaits.TROT, step_length=0.0, step_height=0.03,
                          step_knots=8, support_knots=4, nb_steps=1)


CASES = {
    # the reference's trot debris, under the full solo12 trot (N=165)
    "trot_debris": lambda pk, ter, gaits: (
        pk.SOLO12_TROT, ter.DEBRIS_BY_GAIT["TROT"]),
    # the tilted standing terrain of tests/test_terrain.py:35
    "standing_tilted": lambda pk, ter, gaits: (
        dataclasses.replace(pk.SOLO12_TROT, gait=_standing_gait(gaits)),
        _standing(ter)),
}


def _pair(case, stochastic=False):
    jpre, jterrain = CASES[case](jpresets, jter, jgaits)
    tpre, tterrain = CASES[case](tpresets, tter, tgaits)
    jp = jpresets.build_problem(jpre, dtype=jnp.float64, terrain=jterrain,
                                stochastic=stochastic)
    tp = tpresets.build_problem(tpre, dtype=torch.float64, terrain=tterrain,
                                stochastic=stochastic, device="cpu")
    return jp, tp


def test_terrain_geometry_matches_jax():
    """Stepstone planes, covers and surface_at (highest cover wins, flat
    ground off the stones) equal the JAX package's on every debris
    layout, at random points over the stones: exact (same numpy)."""
    rng = np.random.default_rng(2)
    pts = rng.uniform([-0.35, -0.25], [0.85, 0.25], size=(400, 2))
    for name in ("TROT", "BOUND", "PACE"):
        jt, tt = jter.DEBRIS_BY_GAIT[name], tter.DEBRIS_BY_GAIT[name]
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        hits = 0
        for x, y in pts:
            (zj, rj), (zt, rt) = jt.surface_at(x, y), tt.surface_at(x, y)
            assert zt == zj
            np.testing.assert_array_equal(rt, rj)
            hits += zt > 0
        assert hits > 0, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_on_terrain_matches_jax(case):
    """The contact plan snapped onto the terrain: positions, orientations
    and logic of the schedule, and each phase's footholds and frames,
    equal the JAX package's exactly; some footholds sit off z=0 with a
    non-identity frame."""
    jp, tp = _pair(case)
    for k, v in np_fields(jp.plan.schedule).items():
        np.testing.assert_array_equal(getattr(tp.plan.schedule, k).numpy(),
                                      v, err_msg=k)
    assert len(tp.plan.phases) == len(jp.plan.phases)
    for tph, jph in zip(tp.plan.phases, jp.plan.phases):
        np.testing.assert_array_equal(tph.positions, jph.positions)
        np.testing.assert_array_equal(tph.rotations, jph.rotations)
        np.testing.assert_array_equal(tph.active, jph.active)
    sched = tp.plan.schedule
    planted = sched.logic > 0
    assert (sched.position[..., 2][planted] > 0).any()
    eye = torch.eye(3, dtype=torch.float64)
    assert ((sched.orientation[planted] - eye).abs().amax((-2, -1))
            > 0.1).any()


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["nominal", "stochastic"])
def test_build_block_qp_on_rotated_frames_matches_jax(stochastic):
    """build_block_qp on the rotated frames of the tilted standing
    terrain (the rotated pyramids G R', and with stochastic=True their
    back-offs) equals the JAX package's on every field at 1e-12."""
    jp, tp = _pair("standing_tilted", stochastic)
    jqp, tqp, _, _ = qp_pair(jp, 2)
    # the rotated rows differ from the flat-ground pyramid
    pyr = tp.ocp.pyramid.clone()
    pyr[4] = 0.0
    flat_G = pyr * tp.plan.schedule.logic[:, :, None, None]
    assert (tqp.G[0] - flat_G).abs().max() > 0.1
    assert_tree_close(to_np(tqp), to_np(jqp), rtol=1e-12, atol=1e-12)
