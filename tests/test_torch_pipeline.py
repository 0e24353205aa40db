"""The motion pipeline of the PyTorch port (pipeline.run_pipeline) against
the JAX package's float64 run of the same call
(tests/data/jax_pipeline_solo12_trot_n50.npz, written by
scripts/jax_pipeline_reference.py): solo12_trot_n50, stochastic, 64
Monte-Carlo sims, whole_body_mode="ddp", float64 on the CPU.  Each stage
is held to the JAX run at equal iteration counts, and the artifact store
to the JAX run's file names, keys and shapes.

The whole-body DDP stops at its 60-iteration cap in a flat valley: from
its ~45th iteration the cost falls ~1e-12 an accepted step, at the
acceptance threshold (merit < current - 1e-12), so one round-off-sized
difference in the merit decides one more or one fewer accepted step.  Its
cost agrees to ~1e-14; Q, V and TAU are held to 1e-6 of their largest
entry (the JAX run's V reaches 50.6)."""
import json

import numpy as np
import pytest
import torch

import torch_parity_util
from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.pipeline import run_pipeline
from centroidal_mpc_tpu_torch.sim import physics as phys
from centroidal_mpc_tpu_torch.utils import artifacts as art

TOL = 1e-8
DDP_REL = 1e-6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    res = run_pipeline(presets.SOLO12_TROT_N50, art.ArtifactStore(root),
                       stochastic=True, n_sims=64, dtype=torch.float64,
                       whole_body_mode="ddp", device="cpu")
    return res, root, np.load(torch_parity_util.PIPELINE_REF)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=tol)


def test_stage1_warm_start_matches_jax(run):
    res, _, ref = run
    assert res.warm_ddp.iterations == int(ref["warm_iterations"])
    close(res.warm_X, ref["warm_X"])
    close(res.warm_U, ref["warm_U"])
    assert res.warm_X.device.type == "cpu"


@pytest.mark.parametrize("stage,key", [("nominal", "nom"),
                                       ("stochastic", "sto")])
def test_scp_stages_match_jax(run, stage, key):
    res, _, ref = run
    sol = getattr(res, stage)
    assert bool(sol.success[0])
    assert int(sol.iterations[0]) == int(ref[f"{key}_iterations"])
    assert int(sol.qp_iterations[0]) == int(ref[f"{key}_qp_iterations"])
    close(sol.X[0], ref[f"{key}_X"])
    close(sol.U[0], ref[f"{key}_U"])


def test_kinematic_stage3_matches_jax(run):
    res, _, ref = run
    for f in ("q", "qdot", "tau_ff"):
        close(getattr(res.wb_traj, f), ref[f"kin_{f}"], 1e-10)


def test_whole_body_ddp_stage3_matches_jax(run):
    res, _, ref = run
    wb = res.wb_ddp
    assert wb.iterations == int(ref["wb_iterations"])
    np.testing.assert_allclose(float(wb.cost), float(ref["wb_cost"]),
                               rtol=1e-8)
    for f in ("Q", "V", "TAU"):
        want = ref[f"wb_{f}"]
        close(getattr(wb, f), want, DDP_REL * np.abs(want).max())
    assert wb.Q.dtype == torch.float64


def test_artifacts_match_the_jax_run(run):
    """The same files, and in each the same keys and shapes."""
    res, root, ref = run
    manifest = art.ArtifactStore(root).manifest()
    assert manifest == json.loads(str(ref["manifest"]))
    store = art.ArtifactStore(root)
    np.testing.assert_array_equal(store.load(art.WHOLEBODY_TO_CENTROIDAL)["X"],
                                  res.warm_X.numpy())
    np.testing.assert_array_equal(store.load(art.CENTROIDAL_TO_WHOLEBODY)["U"],
                                  res.nominal.U[0].numpy())


def test_monte_carlo_stage(run):
    res, _, _ = run
    stats = res.eval_stats
    assert set(stats) == {f"{p}_{s}" for p in ("nominal", "stochastic")
                          for s in ("cum_cost", "cum_cost_std",
                                    "violations")}
    assert stats["nominal_cum_cost"].shape == (51,)
    assert stats["stochastic_violations"].shape == (64,)
    assert all(np.isfinite(v).all() for v in stats.values())
    assert res.mc_nominal.X_sim.shape == (64, 51, 9)
    # both studies draw the same pushes from the same seed
    assert torch.equal(res.mc_nominal.push_force,
                       res.mc_stochastic.push_force)


def test_unported_and_unknown_options_raise():
    """No option is left unported (physics_sims > 0 runs, see
    test_physics_stage_4b); unknown mode names raise."""
    with pytest.raises(ValueError, match="whole_body_mode"):
        run_pipeline(presets.SOLO12_TROT_N50, whole_body_mode="crocoddyl",
                     device="cpu")
    with pytest.raises(ValueError, match="qp_backend"):
        run_pipeline(presets.SOLO12_TROT_MINI, qp_backend="sparse",
                     stochastic=False, device="cpu")


@pytest.fixture(scope="module")
def physics_run(tmp_path_factory):
    """The mini preset with stage 4b (2 episodes), f32 as the CLI runs it,
    into a store."""
    root = tmp_path_factory.mktemp("physics")
    res = run_pipeline(presets.SOLO12_TROT_MINI, art.ArtifactStore(root),
                       stochastic=False, n_sims=2, physics_sims=2,
                       device="cpu")
    return res, root


def test_physics_stage_4b(physics_run):
    """The JAX package's stage-4b keys and shapes (its run-motion on the
    mini preset wrote physics_monte_carlo_stats with these shapes), the
    plant's result and references on the result, finite statistics, and
    the cumulative cost non-decreasing."""
    res, root = physics_run
    mc, refs = res.mc_physics, res.physics_refs
    t = refs.q_des.shape[0]
    assert t == 180 and mc.h.shape == (2, t, 9)
    assert mc.feet.shape == (2, t, 4, 3) and mc.base_rpy.shape == (2, t, 3)
    assert mc.h.dtype == torch.float32 and refs.K_lqr.shape == (t, 12, 9)
    stats = res.eval_stats
    shapes = {k: v.shape for k, v in stats.items() if k.startswith("phys")}
    assert shapes == {"physics_slippage": (2,), "physics_cum_cost": (2,),
                      "physics_slippage_series": (2, t - 1),
                      "physics_fell": (2,)}
    assert stats["physics_fell"].dtype == bool
    assert all(np.isfinite(v).all() for v in stats.values())
    assert (stats["physics_slippage"] >= 0).all()
    series = stats["physics_slippage_series"]
    np.testing.assert_allclose(series[:, -1], stats["physics_slippage"],
                               rtol=1e-5)
    cost = phys.tracking_cost(mc, refs)
    assert bool((cost[:, 1:] >= cost[:, :-1]).all())
    np.testing.assert_array_equal(cost[:, -1].numpy(),
                                  stats["physics_cum_cost"])
    want = json.loads(str(np.load(torch_parity_util.PHYSICS_REF)[
        "manifest_mini_flat"]))["physics_monte_carlo_stats.npz"]
    manifest = art.ArtifactStore(root).manifest()
    assert manifest["physics_monte_carlo_stats.npz"] == want
    # the pushes come from torch.Generator(device).manual_seed(seed + 1)
    gen = torch.Generator().manual_seed(1)
    forces = 15.0 ** 0.5 * torch.randn((2, 3), generator=gen)
    torch.testing.assert_close(mc.push_force, forces, rtol=0, atol=0)


def test_stage3_runs_for_the_plant_without_a_store():
    """JAX runs stage 3 when there is a store OR physics episodes
    (centroidal_mpc_tpu/pipeline.py:133): with neither it is skipped,
    with physics_sims > 0 and no store the kinematic layer and the plant
    run and nothing is written."""
    res = run_pipeline(presets.SOLO12_TROT_MINI, stochastic=False,
                       physics_sims=1, device="cpu")
    assert res.wb_traj is not None and res.mc_physics.h.shape[0] == 1
    assert res.wb_ddp is None
    res = run_pipeline(presets.SOLO12_TROT_MINI, stochastic=False,
                       device="cpu")
    assert res.wb_traj is None and res.mc_physics is None
    assert res.physics_refs is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(presets.SOLO12_TROT_N50)


def test_f32_defaults_converge(tmp_path):
    """tests/test_pipeline.py:40-51 on the port: an f32 pipeline takes the
    f32-reachable QP settings (eps 1e-4, 'always' rho, polish) and its
    nominal solve converges."""
    store = art.ArtifactStore(tmp_path)
    res = run_pipeline(presets.SOLO12_TROT_N50, store, stochastic=False,
                       n_sims=0, dtype=torch.float32, device="cpu")
    assert bool(res.nominal.success[0]) and bool(res.nominal.qp_converged[0])
    assert int(res.nominal.qp_iterations[0]) < 2000
    assert res.wb_traj.q.dtype == torch.float32 and res.wb_ddp is None
    assert store.load(art.SCP_INTERPOLATED_NOMINAL)["X"].shape == (500, 9)
    assert store.exists(art.WHOLEBODY_INTERPOLATED)
    assert not store.exists(art.SCP_INTERPOLATED_STOCHASTIC)
