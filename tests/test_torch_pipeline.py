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
import os

import numpy as np
import pytest
import torch

import torch_parity_util
from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.pipeline import run_pipeline
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
    manifest = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.endswith(".npz"):
            with np.load(path) as f:
                manifest[name] = {k: list(f[k].shape) for k in f.files}
        else:
            manifest[name] = {"rows_cols": list(np.loadtxt(path).shape)}
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
    with pytest.raises(NotImplementedError, match="sim/physics.py"):
        run_pipeline(presets.SOLO12_TROT_N50, physics_sims=4, device="cpu")
    with pytest.raises(ValueError, match="whole_body_mode"):
        run_pipeline(presets.SOLO12_TROT_N50, whole_body_mode="crocoddyl",
                     device="cpu")


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
