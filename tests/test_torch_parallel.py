"""Mesh-sharded and multi-process fleet solving of the PyTorch port
(`parallel/batch.scenario_mesh`, `make_sharded_solver`,
`parallel/multihost`) on gloo process groups on the CPU, against the JAX
package's `make_sharded_solver` on the virtual 8-device CPU mesh and
against the port's own unsharded `batched_solve`.

The ranks are subprocesses (tests/_torch_multihost_worker.py, which
imports no JAX); every one is killed and the test fails when they have
not finished within their timeout, and every group has a timeout of its
own (`multihost.GROUP_TIMEOUT`).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.parallel.batch import \
    make_sharded_solver as jmake_sharded_solver
from centroidal_mpc_tpu.parallel.batch import scenario_mesh as jscenario_mesh
from centroidal_mpc_tpu.parallel.batch import tile_ocp_config as jtile
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel import multihost
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     make_sharded_solver,
                                                     scenario_mesh,
                                                     tile_ocp_config)

from torch_parity_util import (BENCH_QP, perturbed_batch, port_problem,
                               qp_settings_pair)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
RANK_TIMEOUT_S = 240
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, world, problem, *flags, launcher_env=False):
    """Run `world` worker ranks on a gloo group on the CPU over the global
    batch in `problem`; each rank's RESULT dict, its lanes (the npz) under
    "lanes".  launcher_env: the ranks join through the variables torchrun
    sets instead of an explicit coordinator."""
    path = tmp_path / "problem.pt"
    torch.save(problem, path)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["OMP_NUM_THREADS"] = "1"

    def rank_env(r):
        if not launcher_env:
            return env
        return dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                    WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))

    coordinator = "env" if launcher_env else f"localhost:{port}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coordinator, str(world), str(r), str(path),
         str(tmp_path / f"rank{r}.npz"), "--device", "cpu", *flags],
        cwd=ROOT, env=rank_env(r), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line from rank {r}:\n{out}"
        res = json.loads(lines[-1][len("RESULT "):])
        assert res["rank"] == r and res["world"] == world
        with np.load(tmp_path / f"rank{r}.npz") as lanes:
            res["lanes"] = dict(lanes)
        results.append(res)
    return results


def _batch(prob_X0, prob_U0, ocp, batch, dtype):
    Xb, Ub = perturbed_batch(np.asarray(prob_X0), np.asarray(prob_U0),
                             batch, seed=0)
    X = torch.as_tensor(Xb, dtype=dtype)
    U = torch.as_tensor(Ub, dtype=dtype)
    return tile_ocp_config(ocp, X[:, 0], X[:, -1], X), X, U


def test_four_gloo_ranks_match_jax_sharded_solver(tmp_path):
    """(a) solo12_trot_mini, f64, B=8 at the bench point on the block
    backend: JAX's make_sharded_solver on the 8-device virtual mesh (one
    scenario a device) against the port on 4 gloo ranks (2 rows a rank,
    shard_global_batch): equal reduced stats, equal SCP and QP iteration
    counts lane by lane, X/U within 1e-8."""
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    jqp, _ = qp_settings_pair(**BENCH_QP)
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   dtype=jnp.float64, qp=jqp)
    jscp = dataclasses.replace(jprob.scp, qp_backend="block",
                               norm_method="power")
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, 8, seed=0)
    jsolver = jmake_sharded_solver(jscenario_mesh(8), jprob.model,
                                   jprob.plan.schedule, jscp)
    jsol, jstats = jsolver(jtile(jprob.ocp, Xb[:, 0], Xb[:, -1], Xb), Xb,
                           Ub)

    model, schedule, ocp, scp, X0, U0 = port_problem(jprob)
    scp = dataclasses.replace(scp, qp_backend="block", norm_method="power")
    cfg, X, U = _batch(jprob.X0, jprob.U0, ocp, 8, torch.float64)
    ranks = run_ranks(tmp_path, 4, dict(model=model, schedule=schedule,
                                        settings=scp, cfg=cfg, X0=X, U0=U),
                      "--mode", "global")

    for r in ranks:
        assert r["n_success"] == int(jstats["n_success"]) == 8
        assert r["qp_iterations"] == int(jstats["qp_iterations"])
        assert r["max_rho"] == pytest.approx(float(jstats["max_rho"]),
                                             rel=1e-8)
        assert r["global_shape"] == [8, jprob.plan.horizon + 1, 9]
        assert r["local_shape"][0] == 2
    lanes = {k: np.concatenate([r["lanes"][k] for r in ranks])
             for k in ranks[0]["lanes"]}
    for k in ("success", "iterations", "qp_iterations"):
        np.testing.assert_array_equal(lanes[k], np.asarray(getattr(jsol, k)),
                                      err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_allclose(lanes[k], np.asarray(getattr(jsol, k)),
                                   rtol=1e-8, atol=1e-8, err_msg=k)


# the JAX multi-process worker's bench shape (tests/_multihost_worker.py)
BENCH_SHAPE_QP = QPSettings(eps_abs=1e-3, eps_rel=1e-3, max_iter=400,
                            adaptive_rho=False)


@pytest.fixture(scope="module")
def bench_shape_run(tmp_path_factory):
    """2 ranks x 4 rows of solo12_trot_n50 in f32 through
    shard_local_rows (2 SCP iterations, power norm, block backend), the
    group joined from torchrun's variables, with a scaling report and the
    refusal checks; and the port's unsharded batched_solve of the same 8
    rows in this process."""
    prob = tpresets.build_problem(tpresets.SOLO12_TROT_N50,
                                  dtype=torch.float32, qp=BENCH_SHAPE_QP,
                                  device="cpu")
    scp = dataclasses.replace(prob.scp, max_iterations=2,
                              norm_method="power", qp_backend="block")
    cfg, X, U = _batch(prob.X0, prob.U0, prob.ocp, 8, torch.float32)
    ranks = run_ranks(tmp_path_factory.mktemp("bench_shape"), 2,
                      dict(model=prob.model, schedule=prob.plan.schedule,
                           settings=scp, cfg=cfg, X0=X, U0=U),
                      "--mode", "local", "--repeats", "1", "--refusals",
                      launcher_env=True)
    ref = batched_solve(prob.model, prob.plan.schedule, cfg, X, U, scp)
    return ranks, ref


def test_two_ranks_bench_shape_match_unsharded_solve(bench_shape_run):
    """(b) Equal reduced stats on both ranks, a DTensor of global shape
    (8, 51, 9) with 4 rows a rank, a scaling report of 2 processes, and
    n_success and U within the 1e-4 parity bar of the unsharded solve."""
    ranks, ref = bench_shape_run
    stats = [(r["n_success"], r["qp_iterations"], r["max_rho"])
             for r in ranks]
    assert stats[0] == stats[1]
    assert ranks[0]["n_success"] == int(ref.success.sum())
    assert ranks[0]["qp_iterations"] > 0
    for r in ranks:
        assert r["global_shape"] == [8, 51, 9]
        assert r["local_shape"] == [4, 51, 9]
        assert r["device"] == "cpu"
        assert r["report"]["processes"] == r["report"]["devices"] == 2
        assert r["report"]["batch"] == 8 and r["report"]["solves_per_s"] > 0
    lanes = {k: np.concatenate([r["lanes"][k] for r in ranks])
             for k in ("success", "U")}
    np.testing.assert_array_equal(lanes["success"], ref.success.numpy())
    np.testing.assert_allclose(lanes["U"], ref.U.numpy(), rtol=0, atol=1e-4)


def test_two_ranks_refuse_bad_batches(bench_shape_run):
    """(d) On both ranks: a global batch that does not divide the mesh,
    ranks that bring unequal rows to shard_local_rows, and a mesh larger
    than the group each raise ValueError."""
    ranks, _ = bench_shape_run
    for r in ranks:
        assert r["refusals"] == ["uneven_batch", "unequal_rows",
                                 "mesh_too_large"]


def test_scenario_mesh_needs_a_process_group():
    """(d) Without a process group scenario_mesh raises ValueError and
    points at multihost.initialize()."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"initialize\(\)"):
        scenario_mesh(device="cpu")


def test_initialize_alone_runs_local(monkeypatch):
    """(c) initialize() outside any launcher makes a gloo group of this
    process alone (a second call is a no-op); fleet_solver over it gives
    exactly batched_solve's solution and its stats.  (d) On it a mesh of
    two ranks and inputs that are not DTensors are refused."""
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    prob = tpresets.build_problem(tpresets.SOLO12_TROT_MINI,
                                  dtype=torch.float64, device="cpu")
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    cfg, X, U = _batch(prob.X0, prob.U0, prob.ocp, 2, torch.float64)
    multihost.initialize(device="cpu")
    try:
        group = dist.group.WORLD
        multihost.initialize(device="cpu")
        assert dist.group.WORLD is group
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        solver, mesh = multihost.fleet_solver(prob.model, prob.plan.schedule,
                                              scp)
        assert mesh.size() == 1 and mesh.device_type == "cpu"
        assert mesh.mesh_dim_names == (multihost.AXIS,)
        sol, stats = solver(*multihost.shard_global_batch(mesh,
                                                          (cfg, X, U)))
        ref = batched_solve(prob.model, prob.plan.schedule, cfg, X, U, scp)
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(sol, f.name).to_local(),
                               getattr(ref, f.name)), f.name
        assert int(stats["n_success"]) == int(ref.success.sum()) == 2
        assert int(stats["qp_iterations"]) == int(ref.qp_iterations.sum())
        assert float(stats["max_rho"]) == float(ref.rho.max())

        with pytest.raises(ValueError, match="2 devices"):
            scenario_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="DTensor"):
            make_sharded_solver(mesh, prob.model, prob.plan.schedule,
                                scp)(cfg, X, U)
    finally:
        dist.destroy_process_group()
