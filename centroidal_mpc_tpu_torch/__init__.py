"""centroidal_mpc_tpu_torch: the PyTorch + CUDA port of centroidal_mpc_tpu.

Batch-first PyTorch counterparts of the JAX package's modules (same
layout and names: config/, contact/, models/, ops/, solver/, parallel/,
sim/),
with hand-written CUDA kernels for Hopper (csrc/) in place of the JAX
package's Pallas TPU kernels.  The package never imports jax.

Quick start, the README's problem on the preset's own settings (the
dense reference-layout backend, 'cond' adaptive rho, eps 1e-7), one
scenario (B=1)::

    import torch
    from centroidal_mpc_tpu_torch import presets, solve_scp
    from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config

    prob = presets.build_problem(presets.SOLO12_TROT, dtype=torch.float64)
    X0, U0 = prob.X0[None], prob.U0[None]
    cfg = tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0)
    sol = solve_scp(prob.model, prob.plan.schedule, cfg, X0, U0, prob.scp)

A batch of B scenarios on the block backend (chip_smoke.py drives the
same path at the bench operating point)::

    import dataclasses, torch
    from centroidal_mpc_tpu_torch.config import presets
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                         tile_ocp_config)

    prob = presets.build_problem(
        presets.SOLO12_TROT_N50, dtype=torch.float32, device="cuda",
        qp=QPSettings(eps_abs=5e-4, eps_rel=5e-4, adaptive_rho=False,
                      polish=True, max_iter=4000))
    X0 = prob.X0.expand(8, -1, -1)
    U0 = prob.U0.expand(8, -1, -1)
    cfg = tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0)
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    sol = batched_solve(prob.model, prob.plan.schedule, cfg, X0, U0, scp)

The other modes of the block path take the same calls:
``build_problem(..., stochastic=True)`` (chance constraints; the
pipeline's stage runs ``dataclasses.replace(scp, lqr_iters=30)``),
``build_problem(..., terrain=contact.terrain.DEBRIS_BY_GAIT["TROT"])``
(footholds on tilted stones), ``QPSettings(adaptive_rho=True,
adaptive_rho_mode="cond")``, and ``update_linearization=True`` in the
ScpSettings (the talos preset's default).

Receding-horizon MPC (`solver/mpc.MpcController`, B=1 for one robot)
and the Monte-Carlo push study (`sim/monte_carlo.run_monte_carlo`, with
`sim/metrics`) take the same problem::

    from centroidal_mpc_tpu_torch.sim.monte_carlo import run_monte_carlo
    from centroidal_mpc_tpu_torch.solver.mpc import MpcController

    cfg1 = dataclasses.replace(
        tile_ocp_config(prob.ocp, X0[:1, 0], X0[:1, -1], X0[:1]),
        terminal_equality=False)
    ctrl = MpcController(model=prob.model, schedule=prob.plan.schedule,
                         cfg=cfg1, settings=dataclasses.replace(
                             scp, max_iterations=1), window=20)
    state = ctrl.init_state(X0[:1], U0[:1])
    state, tick_sol = ctrl.step(state, X0[:1, 0])   # one tick
    res = run_monte_carlo(prob.model, prob.plan.schedule, sol.X[0],
                          sol.U[0], sol.K[0], torch.Generator().manual_seed(0),
                          n_sims=1024)

The motion pipeline (iLQR warm start, nominal SCP, whole-body tracking,
stochastic SCP, Monte-Carlo; the JAX package's `pipeline.run_pipeline`)
runs on the card, with the npz artifacts under the reference's names::

    from centroidal_mpc_tpu_torch import run_pipeline
    from centroidal_mpc_tpu_torch.utils.artifacts import ArtifactStore

    res = run_pipeline(presets.SOLO12_TROT_N50, ArtifactStore("out"),
                       stochastic=True, n_sims=1024)      # f32, kinematic
    res = run_pipeline(presets.SOLO12_TROT_N50, ArtifactStore("out64"),
                       dtype=torch.float64, whole_body_mode="ddp")
    res.nominal.X[0], res.wb_traj.q, res.wb_ddp.TAU, res.eval_stats

`device="cpu"` runs it on the CPU; the full-physics Monte-Carlo
(`physics_sims > 0`) is not ported and raises.
"""

from centroidal_mpc_tpu_torch.config import gaits, presets, robots
from centroidal_mpc_tpu_torch.contact.plan import (ContactPlan,
                                                   ContactSchedule,
                                                   build_contact_plan)
from centroidal_mpc_tpu_torch.models.centroidal import (
    CentroidalModel, TrajectoryData, compute_trajectory_data, dynamics_step,
    rollout)
from centroidal_mpc_tpu_torch.ops.admm import (QPSettings, QPSolution,
                                               solve_qp)
from centroidal_mpc_tpu_torch.pipeline import PipelineResult, run_pipeline
from centroidal_mpc_tpu_torch.solver.ocp import OcpConfig, QPData, build_qp
from centroidal_mpc_tpu_torch.solver.scp import (ScpSettings, ScpSolution,
                                                 solve_scp)

__version__ = "0.1.0"

__all__ = [
    "CentroidalModel", "ContactPlan", "ContactSchedule", "OcpConfig",
    "PipelineResult", "QPData", "QPSettings", "QPSolution", "ScpSettings",
    "ScpSolution",
    "TrajectoryData", "build_contact_plan", "build_qp",
    "compute_trajectory_data", "dynamics_step", "gaits", "presets",
    "robots", "rollout", "run_pipeline", "solve_qp", "solve_scp",
]
