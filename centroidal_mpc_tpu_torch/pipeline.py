"""End-to-end motion pipeline: the reference demo driver, as a library.

Port of `centroidal_mpc_tpu/pipeline.py` (reference
build/lib/demos/run_motion.py:16-143 and the demo notebooks): iLQR warm
start -> nominal centroidal SCP -> whole-body tracking -> stochastic SCP
-> Monte-Carlo evaluation, with npz artifacts between the stages under
the reference's file names (utils/artifacts.py), so that every stage can
be re-run alone.  Everything runs on one device: the card unless the
caller passes device="cpu".

The full-physics Monte-Carlo (the JAX package's sim/physics.py, stage 4b)
is not ported yet: `physics_sims > 0` raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config import presets as _presets
from centroidal_mpc_tpu_torch.config.presets import Problem, ProblemPreset
from centroidal_mpc_tpu_torch.contact.swing import compute_swing_trajectories
from centroidal_mpc_tpu_torch.models import rigid_body as rb
from centroidal_mpc_tpu_torch.models import whole_body
from centroidal_mpc_tpu_torch.models import whole_body_ddp as wbd
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.sim import metrics, monte_carlo
from centroidal_mpc_tpu_torch.solver.ddp import DdpSettings, DdpSolution
from centroidal_mpc_tpu_torch.solver.scp import ScpSolution, solve_scp
from centroidal_mpc_tpu_torch.solver.warm_start import (
    ddp_warm_start_solution)
from centroidal_mpc_tpu_torch.utils import artifacts as art
from centroidal_mpc_tpu_torch.utils.interpolation import (
    interpolate_scp_solution)


@dataclasses.dataclass
class PipelineResult:
    """The stages' results.  The SCP solutions keep the port's batch axis
    (B = 1); warm_X / warm_U are tensors on the pipeline's device and
    eval_stats numpy arrays."""

    problem: Problem
    warm_X: torch.Tensor
    warm_U: torch.Tensor
    nominal: ScpSolution
    stochastic: Optional[ScpSolution]
    mc_nominal: Optional[monte_carlo.MonteCarloResult]
    mc_stochastic: Optional[monte_carlo.MonteCarloResult]
    eval_stats: Dict[str, np.ndarray]
    wb_ddp: Optional[wbd.WholeBodySolution] = None
    mc_physics: Optional[object] = None      # not ported: always None
    wb_traj: Optional[whole_body.WholeBodyTrajectory] = None
    physics_refs: Optional[object] = None    # not ported: always None
    terrain: Optional[object] = None         # contact/terrain.Terrain
    warm_ddp: Optional[DdpSolution] = None   # stage 1's iLQR solve


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _solve(prob: Problem, scp) -> ScpSolution:
    """One scenario (B = 1) of prob through the batch-first solve_scp."""
    X0, U0 = prob.X0[None], prob.U0[None]
    cfg = tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0)
    return solve_scp(prob.model, prob.plan.schedule, cfg, X0, U0, scp)


def run_pipeline(preset: ProblemPreset,
                 store: Optional[art.ArtifactStore] = None,
                 stochastic: bool = True, n_sims: int = 0,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 ddp_settings: Optional[DdpSettings] = None,
                 whole_body_mode: str = "kinematic",
                 physics_sims: int = 0,
                 qp_backend: str = "block",
                 stochastic_lqr_iters: int = 30,
                 terrain=None, device="cuda") -> PipelineResult:
    """Run the whole pipeline for one preset on `device`.

    Stage 1 (warm start): centroidal iLQR tracking the contact-centroid
      path (the reference's stage-1 whole-body DDP role,
      run_motion.py:16-30), saved as wholeBody_to_centroidal_traj.
    Stage 2 (nominal SCP): solve + 10x interpolation, saved as
      scp_sol_interpol_nom / centroidal_to_wholeBody_traj
      (run_motion.py:38-43).
    Stage 3 (whole body, with a store): for point-foot robots the
      kinematic layer (models/whole_body.py, its .dat exports); with
      whole_body_mode="ddp", and always for wrench6 robots (talos), the
      joint-space iLQR over the contact-KKT dynamics
      (models/whole_body_ddp.py, the reference's TRACK_CENTROIDAL=True
      stage, run_motion.py:49-72); saved as wholeBody_interpolated_traj.
    Stage 2' (stochastic SCP): the chance-constrained resolve
      (run_motion.py:106-112) with stochastic_lqr_iters DARE steps.
    Stage 4 (Monte-Carlo, n_sims > 0): disturbance rollouts with LQR
      feedback for both solutions and their statistics; the draws come
      from torch.Generator(device).manual_seed(seed).

    terrain (contact/terrain.Terrain) snaps the footholds onto its
    stepstones.  Without a card the default device raises; pass
    device="cpu" to run on the CPU."""
    if physics_sims > 0:
        raise NotImplementedError(
            "run_pipeline: the full-physics Monte-Carlo (the JAX package's "
            "sim/physics.py) is not ported; pass physics_sims=0")
    if whole_body_mode not in ("kinematic", "ddp"):
        raise ValueError(f"unknown whole_body_mode {whole_body_mode!r}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_pipeline: no CUDA device; pass device='cpu' "
                           "to run on the CPU")

    # f32 cannot reach the preset default (eps 1e-7, the reference's OSQP
    # operating point): its scaled residuals floor out near 1e-4 and the
    # QP spins to max_iter.  f32 takes eps 1e-4 with 'always' adaptive
    # rho and the polish instead, as the JAX package does.
    build_kwargs = {"dtype": dtype, "terrain": terrain, "device": device}
    if dtype == torch.float32:
        build_kwargs["qp"] = QPSettings(
            eps_abs=1e-4, eps_rel=1e-4, max_iter=4000, adaptive_rho=True,
            adaptive_rho_mode="always", polish=True)

    def build_problem(**kw) -> Problem:
        prob = _presets.build_problem(preset, **build_kwargs, **kw)
        return dataclasses.replace(prob, scp=dataclasses.replace(
            prob.scp, qp_backend=qp_backend))

    # ---- stage 1: warm start
    prob0 = build_problem()
    warm = ddp_warm_start_solution(prob0.model, prob0.plan.schedule,
                                   preset.robot,
                                   settings=ddp_settings or DdpSettings())
    X_warm, U_warm = warm.X, warm.U
    if store is not None:
        store.save(art.WHOLEBODY_TO_CENTROIDAL, X=X_warm)

    # ---- stage 2: nominal SCP
    prob = build_problem(X_warm=X_warm, U_warm=U_warm)
    nominal = _solve(prob, prob.scp)
    X_nom, U_nom = nominal.X[0], nominal.U[0]
    if store is not None:
        store.save(art.SCP_INTERPOLATED_NOMINAL,
                   **interpolate_scp_solution(X_nom, U_nom))
        store.save(art.CENTROIDAL_TO_WHOLEBODY, X=X_nom, U=U_nom)

    # ---- stage 3: whole-body tracking (the joint-space deliverable)
    wb_traj = wb_sol = None
    point3 = preset.robot.contact_model == "point3"
    if store is not None:
        spec = rb.robot_spec(preset.robot.name)
        swing = compute_swing_trajectories(prob.plan, preset.dt_ctrl)
        if point3:
            wb_traj = whole_body.track_centroidal_solution(
                prob.plan, swing, X_nom, U_nom, preset.dt_ctrl,
                geom=wbd.leg_geometry_from_spec(spec))
        if whole_body_mode == "ddp" or not point3:
            # wrench6 robots (talos) have no closed-form kinematic layer;
            # the joint-space DDP is their stage 3
            targets = wbd.build_targets(prob.plan, swing, preset.dt_ctrl,
                                        X_centroidal=X_nom,
                                        U_centroidal=U_nom, dtype=dtype)
            wb_sol = wbd.solve_whole_body_ddp(spec, targets, preset.dt)
            store.save(art.WHOLEBODY_INTERPOLATED,
                       X=wb_sol.centroidal_states(), U=U_nom,
                       **wbd.interpolate_whole_body_solution(
                           wb_sol, preset.dt, preset.dt_ctrl))
        else:
            store.save(art.WHOLEBODY_INTERPOLATED, X=X_nom, U=U_nom,
                       q=wb_traj.q, qdot=wb_traj.qdot, tau=wb_traj.tau_ff,
                       gains=np.asarray([float(wb_traj.kp),
                                         float(wb_traj.kd)]))
        if wb_traj is not None:
            whole_body.export_robot_dat(wb_traj, store.root)

    # ---- stage 2': stochastic SCP
    # 30 DARE steps by default: the reference's 2-step gains do not
    # stabilize the closed loop at the full trot horizon, the covariance
    # grows and the chance-constrained QP is infeasible.  A failed solve
    # is reported and its downstream stages are skipped.
    stoch_sol = None
    if stochastic:
        prob_s = build_problem(stochastic=True, X_warm=X_warm, U_warm=U_warm)
        stoch_sol = _solve(prob_s, dataclasses.replace(
            prob_s.scp, lqr_iters=stochastic_lqr_iters))
        if not bool(stoch_sol.success[0]):
            print("[pipeline] WARNING: stochastic SCP did not converge "
                  f"(qp_converged={bool(stoch_sol.qp_converged[0])}); "
                  "skipping stochastic artifacts/evaluation")
        elif store is not None:
            store.save(art.SCP_INTERPOLATED_STOCHASTIC,
                       **interpolate_scp_solution(stoch_sol.X[0],
                                                  stoch_sol.U[0]))

    # ---- stage 4: Monte-Carlo evaluation
    mc_nom = mc_sto = None
    stats: Dict[str, np.ndarray] = {}
    if n_sims > 0:
        def evaluate(sol: ScpSolution, prefix: str):
            gen = torch.Generator(device).manual_seed(seed)
            mc = monte_carlo.run_monte_carlo(
                prob.model, prob.plan.schedule, sol.X[0], sol.U[0],
                sol.K[0], gen, n_sims)
            tc = metrics.cumulative_tracking_cost(prob.model.Q, mc.X_sim,
                                                  sol.X[0])
            fr = metrics.friction_cone_stats(prob.ocp.pyramid,
                                             prob.plan.schedule, mc.U_sim)
            stats[f"{prefix}_cum_cost"] = _np(tc["cum_mean"])
            stats[f"{prefix}_cum_cost_std"] = _np(tc["cum_std"])
            stats[f"{prefix}_violations"] = _np(fr["violations"])
            return mc

        mc_nom = evaluate(nominal, "nominal")
        if stoch_sol is not None and bool(stoch_sol.success[0]):
            mc_sto = evaluate(stoch_sol, "stochastic")
        if store is not None:
            store.save("monte_carlo_stats", **stats)

    return PipelineResult(problem=prob, warm_X=X_warm, warm_U=U_warm,
                          nominal=nominal, stochastic=stoch_sol,
                          mc_nominal=mc_nom, mc_stochastic=mc_sto,
                          eval_stats=stats, wb_ddp=wb_sol, wb_traj=wb_traj,
                          terrain=terrain, warm_ddp=warm)
