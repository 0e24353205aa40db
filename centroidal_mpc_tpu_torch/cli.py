"""Command-line entry points of the port.

    python -m centroidal_mpc_tpu_torch.cli run-motion [--preset NAME]
        [--sims N] [--physics-sims N] [--terrain flat|debris] [--out DIR]
        [--nominal-only] [--whole-body kinematic|ddp] [--qp-backend
        block|dense] [--no-preview] [--f64] [--cpu]
    python -m centroidal_mpc_tpu_torch.cli mpc-server [--preset NAME]
        [--ticks N] [--resolves N] [--cpu]

Ports of `centroidal_mpc_tpu/cli.py`: `run_motion_main` (the
`cmpc-run-motion` demo: the motion pipeline, its artifacts, figures and
HTML preview) and `mpc_server_main` (the `cmpc-server` demo: a solver
thread publishes SCP plans over the native trajectory bus while a control
thread samples it at the preset's control rate and steps the centroidal
plant).  Both run on the card unless --cpu is given; without a card and
without --cpu they raise.  matplotlib is imported by run-motion's figures
only, never when this module is imported.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.contact.swing import compute_swing_trajectories
from centroidal_mpc_tpu_torch.contact.terrain import DEBRIS_BY_GAIT
from centroidal_mpc_tpu_torch.models.centroidal import dynamics_step
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.pipeline import PipelineResult, run_pipeline
from centroidal_mpc_tpu_torch.runtime import native
from centroidal_mpc_tpu_torch.sim.preview import write_motion_preview
from centroidal_mpc_tpu_torch.solver.scp import solve_scp
from centroidal_mpc_tpu_torch.utils.artifacts import ArtifactStore


def _device(flag_cpu: bool, command: str) -> str:
    """The card unless --cpu is given; without a card and without --cpu,
    raise."""
    if not flag_cpu and not torch.cuda.is_available():
        raise RuntimeError(f"{command}: no CUDA device; pass --cpu to run "
                           "on the CPU")
    return "cpu" if flag_cpu else "cuda"


def run_motion_main(argv=None) -> PipelineResult:
    """End-to-end motion demo: warm start -> nominal SCP -> stochastic SCP
    -> Monte-Carlo evaluation -> artifacts + plots + HTML motion preview.
    Returns the pipeline's result."""
    ap = argparse.ArgumentParser(prog="run-motion",
                                 description=run_motion_main.__doc__)
    ap.add_argument("--preset", default="solo12_trot")
    ap.add_argument("--sims", type=int, default=16,
                    help="Monte-Carlo rollouts (0 disables)")
    ap.add_argument("--out", default="artifacts/demo")
    ap.add_argument("--nominal-only", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--f64", action="store_true", help="float64")
    ap.add_argument("--whole-body", choices=["kinematic", "ddp"],
                    default="kinematic",
                    help="stage-3 layer: closed-form IK or joint-space DDP "
                         "over the rigid-body contact dynamics")
    ap.add_argument("--physics-sims", type=int, default=0,
                    help="full-physics Monte-Carlo episodes (0 disables)")
    ap.add_argument("--qp-backend", choices=["block", "dense"],
                    default="block",
                    help="block = structure-exploiting production solver; "
                         "dense = reference-layout path (slow at N=165)")
    ap.add_argument("--terrain", choices=["flat", "debris"], default="flat",
                    help="debris = the reference's per-gait stepstone "
                         "terrain (GAIT='..._ON_DEBRI', "
                         "src/simulate_solo.py:217-256): tilted footholds "
                         "in the plan + stones in the physics plant")
    ap.add_argument("--no-preview", action="store_true",
                    help="skip the standalone HTML 3D motion preview")
    args = ap.parse_args(argv)
    device = _device(args.cpu, "run-motion")
    from centroidal_mpc_tpu_torch.sim import plots

    preset = presets.PRESETS[args.preset]
    terrain = (DEBRIS_BY_GAIT[preset.gait.gait_type]
               if args.terrain == "debris" else None)
    store = ArtifactStore(args.out)
    dtype = torch.float64 if args.f64 else torch.float32
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"[pipeline] preset={preset.name} N={preset.horizon} "
          f"device={kind} dtype={str(dtype).removeprefix('torch.')}")
    result = run_pipeline(preset, store, stochastic=not args.nominal_only,
                          n_sims=args.sims, dtype=dtype,
                          whole_body_mode=args.whole_body,
                          physics_sims=args.physics_sims,
                          qp_backend=args.qp_backend, terrain=terrain,
                          device=device)

    nom = result.nominal
    print(f"[nominal]   success={bool(nom.success[0])} "
          f"scp_iters={int(nom.iterations[0])} "
          f"qp_iters={int(nom.qp_iterations[0])} rho={float(nom.rho[0]):.2e}")
    sto = result.stochastic
    if sto is not None:
        print(f"[stochastic] success={bool(sto.success[0])} "
              f"scp_iters={int(sto.iterations[0])} "
              f"qp_iters={int(sto.qp_iterations[0])}")
    stats = result.eval_stats
    if "nominal_violations" in stats:
        print(f"[monte-carlo] sims={args.sims} nominal cone violations/sim="
              f"{np.mean(stats['nominal_violations']):.1f}")
    if result.wb_ddp is not None:
        print(f"[whole-body ddp] cost={float(result.wb_ddp.cost):.3f} "
              f"iters={int(result.wb_ddp.iterations)}")
    if result.mc_physics is not None:
        slip, fell = stats["physics_slippage"], stats["physics_fell"]
        print(f"[physics mc] sims={args.physics_sims} "
              f"fell={int(fell.sum())}/{len(fell)} "
              f"slip mean={float(np.mean(slip)):.3f} m")

    # figures
    plots.plot_contact_forces(preset.robot.foot_names, nom.U[0],
                              None if sto is None else sto.U[0], preset.dt,
                              preset.mu, save_dir=args.out)
    plots.plot_centroidal_trajectory(nom.X[0], result.warm_X, preset.dt,
                                     save_dir=args.out)
    if stats:
        plots.plot_tracking_cost(stats, preset.dt, save_dir=args.out)
    swing = compute_swing_trajectories(result.problem.plan, preset.dt_ctrl)
    plots.plot_swing_trajectories(swing, preset.robot.foot_names,
                                  preset.dt_ctrl, save_dir=args.out)
    if "physics_slippage_series" in stats:
        plots.plot_foot_slippage(
            {"nominal": stats["physics_slippage_series"]}, preset.dt_ctrl,
            save_dir=args.out)
    wb = result.wb_traj
    if wb is not None:
        plots.plot_whole_body_solution(
            wb.q, wb.qdot, wb.tau_ff, preset.dt_ctrl,
            foot_names=preset.robot.foot_names, base_pos=wb.base_pos,
            save_dir=args.out)
    if not args.no_preview:
        path = write_motion_preview(result, preset, args.out)
        print(f"[preview] 3D motion preview: {path}")
    print(f"[artifacts] written to {args.out}/")
    return result


def mpc_server_main(argv=None) -> dict:
    """MPC runtime demo: solver thread + 1 kHz control thread over the
    native trajectory bus (the deployment topology the reference
    approximates with npz files + a free-running Python loop,
    src/simulate_solo.py:281-309).  Returns the run's statistics: solve
    latencies (s) and successes, ticks and wake-up lateness (ns), and the
    tracking errors |x - x_ref| of every tick."""
    ap = argparse.ArgumentParser(prog="mpc-server",
                                 description=mpc_server_main.__doc__)
    ap.add_argument("--preset", default="solo12_trot_n50")
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--resolves", type=int, default=3,
                    help="number of SCP re-solves to publish")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = _device(args.cpu, "mpc-server")

    preset = presets.PRESETS[args.preset]
    # f32 tolerances and fixed rho, as the JAX package's server runs them;
    # the preset's own SCP settings otherwise (the dense backend)
    prob = presets.build_problem(
        preset, dtype=torch.float32, device=device,
        qp=QPSettings(eps_abs=5e-4, eps_rel=5e-4, max_iter=4000,
                      adaptive_rho=False))
    sched = prob.plan.schedule
    N, nx, nu = prob.plan.horizon, prob.X0.shape[-1], preset.robot.n_u
    X0, U0 = prob.X0[None], prob.U0[None]
    cfg = tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0)
    bus = native.TrajectoryBus(N, nx, nu, preset.dt)

    stop = threading.Event()
    solve_times, successes, errors = [], [], []

    def solver_thread():
        try:
            for _ in range(args.resolves):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                sol = solve_scp(prob.model, sched, cfg, X0, U0, prob.scp)
                X, U, K = (a[0].double().cpu().numpy()
                           for a in (sol.X, sol.U, sol.K))
                solve_times.append(time.perf_counter() - t0)
                successes.append(bool(sol.success[0]))
                bus.publish(0.0, X, U, K)
        except Exception as e:  # noqa: BLE001 -- re-raised after join
            errors.append(e)

    st = threading.Thread(target=solver_thread)
    st.start()
    try:
        # control loop: wait for the first plan, then tick at dt_ctrl
        while bus.sample(0.0)[0] < 0 and st.is_alive():
            time.sleep(0.001)
        tick = native.Ticker(period_s=preset.dt_ctrl)
        # the plant integrates at the control rate: the same centroidal
        # model with dt_ctrl, on the solver's device
        model_ctrl = dataclasses.replace(
            prob.model, dt=torch.tensor(preset.dt_ctrl, dtype=torch.float32,
                                        device=device))
        x = prob.X0[0].double().cpu().numpy()
        track_err = []
        n_inner = int(round(preset.dt / preset.dt_ctrl))
        # stay within the plan: beyond N*dt the bus clamps to the final
        # knot (a receding-horizon deployment re-solves and re-publishes)
        n_ticks = min(args.ticks, N * n_inner) if not errors else 0
        for i in range(n_ticks):
            tick.wait()
            _, x_ref, u_ff, k_fb = bus.sample(i * preset.dt_ctrl)
            u = u_ff + k_fb @ (x - x_ref)
            track_err.append(float(np.linalg.norm(x - x_ref)))
            k = min(i // n_inner, N - 1)
            x = dynamics_step(
                model_ctrl,
                torch.as_tensor(x, dtype=torch.float32, device=device),
                torch.as_tensor(u, dtype=torch.float32, device=device),
                sched.position[k], sched.logic[k],
                sched.orientation[k]).double().cpu().numpy()
    finally:
        stop.set()
        st.join()
    if errors:
        raise errors[0]
    stats = tick.stats()
    tick.close()
    bus.close()

    print(f"[solver ] {len(solve_times)} solves ({sum(successes)} "
          f"successful) on {device}, latency min/mean = "
          f"{min(solve_times) * 1e3:.1f}/{np.mean(solve_times) * 1e3:.1f} ms")
    print(f"[control] {stats['ticks']} ticks @ {preset.dt_ctrl * 1e3:.1f} "
          f"ms, wakeup lateness mean/max = "
          f"{stats['mean_late_ns'] / 1e3:.0f}us/"
          f"{stats['max_late_ns'] / 1e3:.0f}us")
    print(f"[tracking] mean |x - x_ref| = {np.mean(track_err):.4f}, "
          f"final = {track_err[-1]:.4f}")
    return dict(device=device, solve_times_s=solve_times,
                successes=successes, ticks=stats["ticks"],
                mean_late_ns=stats["mean_late_ns"],
                max_late_ns=stats["max_late_ns"], track_err=track_err)


COMMANDS = {"run-motion": run_motion_main, "mpc-server": mpc_server_main}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m centroidal_mpc_tpu_torch.cli "
              f"{{{','.join(COMMANDS)}}} [options]", file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
