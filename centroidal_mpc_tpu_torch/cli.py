"""Command-line entry points of the port.

    python -m centroidal_mpc_tpu_torch.cli mpc-server [--preset NAME]
        [--ticks N] [--resolves N] [--cpu]

Port of `mpc_server_main` from `centroidal_mpc_tpu/cli.py` (the
`cmpc-server` demo): a solver thread publishes SCP plans over the native
trajectory bus while a control thread samples it at the preset's control
rate and steps the centroidal plant.  The solve runs on the card unless
--cpu is given; without a card and without --cpu it raises.
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
from centroidal_mpc_tpu_torch.models.centroidal import dynamics_step
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.runtime import native
from centroidal_mpc_tpu_torch.solver.scp import solve_scp


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
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mpc-server: no CUDA device; pass --cpu to run "
                           "on the CPU")

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


COMMANDS = {"mpc-server": mpc_server_main}


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
