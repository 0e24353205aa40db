"""Write the JAX package's float64 motion pipeline on solo12_trot_n50 and
its 1-step trot whole-body DDP to
tests/data/jax_pipeline_solo12_trot_n50.npz:

    warm_X, warm_U, warm_iterations   stage 1 (ddp_warm_start; the iLQR
                                      iteration count from the same solve)
    nom_X, nom_U, nom_iterations, nom_qp_iterations          stage 2
    sto_X, sto_U, sto_iterations, sto_qp_iterations          stage 2'
    kin_q, kin_qdot, kin_tau_ff       stage 3, kinematic (1 kHz)
    wb_Q, wb_V, wb_TAU, wb_cost, wb_iterations   stage 3, whole-body DDP
    trot1_Q, trot1_V, trot1_TAU, trot1_cost, trot1_iterations
                                      solve_whole_body_ddp on the 1-step
                                      trot of tests/test_whole_body_ddp.py
                                      (stage-1 targets, default settings)
    manifest                          JSON: every artifact file the run
                                      wrote, its keys and their shapes

The pipeline is run_pipeline(SOLO12_TROT_N50, store, stochastic=True,
n_sims=64, dtype=float64, whole_body_mode="ddp").  The port's
tests/test_torch_pipeline.py and chip_smoke.py's `# pipeline/f64` phase
hold the port to this file.  It imports only the JAX package:

    python scripts/jax_pipeline_reference.py

It took 261 s on an 8-core x86 CPU (most of it XLA's compiles of the two
exact-Quu whole-body DDP programs).
"""
import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from centroidal_mpc_tpu.config import gaits, presets  # noqa: E402
from centroidal_mpc_tpu.config.robots import SOLO12  # noqa: E402
from centroidal_mpc_tpu.contact.plan import build_contact_plan  # noqa: E402
from centroidal_mpc_tpu.contact.swing import (  # noqa: E402
    compute_swing_trajectories)
from centroidal_mpc_tpu.models import rigid_body as rb  # noqa: E402
from centroidal_mpc_tpu.models import whole_body_ddp as wbd  # noqa: E402
from centroidal_mpc_tpu.models.centroidal import dynamics_step  # noqa: E402
from centroidal_mpc_tpu.pipeline import run_pipeline  # noqa: E402
from centroidal_mpc_tpu.solver.ddp import DdpSettings, solve_ilqr  # noqa: E402
from centroidal_mpc_tpu.solver.warm_start import (  # noqa: E402
    centroid_state_warm_start, weight_distribution_control_warm_start)
from centroidal_mpc_tpu.utils.artifacts import ArtifactStore  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "jax_pipeline_solo12_trot_n50.npz")
PRESET = presets.SOLO12_TROT_N50
# the 1-step trot of tests/test_whole_body_ddp.py:27-35
TROT1 = gaits.GaitSpec(gaits.TROT, step_length=0.06, step_height=0.05,
                       step_knots=8, support_knots=4, nb_steps=1)
TROT1_DT, TROT1_DT_CTRL = 0.01, 0.001


def warm_start_iterations():
    """The iLQR iteration count of ddp_warm_start on the preset: the same
    solve (solver/warm_start.py:41-97, default weights and settings), which
    returns only X and U."""
    prob = presets.build_problem(PRESET, dtype=jnp.float64)
    sched, robot = prob.plan.schedule, PRESET.robot
    X_ref = jnp.asarray(centroid_state_warm_start(robot, sched, np.float64))
    U_ref = jnp.asarray(weight_distribution_control_warm_start(
        robot, sched, np.float64))
    wx = jnp.asarray([1e3] * 3 + [1e1] * 3 + [1e1] * 3, jnp.float64)
    wu = jnp.full((robot.n_u,), 1e-3, jnp.float64)
    pos, logic, rot = (jnp.asarray(sched.position), jnp.asarray(sched.logic),
                       jnp.asarray(sched.orientation))

    def dynamics(x, u, k):
        return dynamics_step(prob.model, x, u, pos[k], logic[k], rot[k])

    def stage_cost(x, u, k):
        dx, du = x - X_ref[k], u - U_ref[k]
        return jnp.sum(wx * dx * dx) + jnp.sum(wu * du * du)

    def terminal_cost(x):
        dx = x - X_ref[-1]
        return 10.0 * jnp.sum(wx * dx * dx)

    sol = solve_ilqr(dynamics, stage_cost, terminal_cost, X_ref[0], U_ref,
                     DdpSettings())
    return int(sol.iterations), np.asarray(sol.X), np.asarray(sol.U)


def trot1_ddp():
    plan = build_contact_plan(SOLO12, TROT1, TROT1_DT, dtype=jnp.float64)
    swing = compute_swing_trajectories(plan, TROT1_DT_CTRL)
    targets = wbd.build_targets(plan, swing, TROT1_DT_CTRL,
                                dtype=jnp.float64)
    return wbd.solve_whole_body_ddp(rb.solo12_spec(), targets, TROT1_DT)


def main():
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_pipeline(PRESET, ArtifactStore(tmp), stochastic=True,
                           n_sims=64, dtype=jnp.float64,
                           whole_body_mode="ddp")
        manifest = {}
        for name in sorted(os.listdir(tmp)):
            path = os.path.join(tmp, name)
            if name.endswith(".npz"):
                with np.load(path) as f:
                    manifest[name] = {k: list(f[k].shape) for k in f.files}
            else:
                manifest[name] = {"rows_cols": list(np.loadtxt(path).shape)}
    warm_it, warm_X, warm_U = warm_start_iterations()
    assert np.abs(warm_X - res.warm_X).max() < 1e-12
    assert np.abs(warm_U - res.warm_U).max() < 1e-12
    nom, sto, wb, kin = res.nominal, res.stochastic, res.wb_ddp, res.wb_traj
    assert bool(nom.success) and bool(sto.success)
    t1 = trot1_ddp()
    out = dict(
        warm_X=res.warm_X, warm_U=res.warm_U,
        warm_iterations=np.asarray(warm_it),
        nom_X=np.asarray(nom.X), nom_U=np.asarray(nom.U),
        nom_iterations=np.asarray(nom.iterations),
        nom_qp_iterations=np.asarray(nom.qp_iterations),
        sto_X=np.asarray(sto.X), sto_U=np.asarray(sto.U),
        sto_iterations=np.asarray(sto.iterations),
        sto_qp_iterations=np.asarray(sto.qp_iterations),
        kin_q=np.asarray(kin.q), kin_qdot=np.asarray(kin.qdot),
        kin_tau_ff=np.asarray(kin.tau_ff),
        wb_Q=np.asarray(wb.Q), wb_V=np.asarray(wb.V),
        wb_TAU=np.asarray(wb.TAU), wb_cost=np.asarray(wb.cost),
        wb_iterations=np.asarray(wb.iterations),
        trot1_Q=np.asarray(t1.Q), trot1_V=np.asarray(t1.V),
        trot1_TAU=np.asarray(t1.TAU), trot1_cost=np.asarray(t1.cost),
        trot1_iterations=np.asarray(t1.iterations),
        manifest=np.asarray(json.dumps(manifest, sort_keys=True)))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in "
          f"{time.perf_counter() - t0:.0f} s: warm start {warm_it} "
          f"iterations; SCP {int(nom.iterations)} / {int(nom.qp_iterations)}"
          f" QP; stochastic {int(sto.iterations)} / "
          f"{int(sto.qp_iterations)} QP; whole-body DDP "
          f"{int(wb.iterations)} iterations, cost {float(wb.cost):.6g}; "
          f"1-step trot {int(t1.iterations)} iterations, cost "
          f"{float(t1.cost):.6g}")
    print(json.dumps(manifest, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
