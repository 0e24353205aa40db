"""Scenario 0 of talos_pace in float32 through the JAX package and the
PyTorch port, both on the CPU, at the bench's preset-matrix point.

    python3 scripts/talos_witness.py [--f64] [--batch B] [--no-port]

The bench's talos row (bench.py, preset_matrix): eps 5e-4 with the
refinement polish (12 ALM x 2 rounds, CG 8 x 1), check_interval 10,
alpha 1.7, stall 30, max_iter 4000, 'always' adaptive rho, block
backend, power trust norm, wrench6 contacts and the preset's in-loop
re-linearization.  Scenario 0 is unperturbed; with --batch B, B - 1 more
scenarios ride along with 0.005 N(0,1) m on CoM x/y
(numpy.random.default_rng(0), as chip_smoke.py), so that scenario 0 is
computed in a batch of B; the results are scenario 0's.
Prints one JSON line per package: success, SCP and QP iterations, the
last QP status, and x_err_inf / u_err_inf against the committed float64
reference (benchmarks/ref_cache/talos_pace_3a1d4d3d1382.npz); then the
largest difference of X and U between the two packages.  --f64 runs both
in float64 instead.  The JAX program compiles in about a minute on a CPU.
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF = os.path.join(ROOT, "benchmarks", "ref_cache",
                   "talos_pace_3a1d4d3d1382.npz")
QP_FIELDS = dict(eps_abs=5e-4, eps_rel=5e-4, polish=True, polish_iters=12,
                 polish_rounds=2, polish_cg_iters=8, polish_cg_restarts=1,
                 check_interval=10, alpha=1.7, adaptive_rho=True,
                 adaptive_rho_mode="always", max_iter=4000,
                 stall_segments=30, factor_method="pallas")


F64 = "--f64" in sys.argv[1:]
BATCH = (int(sys.argv[sys.argv.index("--batch") + 1])
         if "--batch" in sys.argv[1:] else 1)


def start(X0):
    """(B, N+1, 9) warm-start states: scenario 0 unperturbed."""
    dx = np.zeros((BATCH, 9))
    dx[1:, :2] = 0.005 * np.random.default_rng(0).standard_normal(
        (BATCH - 1, 2))
    return np.asarray(X0, np.float64)[None] + dx[:, None, :]


def record(package, sol, seconds):
    ref = np.load(REF)
    X = np.asarray(sol.X, np.float64)[0]
    U = np.asarray(sol.U, np.float64)[0]
    return X, U, dict(
        package=package, dtype="float64" if F64 else "float32", batch=BATCH,
        success=bool(np.asarray(sol.success)[0]),
        scp_iterations=int(np.asarray(sol.iterations)[0]),
        qp_iterations=int(np.asarray(sol.qp_iterations)[0]),
        qp_status=int(np.asarray(sol.qp_status)[0]),
        x_err_inf=float(np.abs(X - ref["X"]).max()),
        u_err_inf=float(np.abs(U - ref["U"]).max()),
        seconds=round(seconds, 1))


def run_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", F64)
    import jax.numpy as jnp
    from centroidal_mpc_tpu.config import presets
    from centroidal_mpc_tpu.ops.admm import QPSettings
    from centroidal_mpc_tpu.parallel.batch import (batched_solve,
                                                   tile_ocp_config)
    prob = presets.build_problem(
        presets.TALOS_PACE, dtype=jnp.float64 if F64 else jnp.float32,
        qp=QPSettings(**QP_FIELDS))
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    X0 = jnp.asarray(start(prob.X0), prob.X0.dtype)
    U0 = jnp.broadcast_to(prob.U0, (BATCH,) + prob.U0.shape)
    t0 = time.perf_counter()
    sol = jax.jit(lambda c, x, u: batched_solve(
        prob.model, prob.plan.schedule, c, x, u, scp))(
            tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0), X0, U0)
    jax.block_until_ready(sol)
    return record("centroidal_mpc_tpu (JAX, CPU)", sol,
                  time.perf_counter() - t0)


def run_port():
    import torch
    from centroidal_mpc_tpu_torch.config import presets
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                         tile_ocp_config)
    prob = presets.build_problem(
        presets.TALOS_PACE, dtype=torch.float64 if F64 else torch.float32,
        qp=QPSettings(**QP_FIELDS), device="cpu")
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    X0 = torch.as_tensor(start(prob.X0.numpy()), dtype=prob.X0.dtype)
    U0 = prob.U0.expand((BATCH,) + prob.U0.shape)
    t0 = time.perf_counter()
    sol = batched_solve(prob.model, prob.plan.schedule,
                        tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0),
                        X0, U0, scp)
    return record("centroidal_mpc_tpu_torch (CPU)", sol,
                  time.perf_counter() - t0)


if __name__ == "__main__":
    Xj, Uj, rec = run_jax()
    print(json.dumps(rec), flush=True)
    if "--no-port" not in sys.argv[1:]:
        Xt, Ut, rec = run_port()
        print(json.dumps(rec), flush=True)
        print(json.dumps(dict(port_vs_jax_x=float(np.abs(Xt - Xj).max()),
                              port_vs_jax_u=float(np.abs(Ut - Uj).max()))))
