"""Write the JAX package's float64 dense solve of the README's quick-start
problem (solo12_trot, N=165, the preset's own settings: dense backend,
'cond' rho, eps 1e-7) to tests/data/jax_dense_solo12_trot.npz:

    X, U               the SCP solution (solve_scp)
    scp_qp_iterations  its cumulative QP iterations
    qp_x               the first SCP iteration's dense QP solved alone
    qp_iterations      (solve_qp at the warm start, radius0 and omega0)

chip_smoke.py's `# dense/solo12_trot` phase holds the port's f64 solve
on the card to these: the dense solve misses the 1e-4 bar against the
block-solver cache (u_err 1.06e-4) in the JAX package too.  Runs on the
CPU in a few seconds:

    python scripts/jax_dense_reference.py
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from centroidal_mpc_tpu import presets, solve_scp  # noqa: E402
from centroidal_mpc_tpu.models.centroidal import (  # noqa: E402
    compute_trajectory_data)
from centroidal_mpc_tpu.ops.admm import solve_qp  # noqa: E402
from centroidal_mpc_tpu.solver.ocp import build_qp  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "jax_dense_solo12_trot.npz")


def main():
    prob = presets.build_problem(presets.SOLO12_TROT, dtype=jnp.float64)
    sol = jax.jit(lambda: solve_scp(prob.model, prob.plan.schedule,
                                    prob.ocp, prob.X0, prob.U0, prob.scp))()
    assert bool(sol.success)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, prob.X0,
                                   prob.U0, lqr_iters=prob.scp.lqr_iters,
                                   with_covariance=False)
    qp = build_qp(prob.model, prob.plan.schedule, prob.ocp, prob.X0,
                  prob.U0, data,
                  jnp.asarray(prob.scp.trust_region_radius0, jnp.float64),
                  jnp.asarray(prob.scp.omega0, jnp.float64))
    qsol = jax.jit(lambda q: solve_qp(q, prob.scp.qp))(qp)
    assert bool(qsol.converged)
    np.savez(OUT, X=np.asarray(sol.X), U=np.asarray(sol.U),
             scp_qp_iterations=np.asarray(sol.qp_iterations),
             qp_x=np.asarray(qsol.x),
             qp_iterations=np.asarray(qsol.iterations))
    print(f"wrote {OUT}: {int(sol.qp_iterations)} QP iterations in the "
          f"SCP, {int(qsol.iterations)} in the first QP alone")


if __name__ == "__main__":
    main()
