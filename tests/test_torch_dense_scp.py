"""solve_scp of the port with the dense backend (the preset default)
against the JAX package's per-scenario solves, float64 on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.solver.scp import solve_scp as jsolve_scp
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)

from torch_parity_util import perturbed_batch, port_problem


def test_dense_scp_matches_jax():
    """B=2 solo12_trot_mini scenarios (scenario 0 unperturbed) through
    parallel.batch.batched_solve with the preset's own settings (dense
    backend, 'cond' rho, eps 1e-7, SVD trust norm) and through the JAX
    package's solve_scp one scenario at a time: equal SCP and QP
    iterations and statuses, X, U and K within 1e-8."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   dtype=jnp.float64)
    model, schedule, ocp, scp, _, _ = port_problem(jprob)
    assert scp.qp_backend == "dense"
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, 2)
    X, U = torch.as_tensor(Xb), torch.as_tensor(Ub)
    cfg = tile_ocp_config(ocp, X[:, 0], X[:, -1], X)
    sol = batched_solve(model, schedule, cfg, X, U, scp)
    solve = jax.jit(lambda c, x, u: jsolve_scp(
        jprob.model, jprob.plan.schedule, c, x, u, jprob.scp))
    for b in range(2):
        jsol = solve(jprob.ocp.replace(x_init=Xb[b, 0], x_final=Xb[b, -1],
                                       X_track=Xb[b]), Xb[b], Ub[b])
        for f in ("success", "accepted", "iterations", "qp_iterations",
                  "qp_converged", "qp_status"):
            assert getattr(sol, f)[b].item() == np.asarray(
                getattr(jsol, f)).item(), (b, f)
        for f in ("X", "U", "K", "radius", "weight"):
            np.testing.assert_allclose(getattr(sol, f)[b].numpy(),
                                       np.asarray(getattr(jsol, f)),
                                       rtol=1e-8, atol=1e-8,
                                       err_msg=f"{b} {f}")
    assert bool(sol.success.all())
    assert int(sol.qp_refactors.min()) > 0


@pytest.mark.slow
def test_dense_quick_start_n165_matches_jax():
    """The README's quick start (solo12_trot, N=165, preset settings) in
    f64: the port's solve equals the JAX package's at equal QP
    iterations, X/U within 1e-8; and tests/data/jax_dense_solo12_trot.npz,
    which chip_smoke.py holds the card to, is that JAX solution."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT, dtype=jnp.float64)
    jsol = jax.jit(lambda: jsolve_scp(jprob.model, jprob.plan.schedule,
                                      jprob.ocp, jprob.X0, jprob.U0,
                                      jprob.scp))()
    model, schedule, ocp, scp, X0, U0 = port_problem(jprob)
    X, U = X0[None], U0[None]
    sol = batched_solve(model, schedule,
                        tile_ocp_config(ocp, X[:, 0], X[:, -1], X), X, U,
                        scp)
    assert bool(sol.success[0])
    assert int(sol.qp_iterations[0]) == int(jsol.qp_iterations)
    for f in ("X", "U"):
        np.testing.assert_allclose(getattr(sol, f)[0].numpy(),
                                   np.asarray(getattr(jsol, f)), rtol=1e-8,
                                   atol=1e-8)
    ref = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "jax_dense_solo12_trot.npz"))
    assert int(ref["scp_qp_iterations"]) == int(jsol.qp_iterations)
    np.testing.assert_allclose(ref["U"], np.asarray(jsol.U), rtol=1e-12,
                               atol=1e-12)
