"""The re-linearizing SCP loop of the PyTorch port against the JAX
package (float64, at matched iteration counts)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.parallel.batch import batched_solve as jbatched
from centroidal_mpc_tpu.parallel.batch import tile_ocp_config as jtile
from centroidal_mpc_tpu.solver import scp as jscp
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)
from centroidal_mpc_tpu_torch.solver import scp as tscp

from torch_parity_util import (BENCH_QP, perturbed_batch, port_problem,
                               qp_settings_pair, talos_short)

# the bench point with a shorter polish: the JAX program unrolls the
# polish, so each stage of it costs compile time.  solo12 runs without it
# (~14 s against ~33 s; the polish is held to the JAX package's by
# test_torch_solve_qp.py and test_torch_stochastic.py, and this file tests
# the loop around the QP); talos, which needs the polish to converge,
# runs one round of 4 ALM and 4 CG steps (~26 s against ~35 s)
RELIN_QP = {**BENCH_QP, "polish": False}
TALOS_QP = {**BENCH_QP, "polish_iters": 4, "polish_rounds": 1,
            "polish_cg_iters": 4, "adaptive_rho": True,
            "adaptive_rho_mode": "always"}


@pytest.mark.parametrize("preset,qp", [
    # solo12 trot, re-linearizing: the lanes stop at different SCP
    # iterations (the second lane converges one iteration later)
    (jpresets.SOLO12_TROT_MINI, RELIN_QP),
    # talos: wrench6 with the preset's re-linearization, 'always' rho as
    # the bench's preset matrix runs it (bench.py:564-571); here too the
    # lanes stop at different SCP iterations
    (talos_short(), TALOS_QP)],
    ids=["solo12_trot_mini", "talos_pace_short"])
def test_relinearizing_solve_matches_jax(preset, qp):
    """update_linearization=True, B=2, f64: equal success, SCP and QP
    iteration counts per lane, statuses and accept counts; the
    model-accuracy ratio rho, the trust radius and the penalty weight at
    f64 round-off carried through the loop; X/U within 1e-8."""
    jqp, _ = qp_settings_pair(**qp)
    jprob = jpresets.build_problem(preset, dtype=jnp.float64, qp=jqp)
    jset = dataclasses.replace(jprob.scp, qp_backend="block",
                               norm_method="power", update_linearization=True)
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, 2, seed=0)
    jsol = jax.jit(lambda c, x, u: jbatched(
        jprob.model, jprob.plan.schedule, c, x, u, jset))(
            jtile(jprob.ocp, Xb[:, 0], Xb[:, -1], Xb), Xb, Ub)

    model, schedule, ocp, scp, _, _ = port_problem(jprob)
    scp = dataclasses.replace(scp, qp_backend="block", norm_method="power",
                              update_linearization=True)
    X, U = torch.as_tensor(Xb), torch.as_tensor(Ub)
    sol = batched_solve(model, schedule,
                        tile_ocp_config(ocp, X[:, 0], X[:, -1], X), X, U,
                        scp)
    assert sol.success.all() and (sol.iterations > 1).all()
    assert (sol.conv < scp.convergence_threshold).all()
    for k in ("success", "iterations", "qp_iterations", "accepted",
              "qp_status", "qp_converged"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(),
                                      np.asarray(getattr(jsol, k)),
                                      err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_allclose(getattr(sol, k).numpy(),
                                   np.asarray(getattr(jsol, k)), rtol=1e-8,
                                   atol=1e-8, err_msg=k)
    for k in ("rho", "radius", "weight"):
        np.testing.assert_allclose(getattr(sol, k).numpy(),
                                   np.asarray(getattr(jsol, k)), rtol=1e-6,
                                   atol=1e-12, err_msg=k)


def test_convergence_metric_matches_jax():
    """_convergence_metric against the JAX package's, batch-first: the
    exact SVD norm whatever norm_method says (the JAX function calls
    _matrix_norm2 with its default), rtol 1e-12."""
    rng = np.random.default_rng(8)
    X1, X2 = rng.standard_normal((2, 3, 19, 9))
    U1, U2 = rng.standard_normal((2, 3, 18, 12))
    ref = np.array([float(jscp._convergence_metric(*a))
                    for a in zip(X1, U1, X2, U2)])
    got = tscp._convergence_metric(*(torch.as_tensor(a)
                                     for a in (X1, U1, X2, U2)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
