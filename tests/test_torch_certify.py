"""The port's copy of the independent QP certifier (ops/certify.py):
the standalone small QP of tests/test_certification.py, the port's
flatten of a batch-first block solution against the JAX package's, and
a certified dense solve."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.ops import blockqp as jbq
from centroidal_mpc_tpu.ops.certify import (flatten_block_solution as
                                            jflatten)
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops.admm import QPSettings, solve_qp
from centroidal_mpc_tpu_torch.ops.certify import (certify_qp_solution,
                                                  flatten_block_solution)
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.solver.ocp import build_qp

from torch_parity_util import qp_pair, qp_settings_pair


def test_certifier_standalone_small_qp():
    """min 1/2 ||x||^2 - [3, 4] x  s.t.  0 <= x <= [1, 10], x0 + x1 <= 8:
    x0 clips at 1, x1 -> 4; the upper-active row's dual is positive."""
    res = certify_qp_solution(
        np.eye(2), np.array([-3.0, -4.0]),
        np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
        np.array([0.0, 0.0, -1e20]), np.array([1.0, 10.0, 8.0]))
    assert res.converged
    np.testing.assert_allclose(res.x, [1.0, 4.0], atol=1e-10)
    assert res.stationarity < 1e-10
    assert res.primal_violation < 1e-10
    assert res.y[0] > 0


def test_flatten_block_solution_matches_jax():
    """Lane 1 of a B=2 port block solve on solo12_trot_mini, flattened to
    the dense layout, equals the JAX package's flatten of its solve of
    the same QP (matched iterations), within 1e-8 of the scale."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   dtype=jnp.float64)
    jqp, tqp, _, _ = qp_pair(jprob, 2)
    jset, tset = qp_settings_pair(eps_abs=1e-6, eps_rel=1e-6, max_iter=2000,
                                  adaptive_rho=False)
    jsol = jax.jit(jax.vmap(lambda q: jbq.solve_block_qp(q, jset)))(jqp)
    tsol = tbq.solve_block_qp(tqp, tset)
    assert bool(tsol.converged.all())
    N = tqp.horizon
    x, y = flatten_block_solution(tsol, N, lane=1)
    jx, jy = jflatten(jax.tree_util.tree_map(lambda a: a[1], jsol), N)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-8 * np.abs(jx).max())
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-8 * np.abs(jy).max())


def test_certify_dense_solve_mini():
    """The port's dense solve of the mini QP at eps 1e-7: the certifier
    reaches KKT residuals <= 1e-8 and the ADMM X/U sit within 1e-4 of
    its solution (tests/test_certification.py's gates)."""
    prob = tpresets.build_problem(tpresets.SOLO12_TROT_MINI,
                                  dtype=torch.float64, device="cpu")
    X, U = prob.X0[None], prob.U0[None]
    cfg = tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                   with_covariance=False)
    qp = build_qp(prob.model, prob.plan.schedule, cfg, X, U, data, 100.0,
                  100.0)
    sol = solve_qp(qp, QPSettings(eps_abs=1e-7, eps_rel=1e-7))
    assert bool(sol.converged[0])
    res = certify_qp_solution(*(getattr(qp, f)[0].numpy() for f in "PqAlu"),
                              sol.x[0].numpy(), sol.y[0].numpy())
    assert res.converged
    assert res.stationarity < 1e-8
    assert res.primal_violation < 1e-8
    assert res.comp_slack < 1e-6
    n_xu = 9 * (prob.plan.horizon + 1) + 12 * prob.plan.horizon
    assert np.abs(sol.x[0].numpy()[:n_xu] - res.x[:n_xu]).max() < 1e-4
