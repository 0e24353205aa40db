"""The block solver's other backends in the port -- the log-depth
'assoc' sweep and the block-Thomas factor -- against the 'scan' and
'cholesky' paths and against the JAX package's versions, float64 on the
CPU (the cases of tests/test_sweep_backends.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.ops import blockqp as jbq
from centroidal_mpc_tpu.ops import linalg as jlinalg
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops import linalg as tlinalg
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config


def _random_block_tridiag(b, n, v, seed):
    """B diagonally dominant SPD block-tridiagonal systems (numpy)."""
    rng = np.random.default_rng(seed)
    off = 0.3 * rng.standard_normal((b, n, v, v))
    r = rng.standard_normal((b, n + 1, v, v))
    diag = r @ np.swapaxes(r, -1, -2) / v + 2.0 * np.eye(v)
    diag = diag + 2.0 * np.eye(v) * np.abs(off).sum(axis=(-2, -1)).max()
    rhs = rng.standard_normal((b, n + 1, v))
    return diag, off, rhs


def _apply_m(diag, off, w):
    out = np.einsum("bkij,bkj->bki", diag, w)
    out[:, 1:] += np.einsum("bkij,bkj->bki", off, w[:, :-1])
    out[:, :-1] += np.einsum("bkji,bkj->bki", off, w[:, 1:])
    return out


@pytest.mark.parametrize("n,v", [(7, 22), (24, 9), (1, 5)])
def test_assoc_sweep_matches_scan_and_jax(n, v):
    """The doubling sweeps give the sequential sweeps' solution on the
    same factor, and the JAX package's associative-scan sweeps', within
    1e-10."""
    diag, off, rhs = _random_block_tridiag(2, n, v, seed=0)
    fac = bt.factor_plain(torch.as_tensor(diag), torch.as_tensor(off))
    b = torch.as_tensor(rhs)
    w_assoc = bt.solve_assoc(fac, b).numpy()
    np.testing.assert_allclose(w_assoc, bt.solve_batched(fac, b).numpy(),
                               rtol=1e-10, atol=1e-10)
    for lane in range(2):
        jfac = jbq._block_tridiag_cholesky(jnp.asarray(diag[lane]),
                                           jnp.asarray(off[lane]))
        w_jax = jbq._block_tridiag_solve(jfac, jnp.asarray(rhs[lane]),
                                         "assoc")
        np.testing.assert_allclose(w_assoc[lane], np.asarray(w_jax),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n,v", [(7, 22), (24, 9)])
def test_thomas_factorization_solves_M(n, v):
    """The Thomas factor (Newton-Schulz Schur inverses) inverts M, and
    its solution is the JAX package's within 1e-10."""
    diag, off, rhs = _random_block_tridiag(2, n, v, seed=1)
    fac = tbq.thomas_factor(torch.as_tensor(diag), torch.as_tensor(off))
    w = tbq.thomas_solve(fac, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(_apply_m(diag, off, w), rhs, rtol=1e-7,
                               atol=1e-7)
    for lane in range(2):
        jfac = jbq._block_tridiag_thomas(jnp.asarray(diag[lane]),
                                         jnp.asarray(off[lane]))
        w_jax = jbq._block_thomas_solve(jfac, jnp.asarray(rhs[lane]))
        np.testing.assert_allclose(w[lane], np.asarray(w_jax), rtol=1e-10,
                                   atol=1e-10)


def test_spd_inverse_matches_jax():
    rng = np.random.default_rng(2)
    r = rng.standard_normal((4, 12, 12))
    H = r @ np.swapaxes(r, -1, -2) / 12 + np.diag(rng.uniform(1, 3, 12))
    got = tlinalg.spd_inverse(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlinalg.spd_inverse(
        jnp.asarray(H))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got @ H, np.broadcast_to(np.eye(12), H.shape),
                               atol=1e-10)


@pytest.fixture(scope="module")
def tiny_qp():
    """The feasible N=18 trot QP of tests/test_sweep_backends.py (0.02 m
    steps; ~2.7k ADMM iterations), B=1, from its warm start."""
    preset = dataclasses.replace(
        tpresets.SOLO12_TROT_N50,
        gait=dataclasses.replace(tpresets.SOLO12_TROT_N50.gait,
                                 step_length=0.02, step_knots=6,
                                 support_knots=2, nb_steps=1))
    prob = tpresets.build_problem(preset, dtype=torch.float64, device="cpu")
    X, U = prob.X0[None], prob.U0[None]
    cfg = tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                   with_covariance=False)
    qp = tbq.build_block_qp(prob.model, prob.plan.schedule, cfg, X, U, data,
                            100.0, 100.0)
    w0 = tbq.WVars(x=X, u=U, t=torch.zeros(X.shape[:2], dtype=X.dtype))
    return qp, w0


def _solve(qp, w0, **overrides):
    st = QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000,
                    adaptive_rho=True, adaptive_rho_mode="always",
                    **overrides)
    return tbq.solve_block_qp(qp, st, w0=w0)


@pytest.fixture(scope="module")
def scan_solution(tiny_qp):
    return _solve(*tiny_qp, sweep_method="scan")


def test_solve_block_qp_assoc_iterate_sequence(tiny_qp, scan_solution):
    """A full solve with sweep_method='assoc' walks the iterate sequence
    of 'scan': equal iteration counts, X/U within 1e-8."""
    sol_a = _solve(*tiny_qp, sweep_method="assoc")
    assert bool(scan_solution.converged[0]) and bool(sol_a.converged[0])
    assert torch.equal(sol_a.iterations, scan_solution.iterations)
    torch.testing.assert_close(sol_a.X, scan_solution.X, rtol=1e-8,
                               atol=1e-8)
    torch.testing.assert_close(sol_a.U, scan_solution.U, rtol=1e-8,
                               atol=1e-8)


def test_solve_block_qp_thomas_matches_cholesky(tiny_qp, scan_solution):
    """factor_method='thomas' solves the same QP to the same tolerance:
    X/U within the termination band of the 'cholesky' solution."""
    sol_t = _solve(*tiny_qp, factor_method="thomas")
    assert bool(sol_t.converged[0])
    torch.testing.assert_close(sol_t.X, scan_solution.X, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(sol_t.U, scan_solution.U, rtol=1e-4,
                               atol=1e-4)
