"""solve_block_qp of the PyTorch port against the JAX package's
batch-first ADMM loop, float64, at matched iteration counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.ops import blockqp as jbq
from centroidal_mpc_tpu_torch.ops import blockqp as tbq

from torch_parity_util import qp_pair, qp_settings_pair, reduced_trot


@pytest.mark.parametrize("problem,polish,adaptive,eps,max_iter,status", [
    # the reduced gait of tests/test_pallas_blockqp.py: its 0.12 m step in
    # 18 knots is not dynamically feasible, so 500 iterations end at
    # MAX_ITER (the sequence of iterates is still compared exactly)
    ("reduced", False, True, 1e-5, 500, 0),
    # step-in-place trot: converges, and the polish is accepted
    ("mini", True, False, 1e-4, 2000, 1)])
def test_solve_block_qp_matches_jax(problem, polish, adaptive, eps,
                                    max_iter, status):
    """(g) B=3 scenarios through the JAX package's vmapped solve_block_qp
    with factor_method='pallas' (below PALLAS_MIN_BATCH, so its
    batch-first loop runs on its XLA twins) and through the port: equal
    iteration counts and statuses, X/U within 1e-8 (f64 round-off carried
    through the iterations)."""
    jprob = (reduced_trot() if problem == "reduced" else
             jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                    dtype=jnp.float64))
    jqp, tqp, Xb, Ub = qp_pair(jprob, 3)
    fields = dict(eps_abs=eps, eps_rel=eps, max_iter=max_iter,
                  adaptive_rho=adaptive, adaptive_rho_mode="always",
                  factor_method="pallas", polish=polish, check_interval=10,
                  stall_segments=30,
                  # a short polish keeps the JAX compile cheap; every
                  # stage (ALM rounds, CG, TwoSum) still runs
                  polish_iters=4, polish_cg_iters=4, polish_cg_restarts=1)
    jset, tset = qp_settings_pair(**fields)
    tb = np.zeros(Xb.shape[:2])
    jsol = jax.jit(jax.vmap(lambda q, x, u, t: jbq.solve_block_qp(
        q, jset, w0=jbq.WVars(x=x, u=u, t=t))))(jqp, Xb, Ub, tb)
    tsol = tbq.solve_block_qp(tqp, tset, w0=tbq.WVars(
        *(torch.as_tensor(a) for a in (Xb, Ub, tb))))
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    assert (tsol.status == status).all()
    for k in ("X", "U", "t"):
        np.testing.assert_allclose(getattr(tsol, k).numpy(),
                                   np.asarray(getattr(jsol, k)),
                                   rtol=1e-8, atol=1e-8, err_msg=k)
    # the dual the SCP loop threads into its next QP as a warm start:
    # f64 round-off against the group's largest |y| (up to ~1e7 here)
    for ty, jy, lo in zip(tsol.y, jsol.y, tsol.y_lo):
        ty, jy, lo = ty.numpy(), np.asarray(jy), lo.numpy()
        assert np.abs(ty - jy).max() <= 1e-12 * np.abs(jy).max() + 1e-14
        # the JAX package drops the low part of the two-float dual; the
        # port keeps it: zero unless the polish (with its CG refinement)
        # was accepted, and a TwoSum rounding error, at most one ulp of y
        # after the unscaling, where it was
        if not polish:
            assert not lo.any()
        assert (np.abs(lo) <= np.spacing(np.abs(ty))).all()
    if polish:
        assert any(lo.abs().max() > 0 for lo in tsol.y_lo)
    for k in ("prim_res", "dual_res"):
        # residuals of a polished iterate sit near their f64 round-off
        # floor (sums of O(1e2) terms): rtol 1e-6 plus atol 1e-10
        np.testing.assert_allclose(getattr(tsol, k).numpy(),
                                   np.asarray(getattr(jsol, k)), rtol=1e-6,
                                   atol=1e-10, err_msg=k)
