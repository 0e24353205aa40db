"""solve_block_qp of the PyTorch port against the JAX package's
batch-first ADMM loop, float64, at matched iteration counts; and the
port's f32 loop at the eps=1e-5 accuracy tier."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.ops import blockqp as jbq
from centroidal_mpc_tpu_torch._tree import map_tensors
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config

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
    # residuals of a polished iterate sit near their f64 round-off floor.
    # The primal one sums O(1e2) terms: rtol 1e-6 plus atol 1e-10.  The
    # dual one sums products with the duals, which reach ~1e4 here, so
    # its floor is the one of y above, 1e-12 max|y| of the lane (the
    # order of the f64 sums moves it by ~1e-9: a port value changes by
    # 8.8e-10 between one and four torch threads)
    np.testing.assert_allclose(tsol.prim_res.numpy(),
                               np.asarray(jsol.prim_res), rtol=1e-6,
                               atol=1e-10, err_msg="prim_res")
    y_max = np.max([np.abs(np.asarray(jy)).reshape(len(tb), -1).max(-1)
                    for jy in jsol.y], axis=0)
    j_dual = np.asarray(jsol.dual_res)
    assert (np.abs(tsol.dual_res.numpy() - j_dual)
            <= 1e-6 * np.abs(j_dual) + 1e-12 * y_max).all(), (
        tsol.dual_res.numpy(), j_dual, y_max)


def test_eps_1e5_tier_certifies_in_f32():
    """The bench's eps=1e-5 accuracy tier on the batch-first loop in f32
    (the plain kernel versions on the CPU): the N=50 trot QP of
    tests/test_blockqp.py (built in f64, cast to f32), B=2 (lane 1's CoM
    x/y shifted by 5 mm), warm-started at the trajectory, tier settings
    (eps 1e-5, polish ramp 10, CG 20 x 3).  Both lanes converge and the
    polished dual residual stays under that test's ~2.6e-2 relative
    threshold (tests/test_blockqp.py:278-279); the port lands near
    1.9e-2, twice the JAX batch path's (ROADMAP Queue C)."""
    prob = tpresets.build_problem(tpresets.SOLO12_TROT_N50,
                                  dtype=torch.float64, device="cpu")
    X = prob.X0[None].repeat(2, 1, 1)
    U = prob.U0[None].repeat(2, 1, 1)
    X[1, :, :2] += 0.005
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                   with_covariance=False)
    qp = tbq.build_block_qp(prob.model, prob.plan.schedule,
                            tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X),
                            X, U, data, 100.0, 100.0)
    qp32 = map_tensors(
        lambda a: a.float() if a.is_floating_point() else a, qp)
    _, tier = qp_settings_pair(
        eps_abs=1e-5, eps_rel=1e-5, max_iter=4000, adaptive_rho=False,
        check_interval=10, alpha=1.7, stall_segments=30, polish=True,
        polish_rho_ramp=10.0, polish_cg_iters=20, polish_cg_restarts=3)
    w0 = tbq.WVars(x=X.float(), u=U.float(),
                   t=torch.zeros(X.shape[:2], dtype=torch.float32))
    sol = tbq.solve_block_qp(qp32, tier, w0=w0)
    assert sol.X.dtype == torch.float32
    assert sol.converged.all(), (sol.prim_res, sol.dual_res)
    assert (sol.dual_res < 2.6e-2).all(), sol.dual_res
