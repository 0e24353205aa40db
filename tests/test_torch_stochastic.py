"""The chance-constrained stochastic mode of the PyTorch port against the
JAX package (float64): the covariance recursion, the chance back-offs,
the stochastic block QP, a stochastic SCP solve with the pipeline's 30
DARE steps, and the infeasibility certificate the back-offs can force."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.ops import blockqp as jbq
from centroidal_mpc_tpu.parallel.batch import batched_solve as jbatched
from centroidal_mpc_tpu.parallel.batch import tile_ocp_config as jtile
from centroidal_mpc_tpu.solver import ocp as jocp
from centroidal_mpc_tpu_torch import convert
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.models import centroidal as tcm
from centroidal_mpc_tpu_torch.models.centroidal import TrajectoryData
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops.admm import STATUS_PRIMAL_INFEASIBLE
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)
from centroidal_mpc_tpu_torch.solver import ocp as tocp

from torch_parity_util import (BENCH_QP, assert_tree_close,
                               infeasible_stochastic_qp_pair,
                               jax_trajectory_data, np_fields,
                               perturbed_batch, port_problem, qp_pair,
                               qp_settings_pair, talos_short, to_np)


def _jax_data(jprob, batch, lqr_iters=2, seed=5):
    """The JAX package's trajectory data (with covariance) of a perturbed
    batch, and the same data converted for the port."""
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, batch, seed=seed,
                             scale=1e-3)
    jd = jax_trajectory_data(jprob.model, jprob.plan.schedule, Xb, Ub,
                             lqr_iters, True)
    return jd, convert.from_numpy(TrajectoryData, np_fields(jd), "cpu")


def test_propagate_covariance_matches_jax():
    """Sigma over the mini horizon from the real linearization and its
    DARE gains (the JAX package's A, B, C, K for both), batch-first
    against the vmapped JAX scan: rtol 1e-12."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   stochastic=True, dtype=jnp.float64)
    jd, td = _jax_data(jprob, 2)
    model = port_problem(jprob)[0]
    Sigma = tcm.propagate_covariance(model, td.A, td.B, td.C, td.K)
    ref = np.asarray(jd.Sigma)
    assert Sigma.shape == ref.shape == (2, 19, 9, 9)
    assert not Sigma[:, 0].any() and ref[:, -1].trace(axis1=-2,
                                                      axis2=-1).min() > 0
    np.testing.assert_allclose(Sigma.numpy(), ref, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("preset", [jpresets.SOLO12_TROT_MINI,
                                    talos_short()],
                         ids=["solo12_trot_mini", "talos_pace_short"])
def test_chance_backoffs_match_jax(preset):
    """_chance_backoffs on the same K and Sigma (the JAX package's): the
    point3 split (solo12) and the wrench6 one, K rows 2:5 of each contact
    (talos, its gait cut to N=30; built only, never solved), zero at knot
    0: round-off."""
    jprob = jpresets.build_problem(preset, stochastic=True,
                                   dtype=jnp.float64)
    jd, td = _jax_data(jprob, 2)
    model, schedule, ocp, *_ = port_problem(jprob)
    sched = jprob.plan.schedule
    jrot = jnp.einsum("ri,kcji->kcrj", jprob.ocp.pyramid, sched.orientation)
    jrot = (jrot * sched.logic[:, :, None, None]).at[:, :, 4, :].set(0.0)
    ref = np.asarray(jax.vmap(lambda d: jocp._chance_backoffs(
        jprob.model, jprob.ocp, d, jrot))(jd))
    X = torch.zeros((2, 1, 9), dtype=torch.float64)
    cfg = tile_ocp_config(ocp, X[:, 0], X[:, 0], X)
    rot = torch.tensor(np.asarray(jrot)).expand((2,) + jrot.shape)
    got = tocp._chance_backoffs(model, cfg, td, rot)
    assert got.shape == ref.shape and ref[:, 1:].max() > 0
    assert not got[:, 0].any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-14)


def test_stochastic_build_block_qp_matches_jax():
    """The stochastic block QP (friction upper bounds lowered by the
    back-offs) equals the JAX package's on every field at 1e-12."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   stochastic=True, dtype=jnp.float64)
    jqp, tqp, _, _ = qp_pair(jprob, 2)
    assert float(tqp.fric_ub.min()) < 0
    assert_tree_close(to_np(tqp), to_np(jqp), rtol=1e-12, atol=1e-12)


# the bench point with a short polish: every polish stage (ALM rounds, CG,
# TwoSum) still runs, and the JAX program, which unrolls the polish,
# compiles in ~29 s against ~42 s
STOCH_QP = {**BENCH_QP, "polish_iters": 4, "polish_cg_iters": 4}


def _stochastic_solve_pair(preset, lqr_iters, batch=2):
    jqp, _ = qp_settings_pair(**STOCH_QP)
    jprob = jpresets.build_problem(preset, stochastic=True,
                                   dtype=jnp.float64, qp=jqp)
    jscp = dataclasses.replace(jprob.scp, qp_backend="block",
                               norm_method="power", lqr_iters=lqr_iters)
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, batch, seed=0)
    jsol = jax.jit(lambda c, x, u: jbatched(
        jprob.model, jprob.plan.schedule, c, x, u, jscp))(
            jtile(jprob.ocp, Xb[:, 0], Xb[:, -1], Xb), Xb, Ub)
    model, schedule, ocp, scp, _, _ = port_problem(jprob)
    assert ocp.stochastic and scp.lqr_iters == 2
    scp = dataclasses.replace(scp, qp_backend="block", norm_method="power",
                              lqr_iters=lqr_iters)
    X, U = torch.as_tensor(Xb), torch.as_tensor(Ub)
    sol = batched_solve(model, schedule,
                        tile_ocp_config(ocp, X[:, 0], X[:, -1], X), X, U,
                        scp)
    return jsol, sol


def _assert_solves_match(jsol, sol):
    for k in ("success", "iterations", "qp_iterations", "accepted",
              "qp_status", "qp_converged"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(),
                                      np.asarray(getattr(jsol, k)),
                                      err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_allclose(getattr(sol, k).numpy(),
                                   np.asarray(getattr(jsol, k)), rtol=1e-8,
                                   atol=1e-8, err_msg=k)
    # Sigma is built from the gains, which the two packages invert
    # differently (Cholesky / Newton-Schulz): 1e-9 relative, as K
    for k in ("K", "Sigma"):
        ref = np.asarray(getattr(jsol, k))
        assert np.abs(getattr(sol, k).numpy() - ref).max() < \
            1e-9 * np.abs(ref).max(), k


@pytest.mark.parametrize("lqr_iters", [
    30,                                          # the pipeline's stage 2'
    pytest.param(2, marks=pytest.mark.slow)])    # the bench's stochastic row
def test_stochastic_solve_matches_jax(lqr_iters):
    """solo12_trot_mini, stochastic, B=2, bench operating point (a short
    polish, STOCH_QP): equal
    success, SCP and QP iteration counts and statuses; X/U within 1e-8;
    K and Sigma within 1e-9 relative.  lqr_iters is static to the JAX
    program, so each step count is one more compile: 2 steps is the slow
    case (the back-off and block-QP tests above run at 2)."""
    jsol, sol = _stochastic_solve_pair(jpresets.SOLO12_TROT_MINI, lqr_iters)
    assert sol.success.all()
    assert float(sol.Sigma[:, -1].diagonal(dim1=-2, dim2=-1).sum(-1).min()) > 0
    _assert_solves_match(jsol, sol)


def test_stochastic_qp_certified_infeasible_like_jax():
    """Back-offs that empty a friction cone (torch_parity_util.
    infeasible_stochastic_qp_pair: N=50 trot, cov_w scaled by 3e3).
    Fixed rho (re-adaptation restarts the certificate ray): both packages
    certify PRIMAL_INFEASIBLE at the same iteration, B=2."""
    jqp, tqp = infeasible_stochastic_qp_pair()
    assert float(tqp.fric_ub.min()) < -4.0
    jset, tset = qp_settings_pair(max_iter=4000, eps_abs=1e-6, eps_rel=1e-6,
                                  adaptive_rho=False, factor_method="pallas")
    jsol = jax.jit(jax.vmap(lambda q: jbq.solve_block_qp(q, jset)))(jqp)
    tsol = tbq.solve_block_qp(tqp, tset)
    assert (tsol.status == STATUS_PRIMAL_INFEASIBLE).all()
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))
    assert int(tsol.iterations.max()) < tset.max_iter


def _port_stochastic_qp(preset, lqr_iters):
    p = tpresets.build_problem(preset, stochastic=True, dtype=torch.float64,
                               device="cpu")
    X, U = p.X0[None], p.U0[None]
    data = tcm.compute_trajectory_data(p.model, p.plan.schedule, X, U,
                                       lqr_iters=lqr_iters)
    return tbq.build_block_qp(p.model, p.plan.schedule,
                              tile_ocp_config(p.ocp, X[:, 0], X[:, -1], X),
                              X, U, data, 100.0, 100.0)


@pytest.mark.slow
@pytest.mark.parametrize("name,lqr_iters,max_iter", [
    # tests/test_full_horizons.py:82: the flight-heavy bound cannot
    # afford the chance margins even with the stabilized gains
    ("solo12_bound", 30, 30000),
    # tests/test_infeasibility.py:156: the reference's 2-step gains let
    # the covariance grow over N=165
    ("solo12_trot", 2, 4000)])
def test_full_horizon_stochastic_certified_infeasible(name, lqr_iters,
                                                      max_iter):
    """The port certifies the two known-infeasible full-horizon cases
    PRIMAL_INFEASIBLE inside the budget, as the JAX package's tests do
    (fixed rho = 10)."""
    qp = _port_stochastic_qp(tpresets.PRESETS[name], lqr_iters)
    assert float(qp.fric_ub.min()) < -1.0
    st = tpresets.QPSettings(max_iter=max_iter, eps_abs=1e-6, eps_rel=1e-6,
                             rho=10.0, adaptive_rho=False)
    sol = tbq.solve_block_qp(qp, st)
    assert int(sol.status[0]) == STATUS_PRIMAL_INFEASIBLE
    assert int(sol.iterations[0]) < max_iter
