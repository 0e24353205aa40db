"""The port's exact chance back-offs (solver/stochastic.py) against the
JAX package in float64 on the CPU, on the tiny stochastic problem of
tests/test_stochastic_exact.py; and the DARE's autograd.Function
(ops/lqr_kernel.lqr_gain) against autograd through its plain version."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import gaits as jgaits
from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.models.centroidal import (compute_trajectory_data as
                                                  jtraj)
from centroidal_mpc_tpu.solver import ocp as jocp
from centroidal_mpc_tpu.solver import stochastic as jst
from centroidal_mpc_tpu_torch.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu_torch.ops import lqr_kernel
from centroidal_mpc_tpu_torch.ops.admm import QPSettings, solve_qp
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.solver import ocp as tocp
from centroidal_mpc_tpu_torch.solver import stochastic as tst

from torch_parity_util import port_problem


@pytest.fixture(scope="module")
def tiny():
    """(JAX problem, port (model, schedule, cfg B=1, X, U), JAX jacobians)
    of tests/test_stochastic_exact.py's tiny problem (N=12)."""
    gait = jgaits.GaitSpec(jgaits.TROT, step_length=0.0, step_height=0.05,
                           step_knots=3, support_knots=2, nb_steps=1)
    jprob = jpresets.build_problem(
        dataclasses.replace(jpresets.SOLO12_TROT, gait=gait),
        stochastic=True, dtype=jnp.float64)
    model, schedule, ocp, _, X0, U0 = port_problem(jprob)
    X, U = X0[None], U0[None]
    cfg = tile_ocp_config(ocp, X[:, 0], X[:, -1], X)
    jac = jst.backoff_jacobians(jprob.model, jprob.plan.schedule, jprob.ocp,
                                jprob.X0, jprob.U0)
    return jprob, (model, schedule, cfg, X, U), jac


def test_backoff_values_match_jax_and_compat_path(tiny):
    """backoff_values equals the JAX package's, and the port's constant
    back-off of the default stochastic mode (same gates, same
    sqrt(K Sigma K') term)."""
    _, (model, schedule, cfg, X, U), (jb, _, _) = tiny
    b = tst.backoff_values(model, schedule, cfg, X, U)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(jb), rtol=1e-12,
                               atol=1e-14)
    data = compute_trajectory_data(model, schedule, X, U)
    compat = tocp._chance_backoffs(model, cfg, data,
                                   tocp.rotated_pyramid(cfg, schedule))
    np.testing.assert_allclose(b.numpy(), compat.numpy(), rtol=1e-8,
                               atol=1e-12)
    assert float(b.max()) > 1e-6


def test_backoff_jacobians_match_jax(tiny):
    """dB/dX and dB/dU through the covariance recursion and the DARE
    equal the JAX package's jacrev, within 1e-8 of their largest entry."""
    _, port, jac = tiny
    got = tst.backoff_jacobians(*port)
    for g, j in zip(got, jac):
        j = np.asarray(j)
        assert g.shape[1:] == j.shape
        np.testing.assert_allclose(g[0].numpy(), j, rtol=0,
                                   atol=1e-8 * np.abs(j).max())


def test_backoff_jacobian_matches_finite_differences(tiny):
    """The finite-difference check of tests/test_stochastic_exact.py on
    the most active back-off."""
    _, (model, schedule, cfg, X, U), _ = tiny
    b, dB_dX, dB_dU = tst.backoff_jacobians(model, schedule, cfg, X, U)
    idx = np.unravel_index(int(b.argmax()), b.shape)
    assert float(b[idx]) > 1e-6
    eps = 1e-6
    rng = np.random.default_rng(0)
    for _ in range(3):
        dX = torch.as_tensor(rng.normal(size=X.shape))
        dU = torch.as_tensor(rng.normal(size=U.shape))

        def f(t):
            return float(tst.backoff_values(model, schedule, cfg,
                                            X + t * dX, U + t * dU)[idx])
        fd = (f(eps) - f(-eps)) / (2 * eps)
        an = float((dB_dX[idx] * dX[0]).sum() + (dB_dU[idx] * dU[0]).sum())
        np.testing.assert_allclose(an, fd, rtol=2e-4, atol=1e-8)


def test_apply_exact_backoffs_matches_jax_and_solves(tiny):
    """The exact-mode QP (nominal build_qp + the back-off linearization)
    equals the JAX package's at 1e-12, solves with the dense solve_qp,
    and its solution meets the linearized chance constraint
    G u + b(zbar) + J (z - zbar) <= 5e-5 on every active row."""
    jprob, (model, schedule, cfg, X, U), _ = tiny
    r = w = 100.0
    jdata = jtraj(jprob.model, jprob.plan.schedule, jprob.X0, jprob.U0)
    jcfg_nom = jprob.ocp.replace(stochastic=False)
    jqp = jst.apply_exact_backoffs(
        jocp.build_qp(jprob.model, jprob.plan.schedule, jcfg_nom, jprob.X0,
                      jprob.U0, jdata, jnp.asarray(r), jnp.asarray(w)),
        jprob.model, jprob.plan.schedule, jprob.ocp, jprob.X0, jprob.U0)
    data = compute_trajectory_data(model, schedule, X, U)
    cfg_nom = dataclasses.replace(cfg, stochastic=False)
    qp_nom = tocp.build_qp(model, schedule, cfg_nom, X, U, data, r, w)
    A_nom = qp_nom.A.clone()
    qp = tst.apply_exact_backoffs(qp_nom, model, schedule, cfg, X, U)
    assert torch.equal(qp_nom.A, A_nom)        # the input is left as it is
    for f in ("P", "q", "A", "l", "u"):
        np.testing.assert_allclose(getattr(qp, f)[0].numpy(),
                                   np.asarray(getattr(jqp, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)

    sol = solve_qp(qp, QPSettings(eps_abs=1e-6, eps_rel=1e-6))
    assert bool(sol.converged[0])
    b, dB_dX, dB_dU = tst.backoff_jacobians(model, schedule, cfg, X, U)
    N, nx, nu = U.shape[1], 9, model.n_u
    z = sol.x[0]
    dz = torch.cat([z[:nx * (N + 1)] - X[0].reshape(-1),
                    z[nx * (N + 1):nx * (N + 1) + nu * N] - U[0].reshape(-1)])
    J = torch.cat([dB_dX[0].reshape(N, 4, 5, -1),
                   dB_dU[0].reshape(N, 4, 5, -1)], -1)
    U_sol = z[nx * (N + 1):nx * (N + 1) + nu * N].reshape(N, 4, 3)
    lin = (torch.einsum("rj,kcj->kcr", cfg.pyramid[0], U_sol) + b[0]
           + J @ dz)
    active = (schedule.logic[1:, :, None] > 0).expand(N - 1, 4, 4)
    assert float(lin[1:, :, :4][active].max()) <= 5e-5


def test_dare_function_cpu_route_matches_autograd_of_plain():
    """lqr_gain on a CPU tensor: the values of lqr_gain_plain, and
    torch.func.jacrev and torch.autograd through it equal those through
    the plain version (no launch)."""
    rng = np.random.default_rng(4)
    A = torch.as_tensor(np.eye(9) + 0.05 * rng.standard_normal((3, 9, 9)))
    B = torch.as_tensor(0.05 * rng.standard_normal((3, 9, 6)))
    Q = torch.as_tensor(np.diag(rng.uniform(1, 10, 9)))
    R = torch.as_tensor(np.diag(rng.uniform(0.1, 1, 6)))
    before = dict(lqr_kernel.launches)
    for n_iter in (2, 5):
        torch.testing.assert_close(lqr_kernel.lqr_gain(Q, R, A, B, n_iter),
                                   lqr_kernel.lqr_gain_plain(Q, R, A, B,
                                                             n_iter),
                                   rtol=0, atol=0)
        got = torch.func.jacrev(lqr_kernel.lqr_gain, argnums=(0, 1, 2, 3))(
            Q, R, A, B, n_iter)
        ref = torch.func.jacrev(lqr_kernel.lqr_gain_plain,
                                argnums=(0, 1, 2, 3))(Q, R, A, B, n_iter)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-14)
        a = A.clone().requires_grad_()
        w = torch.as_tensor(rng.standard_normal((3, 6, 9)))
        (g,) = torch.autograd.grad((lqr_kernel.lqr_gain(Q, R, a, B, n_iter)
                                    * w).sum(), a)
        (r,) = torch.autograd.grad((lqr_kernel.lqr_gain_plain(
            Q, R, a, B, n_iter) * w).sum(), a)
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-14)
    assert lqr_kernel.launches == before
