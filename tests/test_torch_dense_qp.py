"""The port's dense reference-layout QP path (solver/ocp.build_qp and
ops/admm.solve_qp) against the JAX package in float64 on the CPU: the
assembled matrices, the Ruiz scaling, batched solves at matched
iteration counts, the infeasibility certificates and the closed-form
cases of tests/test_admm.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.ops import admm as jadmm
from centroidal_mpc_tpu.solver import ocp as jocp
from centroidal_mpc_tpu_torch import convert
from centroidal_mpc_tpu_torch.models.centroidal import TrajectoryData
from centroidal_mpc_tpu_torch.ops import admm as tadmm
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.solver import ocp as tocp

from torch_parity_util import (jax_trajectory_data, np_fields,
                               perturbed_batch, port_problem,
                               qp_settings_pair, talos_short)

RADIUS = np.array([100.0, 60.0])
WEIGHT = np.array([50.0, 80.0])


def _dense_pair(jprob, terminal_equality=True):
    """JAX (vmapped) and port dense QPs of a perturbed B=2 batch, both
    built from the JAX package's linearization of it, with per-lane
    radius and weight."""
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, 2, seed=3, scale=1e-3)
    jocfg = jprob.ocp.replace(terminal_equality=terminal_equality)
    jcfg = jax.vmap(lambda x: jocfg.replace(
        x_init=x[0], x_final=x[-1], X_track=x))(Xb)
    jdata = jax_trajectory_data(jprob.model, jprob.plan.schedule, Xb, Ub,
                                2, jprob.ocp.stochastic)
    jqp = jax.jit(jax.vmap(
        lambda c, x, u, d, r, w: jocp.build_qp(
            jprob.model, jprob.plan.schedule, c, x, u, d, r, w)))(
        jcfg, Xb, Ub, jdata, RADIUS, WEIGHT)
    model, schedule, ocp, *_ = port_problem(jprob)
    ocp = dataclasses.replace(ocp, terminal_equality=terminal_equality)
    X, U = torch.as_tensor(Xb), torch.as_tensor(Ub)
    cfg = tile_ocp_config(ocp, X[:, 0], X[:, -1], X)
    tdata = convert.from_numpy(TrajectoryData, np_fields(jdata), "cpu")
    tqp = tocp.build_qp(model, schedule, cfg, X, U, tdata,
                        torch.as_tensor(RADIUS), torch.as_tensor(WEIGHT))
    return jqp, tqp


def _mini(stochastic=False):
    return jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                  stochastic=stochastic, dtype=jnp.float64)


@pytest.fixture(scope="module")
def mini_pair():
    return _dense_pair(_mini())


@pytest.mark.parametrize("case", ["nominal", "stochastic", "wrench6",
                                  "free_terminal"])
def test_build_qp_matches_jax(case, mini_pair):
    """P, q, A, l, u of every lane equal the JAX package's, rtol and atol
    1e-12: the point3 trot, its chance-constrained form (back-offs on the
    friction bounds), talos (wrench6: CoP rows, forces at columns 2:5)
    and the MPC window's free terminal state."""
    if case == "nominal":
        jqp, tqp = mini_pair
    elif case == "stochastic":
        jqp, tqp = _dense_pair(_mini(stochastic=True))
        assert float(tqp.u[:, tqp.u[0] < 0].abs().max()) > 0
    elif case == "wrench6":
        jqp, tqp = _dense_pair(jpresets.build_problem(talos_short(),
                                                      dtype=jnp.float64))
    else:
        jqp, tqp = _dense_pair(_mini(), terminal_equality=False)
    for f in ("P", "q", "A", "l", "u"):
        np.testing.assert_allclose(getattr(tqp, f).numpy(),
                                   np.asarray(getattr(jqp, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)


def test_ruiz_equilibrate_matches_jax(mini_pair):
    jqp, tqp = mini_pair
    jout = jax.jit(jax.vmap(lambda q: jadmm.ruiz_equilibrate(q, 10)))(jqp)
    tout = tadmm.ruiz_equilibrate(tqp, 10)
    for f in ("P", "q", "A", "l", "u"):
        np.testing.assert_allclose(getattr(tout[0], f).numpy(),
                                   np.asarray(getattr(jout[0], f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)


SOLVE_CASES = {
    "fixed_rho": dict(adaptive_rho=False),
    "cond_rho": dict(adaptive_rho=True, adaptive_rho_mode="cond"),
    "warm": dict(adaptive_rho=True, adaptive_rho_mode="cond"),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_qp_matches_jax(case, mini_pair):
    """Two lanes through the JAX package's vmapped solve_qp and through
    the port: equal iterations and statuses per lane, x and y within 1e-8
    of their scale (f64 round-off carried through the iterations).  The
    warm case starts both from 0.9 times a fixed-rho solution."""
    jqp, tqp = mini_pair
    jset, tset = qp_settings_pair(eps_abs=1e-6, eps_rel=1e-6, max_iter=3000,
                                  **SOLVE_CASES[case])
    x0 = y0 = None
    if case == "warm":
        cold = tadmm.solve_qp(tqp, dataclasses.replace(tset,
                                                       adaptive_rho=False))
        x0, y0 = 0.9 * cold.x, 0.9 * cold.y
    jsol = jax.jit(jax.vmap(lambda q, x, y: jadmm.solve_qp(q, jset, x, y)))(
        jqp, None if x0 is None else x0.numpy(),
        None if y0 is None else y0.numpy())
    tsol = tadmm.solve_qp(tqp, tset, x0, y0)
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    assert bool(tsol.converged.all())
    if case == "cond_rho":
        assert int(tsol.refactors.min()) > 0
    for f in ("x", "y", "z"):
        ref = np.asarray(getattr(jsol, f))
        np.testing.assert_allclose(getattr(tsol, f).numpy(), ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max(), err_msg=f)


def _qp(P, q, A, l, u):
    """A B=1 port QPData from numpy arrays."""
    return tocp.QPData(*(torch.as_tensor(np.asarray(a, np.float64))[None]
                         for a in (P, q, A, l, u)))


INFEASIBLE = {
    # x <= 0 and x >= 1 cannot both hold
    "primal": (np.eye(1), np.zeros(1), [[1.0], [1.0]], [-tocp.INF, 1.0],
               [0.0, tocp.INF], tadmm.STATUS_PRIMAL_INFEASIBLE),
    # min -x s.t. x >= 0 is unbounded below
    "dual": (np.zeros((1, 1)), [-1.0], [[1.0]], [0.0], [tocp.INF],
             tadmm.STATUS_DUAL_INFEASIBLE),
}


@pytest.mark.parametrize("case", list(INFEASIBLE))
def test_infeasible_qp_certified_at_jax_iteration(case):
    """The dense QPs of tests/test_infeasibility.py: the same certificate
    status at the same iteration as the JAX package, well under
    max_iter."""
    *arrays, status = INFEASIBLE[case]
    jset, tset = qp_settings_pair(max_iter=4000, eps_abs=1e-6, eps_rel=1e-6)
    jsol = jadmm.solve_qp(jocp.QPData(*(jnp.asarray(np.asarray(a, float))
                                        for a in arrays)), jset)
    tsol = tadmm.solve_qp(_qp(*arrays), tset)
    assert int(tsol.status[0]) == int(jsol.status) == status
    assert int(tsol.iterations[0]) == int(jsol.iterations)
    assert int(tsol.iterations[0]) < tset.max_iter / 4
    assert not bool(tsol.converged[0])


def test_box_projection():
    """min |x - a|^2 s.t. l <= x <= u has solution clip(a, l, u)."""
    n = 8
    a = np.random.default_rng(0).normal(size=n) * 3
    lo, hi = -np.ones(n), np.ones(n)
    sol = tadmm.solve_qp(_qp(2 * np.eye(n), -2 * a, np.eye(n), lo, hi),
                         tadmm.QPSettings(eps_abs=1e-9, eps_rel=1e-9))
    assert bool(sol.converged[0])
    np.testing.assert_allclose(sol.x[0].numpy(), np.clip(a, lo, hi),
                               atol=1e-6)


def test_equality_constrained_matches_kkt_solve():
    """Equality-constrained QP vs the closed-form KKT solution."""
    rng = np.random.default_rng(1)
    n, m = 12, 5
    M = rng.normal(size=(n, n))
    P = M @ M.T + np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    K = np.block([[P, A.T], [A, np.zeros((m, m))]])
    exact = np.linalg.solve(K, np.concatenate([-q, b]))[:n]
    sol = tadmm.solve_qp(_qp(P, q, A, b, b),
                         tadmm.QPSettings(eps_abs=1e-10, eps_rel=1e-10))
    assert bool(sol.converged[0])
    np.testing.assert_allclose(sol.x[0].numpy(), exact, atol=1e-6)


def test_random_inequality_qp_kkt():
    """A random inequality QP meets the KKT conditions at the solution."""
    rng = np.random.default_rng(2)
    n, m = 20, 30
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    u = rng.uniform(0.5, 2.0, size=m)
    sol = tadmm.solve_qp(_qp(P, q, A, -np.full(m, tocp.INF), u),
                         tadmm.QPSettings(eps_abs=1e-9, eps_rel=1e-9))
    assert bool(sol.converged[0])
    x, y = sol.x[0].numpy(), sol.y[0].numpy()
    ax = A @ x
    assert np.abs(P @ x + q + A.T @ y).max() < 1e-6
    assert np.maximum(ax - u, 0).max() < 1e-7
    assert np.abs(np.where(y > 1e-6, ax - u, 0)).max() < 1e-5
