"""The iLQR / FDDP solver of the PyTorch port (solver/ddp.py) and its
centroidal warm start (solver/warm_start.ddp_warm_start) against the JAX
package's, float64 on the CPU: tests/test_ddp.py's LQR and nonlinear
problems, a Gauss-Newton FDDP solve from a state trajectory that is not a
rollout, a line search whose long steps give NaN costs, and the warm
start on solo12_trot_n50, each at equal iteration counts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_util
from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.solver import ddp as jddp
from centroidal_mpc_tpu.solver.warm_start import ddp_warm_start as j_warm
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.models.centroidal import rollout
from centroidal_mpc_tpu_torch.solver import ddp as tddp
from centroidal_mpc_tpu_torch.solver.warm_start import (
    ddp_warm_start, ddp_warm_start_solution)

TOL = 1e-9
WARM_TOL = 1e-8
DT = 0.05


def assert_same(jsol, tsol, tol=TOL):
    assert tsol.iterations == int(jsol.iterations)
    np.testing.assert_allclose(tsol.X.numpy(), np.asarray(jsol.X), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(tsol.U.numpy(), np.asarray(jsol.U), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(float(tsol.cost), float(jsol.cost),
                               rtol=1e-10)
    assert bool(tsol.improved) == bool(jsol.improved)


def lqr_problem():
    """tests/test_ddp.py:12-27."""
    nx, nu, N = 4, 2, 30
    rng = np.random.default_rng(0)
    A = np.eye(nx) + 0.1 * rng.normal(size=(nx, nx))
    B = 0.1 * rng.normal(size=(nx, nu))
    Q = np.diag([1.0, 2.0, 0.5, 1.0])
    R = np.diag([0.1, 0.2])
    return A, B, Q, R, 10.0 * Q, rng.normal(size=nx), N, nu


@pytest.mark.parametrize("exact_quu", [False, True])
def test_ilqr_on_lqr_matches_jax(exact_quu):
    A, B, Q, R, Qf, x0, N, nu = lqr_problem()
    settings = dict(iterations=3, exact_quu=exact_quu)
    ja, jb, jq, jr, jqf = map(jnp.asarray, (A, B, Q, R, Qf))
    jsol = jddp.solve_ilqr(
        lambda x, u, k: ja @ x + jb @ u,
        lambda x, u, k: 0.5 * (x @ jq @ x + u @ jr @ u),
        lambda x: 0.5 * x @ jqf @ x, jnp.asarray(x0), jnp.zeros((N, nu)),
        jddp.DdpSettings(**settings))
    ta, tb, tq, tr, tqf = map(torch.tensor, (A, B, Q, R, Qf))
    tsol = tddp.solve_ilqr(
        lambda x, u, k: ta @ x + tb @ u,
        lambda x, u, k: 0.5 * (x @ tq @ x + u @ tr @ u),
        lambda x: 0.5 * x @ tqf @ x, torch.tensor(x0),
        torch.zeros((N, nu), dtype=torch.float64),
        tddp.DdpSettings(**settings))
    assert_same(jsol, tsol)
    np.testing.assert_allclose(tsol.K.numpy(), np.asarray(jsol.K), rtol=0,
                               atol=TOL)


def _pendulum(xp):
    """tests/test_ddp.py:52-66 in either package's array module."""
    def dyn(x, u, k):
        th, w = x[0], x[1]
        return xp.stack([th + DT * w, w + DT * (xp.sin(th) + u[0])])

    def cost(x, u, k):
        return 0.01 * u[0] ** 2 + 0.1 * x[1] ** 2

    def term(x):
        return 100.0 * ((x[0] - np.pi) ** 2 + x[1] ** 2)
    return dyn, cost, term


def test_ilqr_on_pendulum_matches_jax():
    jsol = jddp.solve_ilqr(*_pendulum(jnp), jnp.zeros(2), jnp.zeros((40, 1)),
                           jddp.DdpSettings(iterations=50))
    tsol = tddp.solve_ilqr(*_pendulum(torch),
                           torch.zeros(2, dtype=torch.float64),
                           torch.zeros((40, 1), dtype=torch.float64),
                           tddp.DdpSettings(iterations=50))
    assert tsol.iterations < 50      # stops on the regularization cap
    assert_same(jsol, tsol)


def _residual_pendulum(xp):
    """The pendulum as least squares: residuals of the same costs, with a
    time-varying target read through the knot index."""
    dyn, _, _ = _pendulum(xp)
    target = np.linspace(0.0, np.pi, 31)
    tgt = (jnp.asarray(target) if xp is jnp else torch.tensor(target))

    def at(k):
        return tgt[k] if xp is jnp else tddp.take(tgt, k)

    def stage(x, u, k):
        return xp.stack([0.1 * u[0], 0.3 * x[1], 0.5 * (x[0] - at(k))])

    def term(x):
        return xp.stack([10.0 * (x[0] - np.pi), 10.0 * x[1]])
    return dyn, stage, term


@pytest.mark.parametrize("fddp", [False, True])
def test_gauss_newton_ilqr_matches_jax(fddp):
    """solve_ilqr_residual, pure iLQR and FDDP: in FDDP mode from a state
    path (a straight line to the top) that is not a rollout of U0, so
    the gaps, the merit and its mu are on the path."""
    N = 30
    X_init = np.zeros((N + 1, 2))
    X_init[:, 0] = np.linspace(0.0, np.pi, N + 1)
    U0 = 0.1 * np.ones((N, 1))
    settings = dict(iterations=40, exact_quu=True)
    jsol = jddp.solve_ilqr_residual(
        *_residual_pendulum(jnp), jnp.zeros(2), jnp.asarray(U0),
        jddp.DdpSettings(**settings),
        X_init=jnp.asarray(X_init) if fddp else None)
    tsol = tddp.solve_ilqr_residual(
        *_residual_pendulum(torch), torch.zeros(2, dtype=torch.float64),
        torch.tensor(U0), tddp.DdpSettings(**settings),
        X_init=torch.tensor(X_init) if fddp else None)
    assert tsol.iterations > 2
    assert_same(jsol, tsol)


def test_nan_costs_lose_the_line_search_as_in_jax():
    """A barrier cost sqrt(1.5 - x) that is NaN past x = 1.5 and a
    terminal pull to x = 1.6: the long steps give NaN merits, which both
    packages map to inf."""
    def problem(xp):
        def dyn(x, u, k):
            return x + 0.1 * u

        def cost(x, u, k):
            return 1e-3 * u[0] ** 2 + 1e-2 * xp.sqrt(1.5 - x[0])

        def term(x):
            return 50.0 * (x[0] - 1.6) ** 2
        return dyn, cost, term

    jsol = jddp.solve_ilqr(*problem(jnp), jnp.zeros(1), jnp.zeros((20, 1)),
                           jddp.DdpSettings(iterations=30))
    tsol = tddp.solve_ilqr(*problem(torch),
                           torch.zeros(1, dtype=torch.float64),
                           torch.zeros((20, 1), dtype=torch.float64),
                           tddp.DdpSettings(iterations=30))
    assert np.isfinite(float(tsol.cost)) and float(tsol.X[-1, 0]) < 1.5
    assert_same(jsol, tsol)


@pytest.fixture(scope="module")
def warm_pair():
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_N50,
                                   dtype=jnp.float64)
    jX, jU = j_warm(jprob.model, jprob.plan.schedule, jprob.preset.robot)
    tprob = tpresets.build_problem(tpresets.SOLO12_TROT_N50,
                                   dtype=torch.float64, device="cpu")
    return jX, jU, tprob


def test_ddp_warm_start_matches_jax(warm_pair):
    jX, jU, tprob = warm_pair
    sol = ddp_warm_start_solution(tprob.model, tprob.plan.schedule,
                                  tprob.preset.robot)
    ref = np.load(torch_parity_util.PIPELINE_REF)
    assert sol.iterations == int(ref["warm_iterations"])
    np.testing.assert_allclose(sol.X.numpy(), jX, rtol=0, atol=WARM_TOL)
    np.testing.assert_allclose(sol.U.numpy(), jU, rtol=0, atol=WARM_TOL)
    X, U = ddp_warm_start(tprob.model, tprob.plan.schedule,
                          tprob.preset.robot)
    assert torch.equal(X, sol.X) and torch.equal(U, sol.U)
    assert X.device.type == "cpu" and X.dtype == torch.float64


def test_ddp_warm_start_is_dynamically_consistent(warm_pair):
    """tests/test_ddp.py:70-79 on the port: X is the rollout of U, and the
    CoM advances by about nb_steps * step_length."""
    _, _, tprob = warm_pair
    X, U = ddp_warm_start(tprob.model, tprob.plan.schedule,
                          tprob.preset.robot)
    X_roll = rollout(tprob.model, tprob.plan.schedule, X[0], U)
    np.testing.assert_allclose(X.numpy(), X_roll.numpy(), atol=1e-9)
    gait = tprob.preset.gait
    assert abs(float(X[-1, 0]) - gait.nb_steps * gait.step_length) < 0.08
