"""The port's closed-loop evaluation against the JAX package's, float64
on the CPU: the chained rollout (models/centroidal.rollout), the
Monte-Carlo push rollouts with LQR feedback (sim/monte_carlo.py) on the
same forces, starts and push length, and the metrics (sim/metrics.py);
and the port's disturbance sampler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.models import centroidal as jcentroidal
from centroidal_mpc_tpu.sim import metrics as jmetrics
from centroidal_mpc_tpu.sim import monte_carlo as jmc
from centroidal_mpc_tpu_torch.models import centroidal as tcentroidal
from centroidal_mpc_tpu_torch.sim import metrics as tmetrics
from centroidal_mpc_tpu_torch.sim import monte_carlo as tmc

from torch_parity_util import jax_trajectory_data, port_problem

TOL = 1e-10
N_SIMS = 16


@pytest.fixture(scope="module")
def plan():
    """solo12_trot_n50 in both packages, with the plan (X, U) its warm
    start and K the LQR gains of its linearization there."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_N50,
                                   dtype=jnp.float64)
    X, U = np.array(jprob.X0), np.array(jprob.U0)
    K = np.array(jax_trajectory_data(jprob.model, jprob.plan.schedule,
                                       X[None], U[None], 2, False).K[0])
    model, schedule, ocp, _, _, _ = port_problem(jprob)
    return jprob, (model, schedule, ocp), X, U, K


def _pushes(horizon, seed=3):
    """The same pushes for both packages: forces sqrt(15) N(0, 1), start
    knots in [0, N - len), len 20 knots (200 ms at dt 0.01)."""
    rng = np.random.default_rng(seed)
    forces = np.sqrt(tmc.FORCE_COV) * rng.standard_normal((N_SIMS, 3))
    length = 20
    starts = rng.integers(0, horizon - length, N_SIMS)
    return forces, starts, length


def test_rollout_matches_jax(plan):
    jprob, (model, schedule, _), X, U, _ = plan
    rng = np.random.default_rng(0)
    x0 = X[0] + 1e-2 * rng.standard_normal((3, 9))
    Ub = U + 0.5 * rng.standard_normal((3,) + U.shape)
    jX = jax.vmap(jcentroidal.rollout, in_axes=(None, None, 0, 0))(
        jprob.model, jprob.plan.schedule, x0, Ub)
    tX = tcentroidal.rollout(model, schedule, torch.as_tensor(x0),
                             torch.as_tensor(Ub))
    assert tX.shape == (3, U.shape[0] + 1, 9)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=TOL,
                               atol=TOL)


def _jax_rollouts(jprob, X, U, K, forces, starts, length):
    roll = jax.vmap(jmc.closed_loop_rollout,
                    in_axes=(None,) * 6 + (0, 0, None))
    return roll(jprob.model, jprob.plan.schedule, X, U, K, X[0], forces,
                jnp.asarray(starts), length)


def test_closed_loop_rollout_matches_jax(plan):
    jprob, (model, schedule, _), X, U, K = plan
    forces, starts, length = _pushes(U.shape[0])
    jX, jU = _jax_rollouts(jprob, X, U, K, forces, starts, length)
    x0 = torch.as_tensor(X[0]).expand(N_SIMS, 9)
    tX, tU = tmc.closed_loop_rollout(
        model, schedule, torch.as_tensor(X), torch.as_tensor(U),
        torch.as_tensor(K), x0, torch.as_tensor(forces),
        torch.as_tensor(starts), length)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=TOL,
                               atol=TOL)
    # the pushes move the y momentum away from the plan
    assert np.abs(tX.numpy()[:, :, 4] - X[:, 4]).max() > 1e-2


def test_run_monte_carlo_matches_jax_rollouts(plan):
    """run_monte_carlo draws from a seeded generator and rolls every sim
    at once; the JAX rollouts of its draws agree."""
    jprob, (model, schedule, _), X, U, K = plan
    res = tmc.run_monte_carlo(model, schedule, torch.as_tensor(X),
                              torch.as_tensor(U), torch.as_tensor(K),
                              torch.Generator().manual_seed(0), N_SIMS)
    assert res.X_sim.shape == (N_SIMS, U.shape[0] + 1, 9)
    assert res.U_sim.shape == (N_SIMS, U.shape[0], 12)
    jX, jU = _jax_rollouts(jprob, X, U, K, res.push_force.numpy(),
                           res.push_start.numpy(), 20)
    np.testing.assert_allclose(res.X_sim.numpy(), np.asarray(jX), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(res.U_sim.numpy(), np.asarray(jU), rtol=TOL,
                               atol=TOL)


def test_metrics_match_jax(plan):
    jprob, (model, schedule, ocp), X, U, K = plan
    forces, starts, length = _pushes(U.shape[0], seed=5)
    jX, jU = _jax_rollouts(jprob, X, U, K, forces, starts, length)
    tX, tU = torch.tensor(np.asarray(jX)), torch.tensor(np.asarray(jU))
    jc = jmetrics.cumulative_tracking_cost(jprob.model.Q, jX, X)
    tc = tmetrics.cumulative_tracking_cost(model.Q, tX, torch.as_tensor(X))
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    # the rollouts' forces stay inside the pyramid; N(0, 1) N of noise on
    # the plan's forces leaves it, and zero forces at the first five
    # knots sit on every row (saturations)
    noisy = tU + torch.as_tensor(np.random.default_rng(6).standard_normal(
        tuple(tU.shape)))
    zeroed = tU.clone()
    zeroed[:, :5] = 0.0
    stats = []
    for Uf in (tU, noisy, zeroed):
        jf = jmetrics.friction_cone_stats(jprob.ocp.pyramid,
                                          jprob.plan.schedule, Uf.numpy())
        tf = tmetrics.friction_cone_stats(ocp.pyramid, schedule, Uf)
        assert set(tf) == set(jf)
        for k in jf:
            np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]),
                                          err_msg=k)
        np.testing.assert_allclose(
            tmetrics.tangential_ratio(schedule, Uf).numpy(),
            np.asarray(jmetrics.tangential_ratio(jprob.plan.schedule,
                                                 Uf.numpy())),
            rtol=TOL, atol=TOL, equal_nan=True)
        stats.append(tf)
    assert (stats[1]["violations"] > 0).all()
    assert (stats[2]["saturations"] > 0).all()


def test_sample_disturbances():
    """Same seed, same draws; starts in [0, N - len); the force std within
    5% of sqrt(15) over 4096 draws; 200 ms is 20 knots at dt 0.01."""
    def draw(seed, n=4096):
        return tmc.sample_disturbances(torch.Generator().manual_seed(seed),
                                       n, 50, 0.01, torch.float64)

    forces, starts, length = draw(0)
    again = draw(0)
    assert length == again[2] == 20
    assert torch.equal(forces, again[0]) and torch.equal(starts, again[1])
    assert not torch.equal(forces, draw(1)[0])
    assert forces.shape == (4096, 3) and forces.dtype == torch.float64
    assert int(starts.min()) >= 0 and int(starts.max()) < 50 - 20
    std = float(forces.std())
    assert abs(std - np.sqrt(tmc.FORCE_COV)) < 0.05 * np.sqrt(tmc.FORCE_COV)
    assert abs(float(forces.mean())) < 0.2
    # a push longer than the plan still starts at knot 0
    assert int(tmc.sample_disturbances(torch.Generator().manual_seed(0), 8,
                                       10, 0.01)[1].max()) == 0
