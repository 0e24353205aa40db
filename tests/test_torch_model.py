"""Problem construction, linearization and LQR gains of the PyTorch port
against the JAX package (float64 unless stated)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.models import centroidal as jcm
from centroidal_mpc_tpu.ops.pallas_lqr import lqr_gain_batched as jlqr_kernel
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.models import centroidal as tcm
from centroidal_mpc_tpu_torch.ops import lqr_kernel

from torch_parity_util import np_fields, port_problem


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["solo12_trot_n50", "solo12_trot_mini"])
def test_build_problem_matches_jax(name, dtype):
    """(b) The port's build_problem equals the JAX one leaf by leaf:
    schedule, model, OcpConfig, X0/U0 and settings (exact: both are the
    same numpy arithmetic, rounded once to the dtype)."""
    jp = jpresets.build_problem(jpresets.PRESETS[name],
                                dtype=getattr(jnp, dtype))
    tp = tpresets.build_problem(tpresets.PRESETS[name],
                                dtype=getattr(torch, dtype), device="cpu")
    pairs = [(jp.plan.schedule, tp.plan.schedule), (jp.model, tp.model),
             (jp.ocp, tp.ocp)]
    for jobj, tobj in pairs:
        for k, v in np_fields(jobj).items():
            tv = getattr(tobj, k)
            if isinstance(v, np.ndarray):
                assert tv.dtype == getattr(torch, dtype), k
                np.testing.assert_array_equal(tv.numpy(), v, err_msg=k)
            else:
                assert tv == v, k
    np.testing.assert_array_equal(tp.X0.numpy(), np.asarray(jp.X0))
    np.testing.assert_array_equal(tp.U0.numpy(), np.asarray(jp.U0))
    assert dataclasses.asdict(tp.scp) == dataclasses.asdict(jp.scp)
    assert dataclasses.asdict(tp.preset.gait) == dataclasses.asdict(
        jp.preset.gait)
    assert tp.plan.horizon == jp.plan.horizon
    assert [p.name for p in tp.plan.phases] == [p.name
                                                for p in jp.plan.phases]


def _random_trajectory(jprob, seed):
    rng = np.random.default_rng(seed)
    X = np.asarray(jprob.X0) + 0.01 * rng.standard_normal(jprob.X0.shape)
    U = np.asarray(jprob.U0) + 0.1 * rng.standard_normal(jprob.U0.shape)
    return X, U


@pytest.mark.parametrize("name", ["solo12_trot_mini", "talos_pace"])
def test_linearize_step_matches_jax(name):
    """(c) Closed-form (f, A, B, C) equal the JAX ones at rtol 1e-12
    (same formulas, summation order may differ), for a point3 and a
    wrench6 robot."""
    jprob = jpresets.build_problem(jpresets.PRESETS[name], dtype=jnp.float64)
    model, schedule, *_ = port_problem(jprob)
    X, U = _random_trajectory(jprob, seed=1)
    sched = jprob.plan.schedule
    pos = np.asarray(sched.position)
    jout = jax.vmap(jcm.linearize_step, in_axes=(None, 0, 0, 0, 0, 0))(
        jprob.model, X[:-1], U, pos, sched.logic, sched.orientation)
    tout = tcm.linearize_step(model, torch.as_tensor(X[:-1]),
                              torch.as_tensor(U), schedule.position,
                              schedule.logic, schedule.orientation)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-12)


def test_linearize_step_matches_jacfwd():
    """(c) The closed form equals torch.func.jacfwd of dynamics_step at
    one knot (round-off: 1e-12)."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   dtype=jnp.float64)
    model, schedule, *_ = port_problem(jprob)
    X, U = _random_trajectory(jprob, seed=2)
    k = 3
    x, u = torch.as_tensor(X[k]), torch.as_tensor(U[k])
    pos, logic, rot = (schedule.position[k], schedule.logic[k],
                       schedule.orientation[k])
    _, A, B, C = tcm.linearize_step(model, x, u, pos, logic, rot)
    jac = torch.func.jacfwd(
        lambda x_, u_, p_: tcm.dynamics_step(model, x_, u_, p_, logic, rot),
        argnums=(0, 1, 2))(x, u, pos)
    torch.testing.assert_close(A, jac[0], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(B, jac[1], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(C, jac[2].reshape(9, -1), rtol=1e-12,
                               atol=1e-12)


def test_compute_trajectory_data_matches_jax():
    """(c) Batched compute_trajectory_data: f, A, B, C equal the JAX
    package's (vmapped over scenarios) at rtol 1e-12; K is checked
    in the LQR tests below."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   dtype=jnp.float64)
    model, schedule, *_ = port_problem(jprob)
    X1, U1 = _random_trajectory(jprob, seed=3)
    X2, U2 = _random_trajectory(jprob, seed=4)
    X, U = np.stack([X1, X2]), np.stack([U1, U2])
    jd = jax.vmap(lambda x, u: jcm.compute_trajectory_data(
        jprob.model, jprob.plan.schedule, x, u, with_covariance=False))(X, U)
    td = tcm.compute_trajectory_data(model, schedule, torch.as_tensor(X),
                                     torch.as_tensor(U),
                                     with_covariance=False)
    for k in ("f", "A", "B", "C", "Sigma"):
        np.testing.assert_allclose(getattr(td, k).numpy(),
                                   np.asarray(getattr(jd, k)), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    with pytest.raises(NotImplementedError):
        tcm.compute_trajectory_data(model, schedule, torch.as_tensor(X),
                                    torch.as_tensor(U))


def _real_AB(dtype, name="solo12_trot_n50"):
    jprob = jpresets.build_problem(jpresets.PRESETS[name], dtype=dtype)
    sched = jprob.plan.schedule
    _, A, B, _ = jax.vmap(jcm.linearize_step, in_axes=(None, 0, 0, 0, 0, 0))(
        jprob.model, jprob.X0[:-1], jprob.U0, sched.position, sched.logic,
        sched.orientation)
    return jprob.model, np.asarray(A), np.asarray(B)


@pytest.mark.parametrize("dtype,rtol", [
    # same Cholesky-inverse algorithm: f64 agrees to round-off
    ("float64", 1e-10),
    # f32: the tolerance tests/test_pallas_lqr.py uses for this kernel
    ("float32", 2e-5)])
def test_lqr_gain_plain_matches_pallas_kernel(dtype, rtol):
    """(d) The plain lqr_gain against the Pallas DARE kernel (interpret
    mode), |K - K_ref|inf < rtol * |K_ref|inf."""
    model, A, B = _real_AB(getattr(jnp, dtype))
    K_ref = np.asarray(jlqr_kernel(model.Q, model.R, A, B, n_iter=2,
                                   interpret=True))
    t = lambda a: torch.as_tensor(np.asarray(a))
    K = lqr_kernel.lqr_gain_plain(t(model.Q), t(model.R), t(A), t(B), 2)
    assert K.dtype == getattr(torch, dtype)
    scale = np.abs(K_ref).max()
    assert np.abs(K.numpy() - K_ref).max() < rtol * scale


@pytest.mark.parametrize("name,n_iter", [
    ("solo12_trot_n50", 2),    # the main path
    ("bolt_pace", 2),          # nu = 6
    ("solo12_trot_n50", 30)])  # the stochastic stage's steps
def test_lqr_gain_matches_newton_schulz_chain(name, n_iter):
    """(d) The port's lqr_gain (Cholesky inverse) against the JAX f64
    lqr_gain (Newton-Schulz inverse, 6 steps, the f64 path of
    compute_trajectory_data): 1e-9 relative -- Newton-Schulz on these
    cond ~1e2 (solo12) and ~50 (bolt) matrices converges to round-off
    well within 6 steps, and on the real linearization (A = I + dt J) the
    30-step recursion keeps the two chains' round-off from growing."""
    model, A, B = _real_AB(jnp.float64, name)
    K_ref = np.asarray(jax.vmap(jcm.lqr_gain, in_axes=(None, 0, 0, None))(
        model, A, B, n_iter))
    tmodel = port_problem(jpresets.build_problem(
        jpresets.PRESETS[name], dtype=jnp.float64))[0]
    K = tcm.lqr_gain(tmodel, torch.as_tensor(A), torch.as_tensor(B), n_iter)
    assert K.shape == K_ref.shape
    scale = np.abs(K_ref).max()
    assert np.abs(K.numpy() - K_ref).max() < 1e-9 * scale
