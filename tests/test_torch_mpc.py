"""The receding-horizon MPC controller of the PyTorch port against the
JAX package's (solver/mpc.py), float64 on the CPU: the warm start, the
window slices, the shift and the tick clamp, then chained ticks of the
bench's MPC operating point (bench.py:449-462) at matched iteration
counts."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.solver import mpc as jmpc
from centroidal_mpc_tpu_torch import convert
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.solver import mpc as tmpc
from centroidal_mpc_tpu_torch.solver.scp import ScpSettings

from torch_parity_util import BENCH_QP, port_problem, qp_settings_pair

WINDOW = 20   # bench.py --mpc-window
# the tick's QP (bench.py:449-458): the bench point at eps 5e-4 without
# the polish, with 'cond' adaptive rho
TICK_QP = dict(BENCH_QP, polish=False, adaptive_rho=True,
               adaptive_rho_mode="cond")
# tests/test_mpc.py:29-33: fixed rho at eps 1e-5
FIXED_QP = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000,
                adaptive_rho=False)


def _controllers(qp_fields, **scp_fields):
    """(JAX problem, JAX controller, port controller, port X0 (1, N+1,
    nx), U0 (1, N, nu)) on solo12_trot_n50, window 20, free terminal
    state, block backend."""
    jqp, _ = qp_settings_pair(**qp_fields)
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_N50,
                                   dtype=jnp.float64, qp=jqp)
    jscp = dataclasses.replace(jprob.scp, qp_backend="block", **scp_fields)
    jctrl = jmpc.MpcController(
        model=jprob.model, schedule=jprob.plan.schedule,
        cfg=jprob.ocp.replace(terminal_equality=False), settings=jscp,
        window=WINDOW)
    model, schedule, ocp, _, X0, U0 = port_problem(jprob)
    X0, U0 = X0[None], U0[None]
    cfg = dataclasses.replace(tile_ocp_config(ocp, X0[:, 0], X0[:, -1], X0),
                              terminal_equality=False)
    tctrl = tmpc.MpcController(
        model=model, schedule=schedule, cfg=cfg,
        settings=convert.settings_from_dict(ScpSettings,
                                            dataclasses.asdict(jscp)),
        window=WINDOW)
    return jprob, jctrl, tctrl, X0, U0


@pytest.fixture(scope="module")
def tick():
    """The bench's tick settings and the one jitted JAX step the module
    shares."""
    jprob, jctrl, tctrl, X0, U0 = _controllers(
        TICK_QP, norm_method="power", max_iterations=1)
    return jprob, jctrl, jax.jit(jctrl.step), tctrl, X0, U0


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def test_init_state_and_max_tick(tick):
    jprob, jctrl, _, tctrl, X0, U0 = tick
    js = jctrl.init_state(jprob.X0, jprob.U0)
    ts = tctrl.init_state(X0, U0)
    assert tctrl.max_tick == jctrl.max_tick == 30
    assert ts.tick == int(js.tick) == 0
    assert ts.X_warm.shape == (1, WINDOW + 1, 9)
    assert ts.U_warm.shape == (1, WINDOW, 12)
    np.testing.assert_array_equal(_np(ts.X_warm[0]), _np(js.X_warm))
    np.testing.assert_array_equal(_np(ts.U_warm[0]), _np(js.U_warm))


@pytest.mark.parametrize("t", [0, 7, 30, 45])
def test_window_slices_match_jax(tick, t):
    """The window's schedule and tracking reference at tick t (45 is past
    max_tick: both clamp the start so the window fits), each a fresh
    tensor, not a view into the full plan."""
    _, jctrl, _, tctrl, _, _ = tick
    jsched, jtrack = jctrl._window_problem(jnp.asarray(t, jnp.int32))
    tsched, ttrack = tctrl._window_problem(t)
    for name in ("logic", "position", "orientation"):
        got = getattr(tsched, name)
        np.testing.assert_array_equal(_np(got), _np(getattr(jsched, name)))
        assert got._base is None and got.storage_offset() == 0, name
    assert ttrack.shape == (1, WINDOW + 1, 9)
    np.testing.assert_array_equal(_np(ttrack[0]), _np(jtrack))
    assert ttrack._base is None and ttrack.storage_offset() == 0


def test_step_plumbing_shift_and_clamp_match_jax(tick, monkeypatch):
    """step around a stand-in solve (the same affine map of the warm start
    in both packages), from two ticks before max_tick: the window problem
    and warm start handed to the solve, the shifted next warm start and
    the tick clamped at max_tick match the JAX controller's."""
    jprob, jctrl, _, tctrl, X0, U0 = tick
    seen = {"jax": [], "torch": []}

    def stand_in(key):
        def solve(model, sched, cfg, X, U, settings):
            seen[key].append((sched, cfg, X, U))
            return SimpleNamespace(X=1.5 * X + 0.25, U=0.5 * U - 1.0)
        return solve

    monkeypatch.setattr(jmpc, "solve_scp", stand_in("jax"))
    monkeypatch.setattr(tmpc, "solve_scp", stand_in("torch"))
    start = jctrl.max_tick - 2
    js = jctrl.init_state(jprob.X0, jprob.U0).replace(
        tick=jnp.asarray(start, jnp.int32))
    ts = dataclasses.replace(tctrl.init_state(X0, U0), tick=start)
    rng = np.random.default_rng(0)
    for i in range(4):
        x = np.asarray(jprob.X0[start + i]) + 1e-3 * rng.standard_normal(9)
        js, _ = jctrl.step(js, jnp.asarray(x))
        ts, _ = tctrl.step(ts, torch.as_tensor(x)[None])
        assert ts.tick == int(js.tick) == min(start + i + 1, jctrl.max_tick)
        np.testing.assert_array_equal(_np(ts.X_warm[0]), _np(js.X_warm))
        np.testing.assert_array_equal(_np(ts.U_warm[0]), _np(js.U_warm))
        (jsched, jcfg, jX, jU), (tsched, tcfg, tX, tU) = (seen["jax"][-1],
                                                          seen["torch"][-1])
        for name in ("logic", "position", "orientation"):
            np.testing.assert_array_equal(_np(getattr(tsched, name)),
                                          _np(getattr(jsched, name)))
        for name in ("x_init", "x_final", "X_track"):
            np.testing.assert_array_equal(_np(getattr(tcfg, name))[0],
                                          _np(getattr(jcfg, name)))
        assert not tcfg.terminal_equality
        np.testing.assert_array_equal(_np(tX[0]), _np(jX))
        np.testing.assert_array_equal(_np(tU[0]), _np(jU))
        np.testing.assert_array_equal(_np(tX[0, 0]), x)


def _chained_ticks(jprob, jctrl, jstep, tctrl, X0, U0, n_ticks, tol):
    """n_ticks chained ticks of both controllers, each carrying its own
    state; both measure JAX's sol.X[1] (the bench's perfect-tracking
    chain, bench.py:477-481).  Per tick: equal QP iterations, statuses
    and success, X/U within tol."""
    js = jctrl.init_state(jprob.X0, jprob.U0)
    ts = tctrl.init_state(X0, U0)
    x = np.array(jprob.X0[0])
    for i in range(n_ticks):
        js, jsol = jstep(js, jnp.asarray(x))
        ts, tsol = tctrl.step(ts, torch.as_tensor(x)[None])
        assert bool(jsol.success) and bool(tsol.success[0]), f"tick {i}"
        for k in ("qp_iterations", "qp_status", "iterations"):
            assert int(getattr(tsol, k)[0]) == int(getattr(jsol, k)), (i, k)
        for k in ("X", "U"):
            np.testing.assert_allclose(_np(getattr(tsol, k)[0]),
                                       _np(getattr(jsol, k)), rtol=tol,
                                       atol=tol, err_msg=f"tick {i} {k}")
        assert ts.tick == int(js.tick) == i + 1
        x = np.array(jsol.X[1])


def test_four_chained_ticks_match_jax(tick):
    """Four ticks at the bench's tick settings (eps 5e-4, no polish,
    'cond' rho, one SCP iteration, free terminal state, power trust
    norm), float64: X/U within 1e-8 (f64 round-off carried through the
    ADMM iterations)."""
    jprob, jctrl, jstep, tctrl, X0, U0 = tick
    _chained_ticks(jprob, jctrl, jstep, tctrl, X0, U0, 4, 1e-8)


@pytest.mark.slow
def test_four_chained_fixed_rho_ticks_match_jax():
    """The same at tests/test_mpc.py:29-33's settings: fixed rho at eps
    1e-5, the preset's SCP settings (exact SVD trust norm)."""
    jprob, jctrl, tctrl, X0, U0 = _controllers(FIXED_QP)
    _chained_ticks(jprob, jctrl, jax.jit(jctrl.step), tctrl, X0, U0, 4,
                   1e-8)


# ---------------------------------------------------------------------------
# closed loop on the port alone (tests/test_mpc.py:17-100): the full trot
# plan tracked from the port's own iLQR warm start
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def closed_loop():
    """tests/test_mpc.py:17-36 on the port: MPC over the full trot plan
    (solo12_trot, N=165), tracking the port's dynamically consistent
    ddp_warm_start, f64, fixed rho at eps 1e-5, block backend, free
    terminal state, window 20."""
    from centroidal_mpc_tpu_torch.config import presets as tpresets
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    from centroidal_mpc_tpu_torch.solver.warm_start import ddp_warm_start

    prob0 = tpresets.build_problem(tpresets.SOLO12_TROT, dtype=torch.float64,
                                   device="cpu")
    X_warm, U_warm = ddp_warm_start(prob0.model, prob0.plan.schedule,
                                    tpresets.SOLO12_TROT.robot)
    prob = tpresets.build_problem(tpresets.SOLO12_TROT, dtype=torch.float64,
                                  X_warm=X_warm, U_warm=U_warm, device="cpu")
    X0, U0 = prob.X0[None], prob.U0[None]
    cfg = dataclasses.replace(tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1],
                                              X0), terminal_equality=False)
    settings = dataclasses.replace(
        prob.scp, qp_backend="block",
        qp=QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000,
                      adaptive_rho=False))
    ctrl = tmpc.MpcController(model=prob.model, schedule=prob.plan.schedule,
                              cfg=cfg, settings=settings, window=WINDOW)
    return prob, ctrl, X0, U0


def _plant(prob, x, u, k):
    from centroidal_mpc_tpu_torch.models.centroidal import dynamics_step
    s = prob.plan.schedule
    return dynamics_step(prob.model, x, u, s.position[k], s.logic[k],
                         s.orientation[k])


def test_closed_loop_rolls_through_the_plan(closed_loop):
    """tests/test_mpc.py:39-57: 30 ticks, each solved, the first control
    applied through the true dynamics; the closed loop stays within 0.1
    of the reference path and no QP hits its iteration cap."""
    prob, ctrl, X0, U0 = closed_loop
    state = ctrl.init_state(X0, U0)
    x = prob.X0[0]
    qp_iters = []
    for i in range(30):
        state, sol = ctrl.step(state, x[None])
        assert bool(sol.success[0]), f"tick {i}"
        qp_iters.append(int(sol.qp_iterations[0]))
        x = _plant(prob, x, sol.U[0, 0], i)
    assert float(torch.linalg.norm(x - prob.ocp.X_track[30])) < 0.1
    assert max(qp_iters) < 4000


def test_closed_loop_rejects_a_disturbance(closed_loop):
    """tests/test_mpc.py:60-88: a lateral momentum kick of 0.3 at tick 8
    decays at the QP's optimal rate: visible (> 0.25), below 0.65 of its
    peak after 40 ticks, and monotone after it settles."""
    prob, ctrl, X0, U0 = closed_loop
    state = ctrl.init_state(X0, U0)
    x = prob.X0[0].clone()
    mom_err = []
    for i in range(40):
        if i == 8:
            x = x + torch.tensor([0, 0, 0, 0, 0.3, 0, 0, 0, 0],
                                 dtype=x.dtype)
        state, sol = ctrl.step(state, x[None])
        assert bool(sol.success[0])
        x = _plant(prob, x, sol.U[0, 0], i)
        mom_err.append(float((x[4] - prob.ocp.X_track[i + 1, 4]).abs()))
    peak = max(mom_err[8:12])
    assert peak > 0.25
    assert mom_err[-1] < 0.65 * peak
    tail = mom_err[12:]
    assert all(b <= a + 1e-6 for a, b in zip(tail, tail[1:]))


def test_closed_loop_tick_clamps_at_plan_end(closed_loop):
    """tests/test_mpc.py:91-97."""
    prob, ctrl, X0, U0 = closed_loop
    state = dataclasses.replace(ctrl.init_state(X0, U0), tick=ctrl.max_tick)
    new_state, sol = ctrl.step(state, X0[:, 0])
    assert new_state.tick == ctrl.max_tick
    assert bool(sol.success[0])
