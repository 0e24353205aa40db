"""The port's copy of the native runtime bindings (runtime/native.py),
built from the repo's runtime/ sources into build/torch_runtime/: the
cases of tests/test_runtime_native.py, with the contact-plan expansion
checked against the port's own build_contact_plan."""
import threading
import time

import numpy as np
import pytest
import torch

from centroidal_mpc_tpu_torch.config import gaits
from centroidal_mpc_tpu_torch.config.robots import SOLO12, TALOS
from centroidal_mpc_tpu_torch.contact.plan import build_contact_plan
from centroidal_mpc_tpu_torch.runtime import native


@pytest.fixture(scope="module", autouse=True)
def built():
    path = native.build_library()
    assert path.exists() and "torch_runtime" in path.parts


@pytest.mark.parametrize("robot,gait,dt", [
    (SOLO12, gaits.SOLO12_TROT, 0.01),
    (SOLO12, gaits.SOLO12_PACE, 0.01),
    (SOLO12, gaits.SOLO12_BOUND, 0.01),
    (TALOS, gaits.TALOS_PACE, 0.03),
])
def test_native_expansion_matches_port(robot, gait, dt):
    plan = build_contact_plan(robot, gait, dt, dtype=torch.float64,
                              device="cpu")
    logic, pos, rot = native.expand_contact_plan(
        gait.gait_type, gait.step_length, gait.step_knots,
        gait.support_knots, gait.nb_steps, robot.stance_positions_array())
    np.testing.assert_array_equal(logic, plan.schedule.logic.numpy())
    np.testing.assert_allclose(pos, plan.schedule.position.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(rot, plan.schedule.orientation.numpy(),
                               atol=1e-12)


def test_native_expansion_rejects_bad_input():
    with pytest.raises(KeyError):
        native.expand_contact_plan("GALLOP", 0.1, 5, 5, 2, np.zeros((4, 3)))
    with pytest.raises(ValueError):
        native.expand_contact_plan("TROT", 0.1, 0, 5, 2, np.zeros((4, 3)))


def test_bus_sample_before_publish_returns_minus_one():
    bus = native.TrajectoryBus(horizon=10, nx=9, nu=12, dt=0.01)
    version, _, _, _ = bus.sample(0.0)
    assert version == -1
    bus.close()


def test_bus_interpolation_semantics():
    n, nx, nu, dt = 10, 3, 2, 0.01
    bus = native.TrajectoryBus(n, nx, nu, dt)
    X = np.arange((n + 1) * nx, dtype=np.float64).reshape(n + 1, nx)
    U = np.arange(n * nu, dtype=np.float64).reshape(n, nu)
    K = np.random.default_rng(0).normal(size=(n, nu, nx))
    bus.publish(1.0, X, U, K)
    # mid-knot: linear state interpolation, ZOH controls and gains
    v, x, u, k = bus.sample(1.0 + 2.5 * dt)
    assert v == 0
    np.testing.assert_allclose(x, 0.5 * (X[2] + X[3]), atol=1e-12)
    np.testing.assert_allclose(u, U[2], atol=1e-12)
    np.testing.assert_allclose(k, K[2], atol=1e-12)
    # clamping before t0 and beyond the horizon
    _, x0, _, _ = bus.sample(0.0)
    np.testing.assert_allclose(x0, X[0], atol=1e-12)
    _, xe, ue, _ = bus.sample(99.0)
    np.testing.assert_allclose(xe, X[-1], atol=1e-12)
    np.testing.assert_allclose(ue, U[-1], atol=1e-12)
    # republishing bumps the version
    bus.publish(2.0, X + 1.0, U, K)
    v2, x2, _, _ = bus.sample(2.0)
    assert v2 == 1
    np.testing.assert_allclose(x2, X[0] + 1.0, atol=1e-12)
    bus.close()


def test_bus_concurrent_publish_sample_consistency():
    """A reader never observes a torn plan while a writer spins: sampled
    states always belong to a single published plan (every component
    carries the plan's constant offset)."""
    n, nx, nu, dt = 20, 4, 2, 0.01
    bus = native.TrajectoryBus(n, nx, nu, dt)
    base_X = np.tile(np.arange(n + 1, dtype=np.float64)[:, None], (1, nx))
    U = np.zeros((n, nu))
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            bus.publish(0.0, base_X + 1000.0 * i, U + 1000.0 * i, None)
            i += 1

    def reader():
        while not stop.is_set():
            v, x, u, _ = bus.sample(0.5 * n * dt)
            if v < 0:
                continue
            knot_part = x - round(x[0] / 1000.0) * 1000.0
            if not (0.0 <= knot_part[0] <= n
                    and np.allclose(knot_part, knot_part[0], atol=1e-9)):
                errors.append(("torn state", x.copy()))
            if not np.allclose(u, u[0], atol=1e-9):
                errors.append(("torn control", u.copy()))

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not errors, errors[:3]
    bus.close()


def test_ticker_paces_and_reports_stats():
    tick = native.Ticker(period_s=0.002)
    t0 = time.perf_counter()
    for _ in range(50):
        assert tick.wait() >= 0
    elapsed = time.perf_counter() - t0
    stats = tick.stats()
    assert stats["ticks"] == 50
    assert elapsed >= 0.099     # 50 ticks at 2 ms cannot run faster
    assert stats["max_late_ns"] >= 0
    tick.close()
