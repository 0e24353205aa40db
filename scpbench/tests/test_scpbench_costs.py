"""The frozen yardstick equals the program's cost functions today, and
the readers of the kernels' rooflines and of the factor calls use it."""
import pytest

from scpbench_mini import BENCH, REPO  # noqa: F401
from scpbench import costs, harness
from centroidal_mpc_tpu_torch.ops import block_tridiag, lqr_kernel


@pytest.mark.parametrize("shape", [(128, 51, 22), (128, 123, 16),
                                   (1024, 51, 22), (1, 21, 22)])
def test_costs_equal_the_programs(shape):
    for frozen, program in ((costs.sweep_cost, block_tridiag.sweep_cost),
                            (costs.factor_cost, block_tridiag.factor_cost)):
        f, p = frozen(*shape), program(*shape)
        assert (f.bytes, f.flops) == (p.bytes, p.flops)


def test_bound_picks_the_larger():
    t, by = costs.bound_s(costs.sweep_cost(128, 51, 22))
    assert by == "bytes" and t == pytest.approx(
        costs.sweep_cost(128, 51, 22).bytes / costs.PEAK_BYTES)
    t, by = costs.bound_s(costs.Cost(bytes=1, flops=10**12))
    assert by == "operations" and t == pytest.approx(1e12 / 67e12)


# (S = B N, nx, nu, DARE steps) of the batch cells: trot N=165 at B=128
# and B=1024, bolt N=122 at B=128, the chance-constrained trot's 30 steps
@pytest.mark.parametrize("shape", [(128 * 165, 9, 12, 2),
                                   (1024 * 165, 9, 12, 2),
                                   (128 * 122, 9, 6, 2),
                                   (128 * 165, 9, 12, 30)])
def test_dare_cost_equals_the_programs(shape):
    f, p = costs.lqr_cost(*shape), lqr_kernel.lqr_cost(*shape)
    assert (f.bytes, f.flops) == (p.bytes, p.flops)


def _record(**counts):
    """A traced batch of the chance-constrained configuration's shape
    (B=128, N=165, nu 12, 30 DARE steps) that spent 1 ms in each
    kernel."""
    ms = 1_000_000
    return dict(mode="batch", batch=128, n1=166, V=22, nu=12, lqr_iters=30,
                units=2, qp=[], counts=counts,
                device_ops=[("void dare_lqr_kernel<float, 9, 12>", 0, ms),
                            ("tridiag_factor_chain_kernel", ms, ms)])


def test_dare_roofline_reader():
    reader = harness.load_metric("dare_roofline.batch", BENCH)
    rec = _record(dare_lqr=2, tridiag_factor=10)
    bound = 2 * costs.bound_s(costs.lqr_cost(128 * 165, 9, 12, 30))[0]
    assert reader.read(rec) == pytest.approx(100.0 * bound / 1e-3)
    assert 0.0 < reader.read(rec) < 100.0
    # nothing to read: no launch counted (the CPU), no kernel traced
    assert reader.read(_record(tridiag_factor=10)) is None
    assert reader.read(dict(rec, device_ops=rec["device_ops"][1:])) is None


def test_factor_calls_reader():
    reader = harness.load_metric("factor_calls_per_batch.batch", BENCH)
    assert reader.read(_record(dare_lqr=2, tridiag_factor=10)) == 5.0
    assert reader.read(_record(dare_lqr=2)) is None
