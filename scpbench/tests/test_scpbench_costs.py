"""The frozen yardstick equals the program's cost functions today."""
import pytest

from scpbench_mini import REPO  # noqa: F401
from scpbench import costs
from centroidal_mpc_tpu_torch.ops import block_tridiag


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
