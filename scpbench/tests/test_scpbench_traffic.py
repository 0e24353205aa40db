"""The traffic generator: the same seed gives the same inputs."""
import numpy as np

from scpbench_mini import REPO  # noqa: F401
from scpbench.traffic import Scenarios


def test_same_seed_same_inputs_large_seed():
    seed = 2**31 + 12345
    a, b = Scenarios(seed, 0.005), Scenarios(seed, 0.005)
    for _ in range(3):
        np.testing.assert_array_equal(a.draw(128, True), b.draw(128, True))
    c = Scenarios(seed + 1, 0.005)
    assert not np.array_equal(Scenarios(seed, 0.005).draw(8, True),
                              c.draw(8, True))


def test_offsets_only_on_com_xy_first_unperturbed():
    dx = Scenarios(7, 0.005).draw(4096, zero_first=True)
    assert dx.shape == (4096, 9)
    assert np.all(dx[0] == 0.0)
    assert np.all(dx[:, 2:] == 0.0)
    assert abs(dx[1:, :2].std() - 0.005) < 2e-4
    gen = Scenarios(7, 0.005)
    first, second = gen.draw(1, False), gen.draw(1, False)
    assert np.any(first != 0.0) and not np.array_equal(first, second)
