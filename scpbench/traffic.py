"""The traffic generator: scenario offsets drawn from the run's seed.

A frozen copy of the perturbation of `chip_smoke.scenarios` (itself the
JAX bench's, bench.py:239-257): a scenario is the plan's warm-start
trajectory with its CoM moved by `std` N(0, 1) metres along each axis in
`dims` (x and y), over every knot.  Lane 0 of a batch is left
unperturbed; every MPC episode is perturbed (an episode of the N=165
plan outlasts a run's window, so an unperturbed first one would leave
the seed nothing to change).  One generator is seeded once per run and
draws each batch or episode afresh, in order, so a seed gives the same
inputs every time.
"""
from __future__ import annotations

import numpy as np

N_X = 9


class Scenarios:
    """Offsets (n, nx) of successive batches or episodes."""

    def __init__(self, seed: int, std: float, dims=(0, 1)):
        self.rng = np.random.default_rng(int(seed) % 2**64)
        self.std, self.dims = float(std), list(dims)
        self.drawn = 0

    def draw(self, n: int, zero_first: bool) -> np.ndarray:
        """The next n offsets; the first is zero when zero_first."""
        dx = np.zeros((n, N_X))
        dx[:, self.dims] = self.std * self.rng.standard_normal(
            (n, len(self.dims)))
        if zero_first:
            dx[0] = 0.0
        self.drawn += 1
        return dx
