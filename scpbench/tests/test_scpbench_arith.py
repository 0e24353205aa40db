"""The end-to-end arithmetic: over all the work and all the time."""
import statistics

import pytest

from scpbench_mini import REPO  # noqa: F401  (puts the repo on sys.path)
from scpbench import arith


def test_rate_is_over_the_whole_window():
    # ten batches of 128: nine of 0.3 s and one stall of 3 s
    times = [0.3] * 9 + [3.0]
    window = sum(times)
    assert arith.rate(128 * 10, window) == pytest.approx(1280 / 5.7)
    # the median batch would claim 128 / 0.3 = 427 solves/s and hide it
    assert 128 / statistics.median(times) > 1.8 * arith.rate(1280, window)


def test_percentiles_are_over_all_ticks():
    ticks = ([200.0] * 9 + [400.0]) * 10      # every tenth tick stalls
    assert arith.percentile(ticks, 50) == 200.0
    assert arith.percentile(ticks, 90) == pytest.approx(220.0)
    assert arith.percentile(ticks, 99) == 400.0
    # medians of chunks of ten ticks never see a stalled tick
    chunks = [statistics.median(ticks[i:i + 10]) for i in range(0, 100, 10)]
    assert max(chunks) == 200.0
    assert arith.percentile([3.0], 90) == 3.0
    with pytest.raises(ValueError):
        arith.percentile([], 50)


def test_idle_share_is_the_union_of_device_intervals():
    # overlapping ops count once; ops outside the window are clipped
    ops = [(0, 10), (5, 15), (30, 40), (90, 130)]
    assert arith.union_ns(ops, 0, 100) == 15 + 10 + 10
    assert arith.idle_pct(ops, 0, 100) == pytest.approx(65.0)
    assert arith.gaps(ops, 0, 100) == [(15, 15), (40, 50)]
    assert arith.idle_pct([], 0, 100) == 100.0


def test_a_stall_shows_in_the_idle_share():
    busy = [(i * 10, i * 10 + 9) for i in range(100)]       # 90% busy
    stalled = busy[:50] + [(s + 500, e + 500) for s, e in busy[50:]]
    assert arith.idle_pct(busy, 0, 1000) == pytest.approx(10.0)
    assert arith.idle_pct(stalled, 0, 1500) == pytest.approx(40.0)
