"""End-to-end arithmetic of the benchmark, kept apart from the program.

Each figure is taken over all the work and all the time of the measured
window: a rate is what completed over the window's seconds, a percentile
is over every tick, and the device's idle share is the part of the traced
window that the union of device-operation intervals leaves uncovered.
"""
from __future__ import annotations

import statistics


def rate(completed: int, seconds: float) -> float:
    """Work completed over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return completed / seconds


def percentile(values, p: int) -> float:
    """The p-th percentile (1..99) of all values, by the 'inclusive'
    method of Python's statistics.quantiles (of one value, that value)."""
    if not values:
        raise ValueError("a percentile of no values")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, reach = 0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def gaps(intervals, lo: int, hi: int):
    """(start, length) of each stretch of [lo, hi] that no interval
    covers."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            out.append((reach, min(start, hi) - reach))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi - reach))
    return [g for g in out if g[1] > 0]


def idle_pct(intervals, lo: int, hi: int) -> float:
    """Share of [lo, hi] in which no device operation ran, in %."""
    return 100.0 * (1.0 - union_ns(intervals, lo, hi) / (hi - lo))
