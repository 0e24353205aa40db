"""Profiling and timing instrumentation.

Port of `centroidal_mpc_tpu/utils/profiling.py`: wall-clock stage timers
that wait for the device, solves/s accounting, and a `torch.profiler`
trace context.  A CUDA tensor's work is waited for with
`torch.cuda.synchronize` on its device; CPU tensors are done when the
call returns.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

from centroidal_mpc_tpu_torch import _tree


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensor leaves of a container."""
    found = set()

    def visit(t):
        if t.is_cuda:
            found.add(t.device)
        return t

    _tree.map_tensors(visit, tree)
    return found


def _synchronize(tree) -> None:
    """Wait until the work behind every CUDA tensor of `tree` is done."""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulating per-stage wall-clock timer (device-synchronized)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass `sync=tensors` (any container of them) to
        wait for their device before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:30s} {total*1e3:10.2f} ms total "
                         f"({n}x, {total/n*1e3:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A torch.profiler session (host ops, and the card's kernels when
    there is one) whose Chrome trace is written to log_dir/trace.json;
    a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def measure_solves_per_second(solve_fn, args_fn, batch: int,
                              repeats: int = 5) -> Dict[str, float]:
    """Steady-state throughput: best-of-`repeats` timed calls, each with
    fresh inputs from args_fn(i) so results cannot be cached.  A call is
    timed by CUDA events on its outputs' card, by the host clock when its
    outputs are on the CPU; the first call (its set-up and first-call
    costs) is not timed."""
    out = solve_fn(*args_fn(0))
    devices = _cuda_devices(out)
    _synchronize(out)
    times: List[float] = []
    for i in range(repeats):
        args = args_fn(i + 1)
        if devices:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            solve_fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            solve_fn(*args)
            times.append(time.perf_counter() - t0)
    best = min(times)
    return {"best_s": best, "solves_per_s": batch / best,
            "mean_s": sum(times) / len(times)}
