"""Profiling and timing instrumentation.

Port of `centroidal_mpc_tpu/utils/profiling.py`: wall-clock stage timers
that wait for the device, and a `torch.profiler` trace context.  A CUDA
tensor's work is waited for with `torch.cuda.synchronize` on its device;
CPU tensors are done when the call returns.

The program's own instrumentation lives here too: `span`, the ranges
that the solver loops (`solver.scp`, `ops.blockqp`, `ops.admm`) open at
their layer boundaries, recorded only while a torch.profiler session
records; and `counters`, a snapshot of the program's counters, which
are always on.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from centroidal_mpc_tpu_torch import _tree

_NO_SPAN = contextlib.nullcontext()


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
    """A torch.profiler session (host ops with the program's spans among
    them, and the card's kernels when there is one) whose Chrome trace is
    written to log_dir/trace.json; a no-op when log_dir is None."""
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


def span(name: str):
    """A range named `cmpc.<name>` on the profiler's clock while a
    torch.profiler session records; at any other time a shared no-op
    context, at the cost of one flag test.

    The range is a host record of the kind an operator makes, and nests
    like one: its parent is the range that contains it.  It is not
    `torch.profiler.record_function`'s user annotation, which the
    profiler also mirrors onto the device's timeline as one interval from
    the first kernel launched inside it to the last: that interval would
    cover the device's idle time for every reader of the timeline."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast("cmpc." + name)


def counter_dicts() -> tuple:
    """The program's counter dicts, each its module's own object: the
    kernel wrappers' `launches` (`ops.block_tridiag`, `ops.lqr_kernel`,
    `ops.constraint_apply`: calls of the solve API, and the lanes the
    factor calls factored) and the solver loops' `counts` (`ops.admm`,
    shared by the dense and block solvers; `solver.scp`), with one
    `sync.*` count a blocking host read.  A replayed segment graph adds
    to them what its capture added (`ops.blockqp._SegmentGraph`)."""
    from centroidal_mpc_tpu_torch.ops import (admm, block_tridiag,
                                              constraint_apply, lqr_kernel)
    from centroidal_mpc_tpu_torch.solver import scp
    return (block_tridiag.launches, lqr_kernel.launches,
            constraint_apply.launches, admm.counts, scp.counts)


def counters() -> Dict[str, int]:
    """A snapshot of every counter of the program (`counter_dicts`).  The
    counters only grow; subtract two snapshots."""
    return {k: n for counts in counter_dicts() for k, n in counts.items()}
