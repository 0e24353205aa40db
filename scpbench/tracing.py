"""The traced stretch of a `--trace 1` run.

`torch.profiler` (host and device activities) records the first
`trace_units` batches or ticks of the window, each inside a span of the
benchmark's own (`scpbench.batch` / `scpbench.tick`), and the program's
launch counters are read before and after them.  The profile is read
from the profiler's raw event list, without building its operator tree,
so that reading it takes seconds.  `record` hands the per-layer readers
(`metrics/*.py`) one dict:

    mode, batch, n1, V          the cell's shape (n1 knots, V = nx+nu+1)
    nu, lqr_iters               controls a knot; the DARE's steps
    units, units_total          batches or ticks traced; in the window
    qp                          every lane's (tick's) QP iterations
    counts                      launch counters over the traced units
    device_ops                  [(name, start_ns, duration_ns)] on the card
    lo_ns, hi_ns                the traced window: the first span's start
                                to the last span's end
    busy_s, window_s            union of device ops; hi - lo
    breakdown                   top device ops, longest idle gaps by the
                                host op running when each began
"""
from __future__ import annotations

import bisect
import contextlib

from scpbench import arith

TOP = 10
# calls into the CUDA libraries (cuda*, cu*), which the host ops below make
RUNTIME = ("cuda", "cu")
GAPS_ATTRIBUTED = 4000   # the longest gaps looked up among the host ops


class Tracer:
    def __init__(self, on: bool, units: int, cuda: bool):
        self.on, self.units, self.cuda = on, units, cuda
        self.prof, self.seen, self.counts = None, 0, {}

    def start(self, counts):
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.counts0 = counts()
        self.counter = counts

    @contextlib.contextmanager
    def span(self, name: str):
        if self.prof is None or self.seen >= self.units:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield
        self.seen += 1
        if self.seen == self.units:
            self._finish()

    def _finish(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self.counts = {k: v - self.counts0[k]
                       for k, v in self.counter().items()}
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()

    def stop(self):
        if self.prof is not None and self.seen < self.units:
            self._finish()

    def record(self, cell, prob, units_total: int, qp) -> dict:
        from torch.autograd import DeviceType
        rec = {"mode": cell.mode, "batch": cell.workload["batch"],
               "n1": prob.X0.shape[0],
               "V": prob.X0.shape[-1] + prob.U0.shape[-1] + 1,
               "nu": prob.U0.shape[-1], "lqr_iters": prob.scp.lqr_iters,
               "units": self.seen, "units_total": units_total,
               "qp": qp, "counts": self.counts}
        if self.prof is None:
            return rec
        device, host, spans = [], [], []
        for e in self.events:
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if name.startswith("scpbench."):
                # the span, and its mirror on the device's timeline
                if e.device_type() != DeviceType.CUDA:
                    spans.append((start, start + dur))
            elif e.device_type() == DeviceType.CUDA:
                device.append((name, start, dur))
            elif not name.startswith(RUNTIME):
                host.append((start, start + dur, name))
        if not spans:
            return rec
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        intervals = [(s, s + d) for _, s, d in device
                     if s + d > lo and s < hi]
        busy = arith.union_ns(intervals, lo, hi)
        rec.update(device_ops=[d for d in device
                               if d[1] + d[2] > lo and d[1] < hi],
                   lo_ns=lo, hi_ns=hi, busy_s=busy / 1e9,
                   window_s=(hi - lo) / 1e9)
        if device:
            rec["breakdown"] = breakdown(rec["device_ops"], intervals,
                                         host, lo, hi)
        return rec


def breakdown(device_ops, intervals, host, lo: int, hi: int) -> dict:
    """The device ops that took most time, and the idle gaps summed by
    the innermost host operator running when each began."""
    by_name = {}
    for name, _, dur in device_ops:
        by_name[name] = by_name.get(name, 0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host = sorted(host)
    starts = [h[0] for h in host]
    idle = {}
    holes = sorted(arith.gaps(intervals, lo, hi), key=lambda g: -g[1])
    for start, length in holes[:GAPS_ATTRIBUTED]:
        i = bisect.bisect_right(starts, start) - 1
        name = "(Python between operators)"
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= start:
                name = host[j][2]
                break
        idle[name] = idle.get(name, 0) + length
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, ns / 1e9] for n, ns in top],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps]}
