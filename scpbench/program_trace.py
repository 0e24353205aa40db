"""The program's own spans and counters in traced batches of a cell.

    python3 scpbench/program_trace.py --workload <cell> --seed <n>
                                      [--rounds <r>]

Sets a batch cell up as `run.py` does (the same program, problem, warm-up
and traffic), then traces the cell's `trace_units` batches at a time
with the benchmark's `tracing.Tracer`, in `r` pairs of rounds on the
same batches (pair i draws them from seed + i): one round with the
program's spans (`utils.profiling.span`), one with them replaced by a
no-op, the first of the two alternating.  It prints to standard
error one line per span name (`table`) of the first pair's round with
spans, and last on standard output one JSON line: every round's traced
host seconds a batch and counters, the readings of each round with spans
(`readings`), and the card.

The readings take the dict that `Tracer.record` returns with two keys
more, which `with_program` adds from the tracer's events and the
program's counters (`utils.profiling.counters`) over the traced batches:

    program_counts   the counters' deltas over the traced batches
    program_spans    [(name, start_ns, end_ns)] of each host `cmpc.` span

A program without the counters or spans (before they were added) gives
empty ones, and every reading of them is None.  The spans are host
records; a reader takes the device's operations without any `cmpc.`
name, so that no span is counted as device work.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import sys

PREFIX = "cmpc."
SEGMENT = PREFIX + "admm.segment"


def counters() -> dict:
    """The program's counters, or {} for a program without them."""
    from centroidal_mpc_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    return dict(read()) if read is not None else {}


def program_spans(events) -> list:
    """[(name, start_ns, end_ns)] of the host events named `cmpc.*`."""
    from torch.autograd import DeviceType
    return sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in events if e.name().startswith(PREFIX)
                  and e.device_type() != DeviceType.CUDA)


def with_program(rec: dict, events, counts0: dict, counts1: dict) -> dict:
    """`rec` with `program_counts` and `program_spans` added."""
    return dict(rec, program_counts={k: v - counts0.get(k, 0)
                                     for k, v in counts1.items()},
                program_spans=program_spans(events))


def _device_intervals(rec) -> list:
    return [(s, s + d) for name, s, d in rec.get("device_ops", [])
            if not name.startswith(PREFIX)]


class _Timeline:
    """The union of device intervals over [lo, hi], as disjoint busy
    stretches and the gaps between them, each with prefix sums, so that
    the busy time inside a span and the idle time of the gaps that begin
    inside it take a bisection each."""

    def __init__(self, intervals, lo: int, hi: int):
        busy = []
        for s, e in sorted(intervals):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        self.starts = [s for s, _ in busy]
        self.ends = [e for _, e in busy]
        self.cum = [0]
        for s, e in busy:
            self.cum.append(self.cum[-1] + e - s)
        gaps, reach = [], lo
        for s, e in busy:
            if s > reach:
                gaps.append((reach, s - reach))
            reach = e
        if reach < hi:
            gaps.append((reach, hi - reach))
        self.gap_starts = [g[0] for g in gaps]
        self.gap_cum = [0]
        for _, length in gaps:
            self.gap_cum.append(self.gap_cum[-1] + length)

    def _busy_before(self, t: int) -> int:
        i = bisect.bisect_right(self.starts, t)
        total = self.cum[i]
        if i and self.ends[i - 1] > t:
            total -= self.ends[i - 1] - t
        return total

    def busy(self, a: int, b: int) -> int:
        return self._busy_before(b) - self._busy_before(a)

    def idle_beginning(self, a: int, b: int) -> int:
        """Whole lengths of the gaps that begin in [a, b)."""
        i = bisect.bisect_left(self.gap_starts, a)
        j = bisect.bisect_left(self.gap_starts, b)
        return self.gap_cum[j] - self.gap_cum[i]


def table(rec: dict) -> dict:
    """Per span name: count, host wall and self time (less the child
    spans), the device's busy time inside the spans, and the device's
    idle time in the gaps that begin inside them (all, and those that
    begin in no child span), in seconds."""
    spans = rec.get("program_spans") or []
    if not spans or "lo_ns" not in rec:
        return {}
    tl = _Timeline(_device_intervals(rec), rec["lo_ns"], rec["hi_ns"])
    rows = {}
    stack = []             # open spans: [name, start, end, child_ns, idle]
    order = sorted(spans, key=lambda s: (s[1], -s[2]))

    def close(top):
        name, a, b, child, child_idle = top
        row = rows.setdefault(name, dict(count=0, wall_s=0.0, self_s=0.0,
                                         busy_s=0.0, idle_s=0.0,
                                         self_idle_s=0.0))
        idle = tl.idle_beginning(a, b)
        row["count"] += 1
        row["wall_s"] += (b - a) / 1e9
        row["self_s"] += (b - a - child) / 1e9
        row["busy_s"] += tl.busy(a, b) / 1e9
        row["idle_s"] += idle / 1e9
        row["self_idle_s"] += (idle - child_idle) / 1e9
        if stack:
            stack[-1][3] += b - a
            stack[-1][4] += idle

    for name, a, b in order:
        while stack and stack[-1][2] <= a:
            close(stack.pop())
        stack.append([name, a, b, 0, 0])
    while stack:
        close(stack.pop())
    return rows


def readings(rec: dict) -> dict:
    """The four quantities of the program's ADMM loop over the traced
    batches; None where the record lacks what one needs."""
    counts = rec.get("program_counts") or {}
    spans = rec.get("program_spans") or []
    iters = counts.get("admm.iterations", 0)
    units, batch = rec["units"], rec["batch"]
    out = dict(admm_lane_occupancy=None, host_syncs_per_batch=None,
               admm_host_ms_per_iter=None, admm_idle_pct=None)
    if iters and units:
        useful = float(rec["qp"][:units * batch].sum())
        out["admm_lane_occupancy"] = 100.0 * useful / (batch * iters)
    syncs = [v for k, v in counts.items() if k.startswith("sync.")]
    if syncs and units:
        out["host_syncs_per_batch"] = sum(syncs) / units
    segments = [(a, b) for name, a, b in spans if name == SEGMENT]
    wall = sum(b - a for a, b in segments)
    if segments and iters:
        out["admm_host_ms_per_iter"] = wall / 1e6 / iters
    if segments and wall and rec.get("device_ops"):
        tl = _Timeline(_device_intervals(rec), rec["lo_ns"], rec["hi_ns"])
        busy = sum(tl.busy(a, b) for a, b in segments)
        out["admm_idle_pct"] = 100.0 * (1.0 - busy / wall)
    return out


def table_lines(rows: dict) -> list:
    """One line a span name, the longest host wall time first."""
    out = []
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["wall_s"]):
        out.append(
            f"# span {name} count {r['count']} wall_s {r['wall_s']:.6f} "
            f"self_s {r['self_s']:.6f} device_busy_s {r['busy_s']:.6f} "
            f"idle_in_gaps_begun_s {r['idle_s']:.6f} "
            f"of_them_outside_children_s {r['self_idle_s']:.6f}")
    return out


@contextlib.contextmanager
def spans_suppressed():
    """The program's spans replaced by a no-op while inside (a program
    without them is left as it is)."""
    import importlib
    mods = [importlib.import_module("centroidal_mpc_tpu_torch." + m)
            for m in ("solver.scp", "ops.blockqp", "ops.admm")]
    saved = {m: m.span for m in mods if hasattr(m, "span")}
    null = contextlib.nullcontext()
    for m in saved:
        m.span = lambda name: null
    try:
        yield
    finally:
        for m, f in saved.items():
            m.span = f


def traced(cell, prob, loop, gen, units: int, cuda: bool):
    """`units` traced batches: (record with the program's keys, host
    seconds a traced batch, from its submission to its answers on the
    host)."""
    import numpy as np

    from scpbench import harness, tracing
    tracer = tracing.Tracer(True, units, cuda)
    counts0 = counters()
    tracer.start(harness.launch_counts)
    items, host_s = [], 0.0
    for _ in range(units):
        got, spans, _ = loop.window(gen, 0.0, tracer)
        items += got
        host_s += sum(b - a for a, b in spans)
    tracer.stop()
    qp = np.concatenate([np.asarray(a["qp"]) for _, a in items])
    rec = tracer.record(cell, prob, units_total=len(items), qp=qp)
    return (with_program(rec, tracer.events, counts0, counters()),
            host_s / units)


def main(argv, log=print) -> int:
    import argparse

    import torch

    from scpbench import harness
    from scpbench.traffic import Scenarios
    ap = argparse.ArgumentParser(prog="scpbench/program_trace.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    cell = harness.Cell.find(args.workload)
    if cell.mode != "batch":
        log(f"error: {cell.name} is not a batch cell")
        return 2
    if not harness.device_ok(cell.workload["chips"], log):
        return 2
    torch.cuda.set_device(0)
    from centroidal_mpc_tpu_torch.ops import cuda_lib
    cuda_lib.build()
    cuda_lib.library()
    prob = harness.build_program(cell, "cuda")
    loop = harness.LOOPS[cell.mode](cell, prob, "cuda")
    loop.warm_up(cell.workload["warmup"])
    units = cell.workload["trace_units"]
    rounds = []
    for pair in range(args.rounds):
        # both rounds of a pair draw the same batches; which runs first
        # alternates from pair to pair
        for on in (True, False) if pair % 2 == 0 else (False, True):
            gen = Scenarios(args.seed + pair, cell.workload["perturb_std"])
            with (contextlib.nullcontext() if on else spans_suppressed()):
                rec, seconds = traced(cell, prob, loop, gen, units, True)
            row = dict(pair=pair, spans=on, traced_s_per_batch=seconds,
                       counts=rec["program_counts"])
            if on:
                row.update(readings(rec))
                if pair == 0:
                    for line in table_lines(table(rec)):
                        log(line)
            rounds.append(row)
    out = dict(workload=cell.name, seed=args.seed, units=units,
               rounds=rounds, device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import os
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:],
                  log=lambda m: print(m, file=sys.stderr, flush=True)))
