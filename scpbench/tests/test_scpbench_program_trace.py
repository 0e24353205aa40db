"""The program's spans and counters as `program_trace.py` reads them, and
the benchmark's own traced readings with and without the spans."""
import contextlib
import json
import time

import numpy as np
import pytest

from scpbench_mini import cuda_available, mini_root
from scpbench import harness, program_trace
from scpbench.traffic import Scenarios

READINGS = ("admm_lane_occupancy", "host_syncs_per_batch",
            "admm_host_ms_per_iter", "admm_idle_pct")


def _traced(root, device, spans: bool):
    cell = harness.Cell.find("mini_batch", root)
    prob = harness.build_program(cell, device)
    loop = harness.BatchLoop(cell, prob, device)
    loop.warm_up(1)
    gen = Scenarios(2**31 + 11, cell.workload["perturb_std"])
    with (program_trace.spans_suppressed() if not spans
          else contextlib.nullcontext()):
        rec, _ = program_trace.traced(cell, prob, loop, gen, 2,
                                      device == "cuda")
    return rec


def _with_every_metric(root):
    """The benchmark's per-layer metrics read in `mini_batch` too."""
    path = root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    for m in bench["per_layer"]:
        m["workloads"].append("mini_batch")
    path.write_text(json.dumps(bench))
    return root


def _run_cell(root, device, spans: bool):
    cell = harness.Cell.find("mini_batch", root)
    with (program_trace.spans_suppressed() if not spans
          else contextlib.nullcontext()):
        return harness.run_cell(cell, 2**31 + 5, 0.05, True, device,
                                time.perf_counter(), log=lambda m: None)


def test_readings_of_a_traced_mini_batch(tmp_path):
    rec = _traced(mini_root(tmp_path, batch=3), "cpu", True)
    got = program_trace.readings(rec)
    counts = rec["program_counts"]
    assert rec["units"] == 2 and counts["scp.iterations"] >= 2
    assert 0 < got["admm_lane_occupancy"] <= 100
    assert got["host_syncs_per_batch"] == sum(
        v for k, v in counts.items() if k.startswith("sync.")) / 2
    assert got["admm_host_ms_per_iter"] > 0
    assert got["admm_idle_pct"] is None          # no device on the CPU
    rows = program_trace.table(rec)
    assert rows["cmpc.admm.segment"]["count"] == counts["admm.segments"]
    assert rows["cmpc.scp.solve"]["count"] == 2
    for row in rows.values():
        assert 0 <= row["self_s"] <= row["wall_s"]
    assert len(program_trace.table_lines(rows)) == len(rows)


def test_a_program_without_counters_reads_nothing(tmp_path):
    rec = dict(units=1, batch=2, qp=np.array([10, 20]), program_counts={},
               program_spans=[])
    assert program_trace.readings(rec) == dict.fromkeys(READINGS)
    assert program_trace.table(rec) == {}


def test_timeline_busy_and_idle():
    tl = program_trace._Timeline([(10, 20), (15, 30), (50, 60)], 0, 100)
    assert tl.busy(0, 100) == 30 and tl.busy(25, 55) == 10
    # gaps (0, 10), (30, 20), (60, 40)
    assert tl.idle_beginning(0, 100) == 70
    assert tl.idle_beginning(25, 55) == 20


def test_the_spans_leave_the_traced_readings_alone(tmp_path):
    root = _with_every_metric(mini_root(tmp_path, batch=2))
    on, off = (_run_cell(root, "cpu", s) for s in (True, False))
    assert on["metrics"] == off["metrics"]
    assert on["metrics"]["qp_iters_per_solve.batch"]["value"] > 0


@pytest.mark.cuda
def test_no_span_on_the_device_timeline(tmp_path):
    if not cuda_available():
        pytest.skip("needs an NVIDIA GPU")
    root = _with_every_metric(mini_root(tmp_path, dtype="float32", batch=8))
    rec = _traced(root, "cuda", True)
    assert not [n for n, _, _ in rec["device_ops"] if "cmpc." in n]
    assert not [n for n, _ in rec["breakdown"]["device_ops"]
                if "cmpc." in n]
    got = program_trace.readings(rec)
    assert all(got[k] is not None for k in READINGS), got
    on, off = (_run_cell(root, "cuda", s) for s in (True, False))
    assert not [n for n, _ in on["breakdown"]["device_ops"] if "cmpc." in n]
    assert set(on["metrics"]) == set(off["metrics"])
