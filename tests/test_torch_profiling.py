"""The port's profiling helpers (utils/profiling.py) on the CPU: the stage
timer and its report, and the torch.profiler trace context (and its no-op
form).  The program's spans and counters: test_torch_tracing.py."""
import json
import time

import torch

from centroidal_mpc_tpu_torch.utils import profiling


def test_stage_timer_accumulates_and_reports():
    timer = profiling.StageTimer()
    x = torch.ones(8)
    for _ in range(2):
        with timer.stage("solve", sync=(x, [x * 2])):
            time.sleep(0.01)
    with timer.stage("build"):
        pass
    assert timer.counts == {"solve": 2, "build": 1}
    assert timer.totals["solve"] >= 0.02 > timer.totals["build"]
    lines = timer.report().splitlines()
    assert lines[0].startswith("solve") and "(2x" in lines[0]
    assert lines[1].startswith("build")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "log")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(tmp_path / "log" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_is_a_no_op_without_a_directory(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None
