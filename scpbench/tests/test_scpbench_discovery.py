"""A configuration, a cell and a per-layer metric added as new files run
without an edit to any file the benchmark has."""
import filecmp
import json
import time

import pytest

from scpbench_mini import BENCH, mini_root
from scpbench import harness

NEW_METRIC = '''"""Answers in the window (a test metric)."""
UNIT = "answers"
LAYER = "device"
MOVES = "solves_per_s"


def read(rec):
    return float(len(rec["qp"])) if rec["mode"] == "batch" else None
'''


def test_new_files_are_found_by_name(tmp_path):
    root = mini_root(tmp_path, batch=2)
    (root / "metrics" / "answers_per_window.batch.py").write_text(NEW_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "answers_per_window.batch", "unit": "answers",
        "better": "higher", "source": "program_counter", "layer": "device",
        "moves": "solves_per_s", "workloads": ["mini_batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    # every file the benchmark has is unchanged in the copy
    for sub in ("", "configs", "workloads", "metrics", "references"):
        names = [p.name for p in (BENCH / sub).glob("*.*")]
        _, mismatch, errors = filecmp.cmpfiles(BENCH / sub, root / sub,
                                               names, shallow=False)
        assert not mismatch and not errors

    cell = harness.Cell.find("mini_batch", root)
    assert cell.config["name"] == "solo12_trot_mini"
    out = harness.run_cell(cell, 2**31 + 5, 0.05, True, "cpu",
                           time.perf_counter(), log=lambda m: None)
    assert out["metrics"]["answers_per_window.batch"]["value"] == \
        out["attempted"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("config,stochastic", [
    ("solo12_trot_mini", False), ("solo12_trot_stoch_mini", True)])
def test_stochastic_flag_reaches_the_program(tmp_path, config, stochastic):
    """A configuration's `stochastic` flag builds the chance-constrained
    problem; one without the key builds the deterministic one."""
    root = mini_root(tmp_path, batch=2)
    cfg = json.loads((root / "configs" / f"{config}.json").read_text())
    assert cfg.get("stochastic", False) == stochastic
    wl = json.loads((root / "workloads" / "mini_batch.json").read_text())
    cell = harness.Cell(name="mini_batch", workload=dict(wl, config=config),
                        config=cfg, root=root)
    prob = harness.build_program(cell, "cpu")
    assert prob.ocp.stochastic is stochastic
    assert prob.scp.lqr_iters == cfg["scp"]["lqr_iters"]
