"""The control, the configuration's reference computed in float32 with
TF32 products in the program's place, fails the cells' limits (at
solo12_trot_mini here; at the cells' own sizes on the card, PERF.md)."""
import json

import pytest

from scpbench_mini import BENCH, mini_root
from scpbench import check, harness, readings


@pytest.mark.parametrize("cell,real", [("mini_batch", "trot165_b128"),
                                       ("mini_mpc", "trot165_mpc_w20")])
def test_control_fails(tmp_path, cell, real):
    root = mini_root(tmp_path, dtype="float32", batch=4)
    c = harness.Cell.find(cell, root)
    if c.mode == "batch":
        numbers, _ = readings.control_batch(c, 11, "cpu")
    else:
        numbers, _ = readings.control_mpc(c, 11, 6, "cpu")
    limits = json.loads((BENCH / "workloads" / f"{real}.json")
                        .read_text())["limits"]
    correct, rows, _ = check.verdict(numbers, limits)
    assert not correct, rows
