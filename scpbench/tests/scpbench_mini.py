"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark's
files in a temporary folder, with a small configuration (solo12's trot
at N=18, `solo12_trot_mini`) and small cells beside the real ones."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

MINI_GAIT = dict(step_length=0.0, step_height=0.05, step_knots=6,
                 support_knots=2, nb_steps=1)


def cuda_available() -> bool:
    return torch.cuda.is_available()


def mini_root(tmp: pathlib.Path, dtype: str = "float64",
              batch: int = 4, compared=None) -> pathlib.Path:
    """A benchmark folder under tmp/scpbench with BENCHMARK.json beside
    it, holding the `solo12_trot_mini` configuration and the cells
    `mini_batch` and `mini_mpc`, with the real cells' limits (of a cell
    that `compared` names, of the numbers it lists only)."""
    root = tmp / "scpbench"
    shutil.copytree(BENCH, root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    cfg = json.loads((root / "configs" / "solo12_trot.json").read_text())
    cfg.update(name="solo12_trot_mini", dtype=dtype)
    cfg["gait"].update(MINI_GAIT)
    (root / "configs" / "solo12_trot_mini.json").write_text(json.dumps(cfg))
    for name, real, extra in (
            ("mini_batch", "trot165_b128", dict(batch=batch)),
            ("mini_mpc", "trot165_mpc_w20", dict(window=8, episode_ticks=3))):
        wl = json.loads((root / "workloads" / f"{real}.json").read_text())
        wl.update(config="solo12_trot_mini", warmup=1, sample=4, **extra)
        if name in (compared or {}):
            wl["limits"] = {k: v for k, v in wl["limits"].items()
                            if k in compared[name]}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    return root
