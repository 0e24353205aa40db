"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark's
files in a temporary folder, with small configurations (solo12's trot
at N=18, `solo12_trot_mini`; its chance-constrained trot at N=32,
`solo12_trot_stoch_mini`) and small cells beside the real ones."""
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
# one trot cycle that steps 5 cm: long enough swings that the solve is
# sound, a stride that makes the chance back-offs bind (at MINI_GAIT's
# standing trot they leave every friction row slack)
STOCH_MINI_GAIT = dict(step_length=0.05, step_height=0.05, step_knots=10,
                       support_knots=4, nb_steps=1)


def cuda_available() -> bool:
    return torch.cuda.is_available()


def mini_root(tmp: pathlib.Path, dtype: str = "float64",
              batch: int = 4, compared=None) -> pathlib.Path:
    """A benchmark folder under tmp/scpbench with BENCHMARK.json beside
    it, holding the `solo12_trot_mini` and `solo12_trot_stoch_mini`
    configurations and the cells `mini_batch`, `mini_mpc` and
    `mini_stoch` (the chance-constrained configuration under
    `trot165_b128`'s traffic), with the real cells' limits (of a cell
    that `compared` names, of the numbers it lists only)."""
    root = tmp / "scpbench"
    shutil.copytree(BENCH, root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for real, name, gait in (("solo12_trot", "solo12_trot_mini", MINI_GAIT),
                             ("solo12_trot_stoch", "solo12_trot_stoch_mini",
                              STOCH_MINI_GAIT)):
        cfg = json.loads((root / "configs" / f"{real}.json").read_text())
        cfg.update(name=name, dtype=dtype)
        cfg["gait"].update(gait)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, real, config, extra in (
            ("mini_batch", "trot165_b128", "solo12_trot_mini",
             dict(batch=batch)),
            ("mini_mpc", "trot165_mpc_w20", "solo12_trot_mini",
             dict(window=8, episode_ticks=3)),
            ("mini_stoch", "trot165_b128", "solo12_trot_stoch_mini",
             dict(batch=batch))):
        wl = json.loads((root / "workloads" / f"{real}.json").read_text())
        wl.update(config=config, warmup=1, sample=4, **extra)
        if name in (compared or {}):
            wl["limits"] = {k: v for k, v in wl["limits"].items()
                            if k in compared[name]}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    return root
