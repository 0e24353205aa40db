"""The import guard compares whole top-level module names, and a run
loads neither JAX nor the JAX package."""
import subprocess
import sys
import types

from scpbench_mini import REPO
from scpbench import harness


def test_whole_top_level_names(monkeypatch):
    for name in ("centroidal_mpc_tpu_torch", "centroidal_mpc_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in ("jax", "centroidal_mpc_tpu", "jaxlib", "flax"):
        sys.modules.pop(name, None)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "centroidal_mpc_tpu.ops",
                        types.ModuleType("centroidal_mpc_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["centroidal_mpc_tpu", "jax"]


def test_a_run_loads_no_jax(tmp_path):
    """Set-up, a window, and the check, in a fresh process."""
    code = f"""
import sys, time, pathlib
sys.path.insert(0, {str(REPO / 'scpbench' / 'tests')!r})
from scpbench_mini import mini_root
from scpbench import harness
root = mini_root(pathlib.Path({str(tmp_path)!r}), batch=2)
harness.run_cell(harness.Cell.find('mini_batch', root), 3, 0.05, False,
                 'cpu', time.perf_counter(), log=lambda m: None)
print(harness.forbidden_modules())
sys.exit(1 if harness.forbidden_modules() else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_no_result_without_the_card_or_the_program(tmp_path):
    """Without a card, and in a folder that holds only BENCHMARK.json and
    the benchmark's files, run.py exits non-zero and prints no result."""
    import shutil
    shutil.copytree(REPO / "scpbench", tmp_path / "scpbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "scpbench/run.py", "--workload", "trot165_b128",
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
