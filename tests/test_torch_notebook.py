"""The PyTorch port's demo notebooks and script shims
(demos/*_torch.ipynb, demos/run_motion_torch.py,
demos/mpc_server_torch.py), the counterparts of tests/test_notebook.py:

  * static checks over both notebooks: nbformat 4, code cells that
    compile, every `centroidal_mpc_tpu_torch` symbol and module attribute
    the cells use exists, and no cell imports JAX or the JAX package;
  * an executed run of the trot notebook through nbclient on the CPU at
    the reduced-scale `solo12_trot_mini` preset (N=18 step-in-place
    trot): warm start, nominal and stochastic SCP, plots, whole-body
    layer, 3D preview and Monte-Carlo all run;
  * both shims answer --help without JAX entering the process.
"""
import ast
import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEMOS = ROOT / "demos"
NOTEBOOKS = ["trot_demo_torch.ipynb", "bound_demo_torch.ipynb"]
SHIMS = ["run_motion_torch.py", "mpc_server_torch.py"]
PACKAGE = "centroidal_mpc_tpu_torch"


def _code_cells(name):
    nb = json.loads((DEMOS / name).read_text())
    assert nb["nbformat"] == 4
    assert any(c["cell_type"] == "markdown" for c in nb["cells"])
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_cells_compile(name):
    cells = _code_cells(name)
    assert len(cells) == 7   # the JAX notebooks' seven code cells
    for i, src in enumerate(cells):
        compile(src, f"cell{i}", "exec")


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_package_symbols_exist(name):
    tree = ast.parse("\n".join(_code_cells(name)))
    aliases = {}  # local name -> imported object
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith(PACKAGE):
            mod = importlib.import_module(node.module)
            for a in node.names:
                try:  # submodule import (empty package __init__s)
                    obj = importlib.import_module(f"{node.module}.{a.name}")
                except ModuleNotFoundError:
                    obj = getattr(mod, a.name, None)
                assert obj is not None, \
                    f"{node.module}.{a.name} referenced by notebook missing"
                aliases[a.asname or a.name] = obj
    assert aliases
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in aliases:
            base = aliases[node.value.id]
            if isinstance(base, type(importlib)):  # module alias
                assert hasattr(base, node.attr), \
                    f"notebook calls {node.value.id}.{node.attr}, missing"


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_imports_no_jax(name):
    tree = ast.parse("\n".join(_code_cells(name)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules = [node.module or ""]
        else:
            continue
        for m in modules:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax",
                               "centroidal_mpc_tpu"), f"{name} imports {m}"


def test_trot_notebook_executes_reduced_scale(tmp_path):
    """Execute demos/trot_demo_torch.ipynb in a Jupyter kernel at
    CMPC_NB_FORCE_CPU=1 CMPC_NB_PRESET=solo12_trot_mini and check the
    SCP cells' printed lines and the preview file."""
    import nbformat
    from nbclient import NotebookClient

    nb = nbformat.read(DEMOS / "trot_demo_torch.ipynb", as_version=4)
    env = dict(CMPC_NB_FORCE_CPU="1", CMPC_NB_PRESET="solo12_trot_mini",
               CMPC_NB_OUTDIR=str(tmp_path), OMP_NUM_THREADS="1")
    # kernels inherit the launching process environment
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        NotebookClient(nb, timeout=600, kernel_name="python3",
                       resources={"metadata": {"path": str(DEMOS)}}
                       ).execute()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    text = "\n".join("".join(o.get("text", "")) for c in nb.cells
                     for o in c.get("outputs", []))
    assert "N=18 knots" in text
    assert "success=True" in text               # nominal SCP converged
    assert "stochastic: success=True" in text   # stochastic SCP too
    assert (tmp_path / "trot_nb" / "motion_preview.html").exists()


@pytest.mark.parametrize("shim", SHIMS)
def test_shim_help_imports_no_jax(shim):
    """The shim answers --help (rc 0) and JAX never enters the process."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(DEMOS / shim)!r}, '--help']\n"
            "try:\n"
            f"    runpy.run_path({str(DEMOS / shim)!r}, "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'centroidal_mpc_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout and out.stdout.rstrip().endswith("ok")
