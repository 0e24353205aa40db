"""The PyTorch port stands alone: importing it pulls in no JAX, and on
CPU tensors its kernel wrappers run their plain versions without
launching anything."""
import os
import subprocess
import sys

import numpy as np
import torch

from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import lqr_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    """(a) Every module of the port, the MPC controller, the sim package
    (the physics plant, figures and preview among it), the exact
    back-offs, the certifier, the runtime bindings, the CLI, the
    whole-body modules, the DDP, the pipeline and the profiling helpers
    among them, imports without jax, flax or the JAX package entering
    sys.modules; the CLI and chip_smoke.py import without matplotlib
    (which the figures of run-motion import when they are drawn)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import centroidal_mpc_tpu_torch.cli, chip_smoke\n"
        "assert 'matplotlib' not in sys.modules\n"
        "import centroidal_mpc_tpu_torch as p\n"
        "names = [m.name for m in\n"
        "         pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "walked = {n[len(p.__name__) + 1:] for n in names}\n"
        "missing = {'solver.mpc', 'sim', 'sim.monte_carlo',\n"
        "           'sim.metrics', 'solver.stochastic', 'ops.certify',\n"
        "           'ops.linalg', 'runtime.native', 'cli', 'pipeline',\n"
        "           'solver.ddp', 'solver.warm_start', 'models.rigid_body',\n"
        "           'models.whole_body_ddp', 'models.kinematics',\n"
        "           'models.whole_body', 'contact.swing',\n"
        "           'utils.polynomials', 'utils.interpolation',\n"
        "           'utils.artifacts', 'utils.profiling', 'sim.physics',\n"
        "           'sim.plots', 'sim.preview'} - walked\n"
        "from centroidal_mpc_tpu_torch import run_pipeline\n"
        "from centroidal_mpc_tpu_torch.solver.warm_start import (\n"
        "    ddp_warm_start)\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'centroidal_mpc_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('centroidal_mpc_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _spd_system(b, n, v, seed):
    rng = np.random.default_rng(seed)
    off = 0.2 * rng.standard_normal((b, n, v, v))
    r = rng.standard_normal((b, n + 1, v, v))
    diag = r @ np.swapaxes(r, -1, -2) / v + 3.0 * np.eye(v)
    rhs = rng.standard_normal((b, n + 1, v))
    return [torch.as_tensor(a, dtype=torch.float64) for a in (diag, off, rhs)]


def test_cpu_wrappers_take_plain_path():
    """(j) On CPU tensors the wrappers equal their plain versions exactly
    and no launch counter moves."""
    before = {**bt.launches, **lqr_kernel.launches}
    diag, off, rhs = _spd_system(3, 4, 7, seed=0)
    fac = bt.factor_batched(diag, off)
    for a, b in zip(fac, bt.factor_plain(diag, off)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    v = bt.forward_sweep(fac, rhs)
    torch.testing.assert_close(v, bt.forward_sweep_plain(fac, rhs),
                               rtol=0, atol=0)
    w = bt.backward_sweep(fac, v)
    torch.testing.assert_close(w, bt.backward_sweep_plain(fac, v),
                               rtol=0, atol=0)
    torch.testing.assert_close(bt.solve_batched(fac, rhs), w, rtol=0, atol=0)

    rng = np.random.default_rng(1)
    A = torch.as_tensor(np.eye(9) + 0.01 * rng.standard_normal((5, 9, 9)))
    B = torch.as_tensor(0.01 * rng.standard_normal((5, 9, 12)))
    Q, R = torch.eye(9, dtype=torch.float64), torch.eye(12,
                                                         dtype=torch.float64)
    torch.testing.assert_close(lqr_kernel.lqr_gain_batched(Q, R, A, B),
                               lqr_kernel.lqr_gain_plain(Q, R, A, B),
                               rtol=0, atol=0)
    assert {**bt.launches, **lqr_kernel.launches} == before
    assert all(n == 0 for n in before.values())
