"""The check catches a broken timed path.

Each test drives a whole run but the look for a card (solo12_trot_mini
on the CPU, float64, under the real cells' limits) with the program's
timed call broken underneath, and sees `correct` come out false; the
unbroken run comes out true.  The MPC cell holds all of its numbers;
the batch cell holds the ones every cell compares, k_gap and prim
(the batch cells' x_gap and u_gap are set from N=165 and N=122 runs
with the polish; the N=18 plan's ADMM stops looser than theirs).  The
faults a cell here can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced, and
(MPC) an ADMM that stops early with the gains K left right.  The
chance-constrained configuration under the batch cell's traffic
(`mini_stoch`, compared as the batch cell) can also have its back-offs
dropped or its gains taken at 2 DARE steps (`readings.CHANCE_FAULTS`).  (One chip: no exchange between chips.)
"""
import dataclasses
import time

import pytest
import torch

from scpbench_mini import mini_root
from scpbench import harness, readings
import centroidal_mpc_tpu_torch.ops.blockqp as blockqp
import centroidal_mpc_tpu_torch.parallel.batch as batch_mod
import centroidal_mpc_tpu_torch.solver.mpc as mpc_mod


def run(root, cell_name):
    cell = harness.Cell.find(cell_name, root)
    return harness.run_cell(cell, 2**31 + 77, 0.3, False, "cpu",
                            time.perf_counter(), log=lambda m: None)


def unchanged(real):
    """The step hands back its inputs: the warm start, no gains."""
    def solve(model, schedule, cfg, X0, U0, settings):
        sol = real(model, schedule, cfg, X0, U0, settings)
        return dataclasses.replace(sol, X=X0.clone(), U=U0.clone(),
                                   K=torch.zeros_like(sol.K))
    return solve


def half_left_out(real):
    """Only the first half of the batch is solved; the other half gets
    the first half's answers."""
    def solve(model, schedule, cfg, X0, U0, settings):
        sol = real(model, schedule, cfg, X0, U0, settings)
        h = X0.shape[0] // 2

        def fill(t):
            t = t.clone()
            t[h:2 * h] = t[:h]
            return t
        return dataclasses.replace(sol, X=fill(sol.X), U=fill(sol.U),
                                   K=fill(sol.K))
    return solve


def altered(real):
    """Every answer's first control is zeroed where it is produced."""
    def solve(model, schedule, cfg, X0, U0, settings):
        sol = real(model, schedule, cfg, X0, U0, settings)
        U = sol.U.clone()
        U[:, 0] = 0.0
        return dataclasses.replace(sol, U=U)
    return solve


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return mini_root(tmp_path_factory.mktemp("faults"), batch=4,
                     compared={"mini_batch": ("k_gap", "prim"),
                               "mini_stoch": ("k_gap", "prim")})


@pytest.mark.parametrize("cell", ["mini_batch", "mini_mpc", "mini_stoch"])
def test_sound_run_is_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["mini_batch", "mini_stoch"])
@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_batch_fault_is_caught(root, monkeypatch, fault, cell):
    monkeypatch.setattr(batch_mod, "batched_solve",
                        fault(batch_mod.batched_solve))
    out = run(root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(readings.CHANCE_FAULTS))
def test_chance_fault_is_caught(root, monkeypatch, fault):
    """The back-offs dropped (caught by prim: the answer leaves the
    tightened friction rows) or the gains of a 2-step DARE (k_gap)."""
    monkeypatch.setattr(*readings.chance_fault(fault))
    out = run(root, "mini_stoch")
    assert not out["correct"], out["checks"]
    caught = {"nobackoff": "prim", "dare2": "k_gap"}[fault]
    assert out["checks"][caught]["value"] > out["checks"][caught]["limit"]


@pytest.mark.parametrize("fault", [unchanged, altered])
def test_mpc_fault_is_caught(root, monkeypatch, fault):
    monkeypatch.setattr(mpc_mod, "solve_scp", fault(mpc_mod.solve_scp))
    out = run(root, "mini_mpc")
    assert not out["correct"], out["checks"]


def test_mpc_early_stop_is_caught(root, monkeypatch):
    """The ADMM's stopping test loosened 1000x (readings.FAULTS
    "eps1000"), underneath the step: the linearization and K are right,
    the plan is not.  (Under the batch cells' polish the same fault
    still ends at the optimum: nothing there to catch.)"""
    monkeypatch.setattr(blockqp, "_residuals", readings.loosened(
        blockqp._residuals, *readings.FAULTS["eps1000"]))
    out = run(root, "mini_mpc")
    assert not out["correct"], out["checks"]
    assert out["checks"]["k_gap"]["value"] <= out["checks"]["k_gap"]["limit"]
