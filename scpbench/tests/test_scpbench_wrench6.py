"""The plain wrench6 reference (`references/wrench6_scp.py`) against the
program, on the CPU in float64, at talos pace cut to one short cycle
(6 swing and 2 double-support knots, one step each foot: N=18), with the
configuration's re-linearizing SCP and QP point; and the reference
imports nothing of the program."""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from scpbench_mini import BENCH, REPO
from scpbench import check, harness
import centroidal_mpc_tpu_torch.ops.blockqp as blockqp
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)

SHORT_GAIT = dict(step_knots=6, support_knots=2, nb_steps=1)
# The float64 program stops its ADMM at the stated eps 5e-4, and its
# polish lands on the exact optimum of each QP; both lanes' SCP converge
# (3 and 7 iterations), so the answers agree with the reference's to its
# own convergence threshold (1e-3 a step of the SCP): measured x_gap
# 2.8e-5 and 3.3e-7, u_gap 6.2e-6 and 4.9e-8.  A CoP box widened by half
# reads x_gap 0.10, a frozen linearization 0.066 (and prim 4.1).
LIMITS = {"x_gap": 1e-3, "u_gap": 1e-3, "prim": 1.0}


def short_cfg():
    cfg = json.loads((BENCH / "configs" / "talos_pace.json").read_text())
    cfg["gait"].update(SHORT_GAIT)
    cfg.update(dtype="float64")
    # the same arithmetic as 'pallas' on the CPU: the factor's plain version
    cfg["qp"]["factor_method"] = "cholesky"
    return cfg


@pytest.fixture(scope="module")
def short():
    """(program problem, the reference, the lanes' offsets, the
    reference's answers): lane 0 as planned, lane 1 moved 4 mm in x and
    -3 mm in y."""
    cfg = short_cfg()
    cell = harness.Cell("talos_short", {}, cfg, BENCH)
    prob = harness.build_program(cell, "cpu")
    ref = check.Reference(cfg, {}, "cpu")
    dx = np.zeros((2, 9))
    dx[1, :2] = [0.004, -0.003]
    return prob, ref, dx, ref.batch_lanes(dx)


def solve(prob, dx, settings=None):
    d = torch.as_tensor(dx, dtype=prob.X0.dtype)
    X0 = prob.X0[None] + d[:, None]
    U0 = prob.U0.expand((d.shape[0],) + prob.U0.shape)
    return batched_solve(prob.model, prob.plan.schedule,
                         tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0),
                         X0, U0, settings or prob.scp)


def checked(sol, answers):
    per = [check.gaps(dict(X=sol.X[i], U=sol.U[i], K=sol.K[i],
                           success=sol.success[i]), r)
           for i, r in enumerate(answers)]
    return per, check.verdict(check.summary(per), LIMITS)


def test_plan_and_warm_start_are_the_programs(short):
    """The reference works out the plan, the contact frames and the
    6-wide warm start on its own, to the program's values."""
    prob, ref, _, _ = short
    sched = prob.plan.schedule
    assert prob.model.contact_model == "wrench6" and ref.Uw.shape[-1] == 12
    np.testing.assert_array_equal(ref.logic, sched.logic.numpy())
    np.testing.assert_array_equal(ref.pos, sched.position.numpy())
    np.testing.assert_array_equal(ref.rot, sched.orientation.numpy())
    np.testing.assert_array_equal(ref.Xw.numpy(), prob.X0.numpy())
    np.testing.assert_array_equal(ref.Uw.numpy(), prob.U0.numpy())


def test_lanes_match_the_reference(short):
    prob, _, dx, answers = short
    assert prob.scp.update_linearization
    sol = solve(prob, dx)
    per, (ok, rows, _) = checked(sol, answers)
    for (x, u, _, prim), r in zip(per, answers):
        assert r["success"]
        assert prim < 1.0 and x < LIMITS["x_gap"] and u < LIMITS["u_gap"]
    assert ok, rows
    # the CoP box binds in the reference's answer: its rows are checked
    U = answers[0]["U"].reshape(-1, 2, 6)
    assert np.abs(U[..., 1]).max() == pytest.approx(0.05, abs=1e-6)


def wide_cop(real):
    """The program's CoP box widened by half."""
    def build(*args, **kwargs):
        qp = real(*args, **kwargs)
        return dataclasses.replace(qp, cop_l=1.5 * qp.cop_l,
                                   cop_u=1.5 * qp.cop_u)
    return build


@pytest.mark.parametrize("fault", ["wide_cop", "frozen"])
def test_planted_fault_is_caught(short, monkeypatch, fault):
    prob, _, dx, answers = short
    settings = prob.scp
    if fault == "wide_cop":
        monkeypatch.setattr(blockqp, "build_block_qp",
                            wide_cop(blockqp.build_block_qp))
    else:
        settings = dataclasses.replace(settings, update_linearization=False)
    _, (ok, rows, _) = checked(solve(prob, dx, settings), answers)
    assert not ok, rows


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "from scpbench import check; "
            "check.load_reference('wrench6_scp'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('centroidal_mpc_tpu_torch', 'centroidal_mpc_tpu', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("metric,counts,want", [
    ("relinearizations_per_batch.batch", {"dare_lqr": 20}, 10.0),
    ("relinearizations_per_batch.batch", {}, None),
    ("factors_per_lane.batch", {"tridiag_factor": 166,
                                "tridiag_factor_lanes": 10496}, 41.0),
    # a program without the lane counter (or a run off the card)
    ("factors_per_lane.batch", {"tridiag_factor": 166}, None)])
def test_filed_readers(metric, counts, want):
    """The readers filed for the talos cell: two traced batches of 128
    lanes."""
    rec = {"mode": "batch", "batch": 128, "units": 2, "counts": counts}
    assert harness.load_metric(metric).read(rec) == want
