"""The plain references against the program, on the CPU in float64, at
solo12_trot_mini (the chance-constrained one also at the stepping trot
of `solo12_trot_stoch_mini`); and the references import nothing of the
program."""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from scpbench_mini import BENCH, MINI_GAIT, REPO, STOCH_MINI_GAIT
from scpbench import check
from centroidal_mpc_tpu_torch.config import gaits, presets
from centroidal_mpc_tpu_torch.models.centroidal import (
    compute_trajectory_data)
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)
from centroidal_mpc_tpu_torch.solver.ocp import (_chance_backoffs,
                                                 rotated_pyramid)


def mini_cfg():
    cfg = json.loads((BENCH / "configs" / "solo12_trot.json")
                     .read_text())
    cfg["gait"].update(MINI_GAIT)
    return cfg


def test_reference_matches_the_program_f64():
    cfg = mini_cfg()
    ref = check.Reference(cfg, {}, "cpu")
    prob = presets.build_problem(
        presets.SOLO12_TROT_MINI, dtype=torch.float64, device="cpu",
        qp=check_qp(cfg))
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    # the reference works out the plan and the warm start on its own
    np.testing.assert_array_equal(ref.logic,
                                  prob.plan.schedule.logic.numpy())
    np.testing.assert_array_equal(ref.pos,
                                  prob.plan.schedule.position.numpy())
    np.testing.assert_array_equal(ref.Xw.numpy(), prob.X0.numpy())
    np.testing.assert_array_equal(ref.Uw.numpy(), prob.U0.numpy())
    dx = np.zeros((2, 9))
    dx[1, :2] = [0.004, -0.003]
    d = torch.as_tensor(dx)
    X0 = prob.X0[None] + d[:, None]
    U0 = prob.U0.expand((2,) + prob.U0.shape)
    sol = batched_solve(prob.model, prob.plan.schedule,
                        tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0),
                        X0, U0, scp)
    answers = ref.batch_lanes(dx)
    for i, r in enumerate(answers):
        assert r["success"] and bool(sol.success[i])
        x, u, k, prim = check.gaps(
            dict(X=sol.X[i], U=sol.U[i], K=sol.K[i], success=True), r)
        # the program stops its ADMM at the stated tolerance (eps 5e-4),
        # which its answer meets in the reference's own QP
        assert prim < 1.0 and x < 1e-2 and u < 1e-2
        # the DARE gains are the same arithmetic in float64
        assert k < 1e-12


def check_qp(cfg):
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    return QPSettings(**{**cfg["qp"], "factor_method": "cholesky"})


@pytest.mark.parametrize("gait", [MINI_GAIT, STOCH_MINI_GAIT],
                         ids=["standing", "stepping"])
def test_chance_reference_matches_the_program_f64(gait):
    """The chance-constrained solve: the same back-offs to round-off
    (non-zero on every planted knot but the first), the same SCP
    iterations, and answers within the stated tolerance of the
    reference's exact QP."""
    cfg = json.loads((BENCH / "configs" / "solo12_trot_stoch.json")
                     .read_text())
    cfg["gait"].update(gait)
    ref = check.Reference(cfg, {}, "cpu")
    preset = dataclasses.replace(presets.SOLO12_TROT_MINI,
                                 gait=gaits.GaitSpec(**cfg["gait"]))
    prob = presets.build_problem(preset, stochastic=True,
                                 dtype=torch.float64, device="cpu",
                                 qp=check_qp(cfg))
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method=cfg["scp"]["norm_method"],
                              lqr_iters=cfg["scp"]["lqr_iters"])
    assert prob.ocp.stochastic and scp.lqr_iters == 30
    dx = np.zeros((2, 9))
    dx[1, :2] = [0.004, -0.003]
    d = torch.as_tensor(dx)
    X0 = prob.X0[None] + d[:, None]
    U0 = prob.U0.expand((2,) + prob.U0.shape)
    cfg_b = tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0)

    data = compute_trajectory_data(prob.model, prob.plan.schedule, X0, U0,
                                   lqr_iters=30)
    program = _chance_backoffs(prob.model, cfg_b, data,
                               rotated_pyramid(cfg_b, prob.plan.schedule))
    backoff = ref.problem().chance(X0, U0)
    assert float((program[..., 4]).abs().max()) == 0.0
    np.testing.assert_allclose(program[..., :4].numpy(), backoff.numpy(),
                               rtol=1e-12, atol=1e-12)
    planted = backoff.amax(-1) > 0                       # (L, N, C)
    assert bool((planted[:, 1:] == (ref.logic[None, 1:] > 0)).all())
    assert not bool(planted[:, 0].any())

    sol = batched_solve(prob.model, prob.plan.schedule, cfg_b, X0, U0, scp)
    X, U, K, success, it = ref.problem().solve_scp(X0, U0, X0, X0[:, 0],
                                                   X0[:, -1])
    assert sol.iterations.tolist() == it.tolist()
    for i, r in enumerate(ref.batch_lanes(dx)):
        assert r["success"] and bool(sol.success[i])
        x, u, k, prim = check.gaps(
            dict(X=sol.X[i], U=sol.U[i], K=sol.K[i], success=True), r)
        assert prim < 1.0 and x < 1e-2 and u < 1e-2
        assert k < 1e-12


@pytest.mark.parametrize("name", ["point3_scp", "chance_point3_scp"])
def test_reference_imports_nothing_of_the_program(name):
    code = ("import sys; sys.path.insert(0, %r); "
            "from scpbench import check; "
            "check.load_reference(%r); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('centroidal_mpc_tpu_torch', 'centroidal_mpc_tpu', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)") % (str(REPO), name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("mm", [torch.matmul, check.tf32_matmul])
def test_tf32_rounding(mm):
    a = torch.tensor([[1.0 + 2**-12]], dtype=torch.float32)
    one = torch.ones((1, 1), dtype=torch.float32)
    got = float(mm(a, one))
    # TF32 keeps 10 mantissa bits: 1 + 2^-12 rounds to 1
    assert got == (1.0 if mm is check.tf32_matmul else 1.0 + 2**-12)
