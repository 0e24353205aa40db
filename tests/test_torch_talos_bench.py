"""The talos pace deployment of the benchmark (`scpbench/configs/
talos_pace.json`), the polish's rule for its CoP rows and the counters
its per-layer metrics read.

On the CPU: the benchmark's `build_program` builds from the file the same
problem as `presets.build_problem(presets.TALOS_PACE)` (the file's solver
settings aside); `counts["scp.linearizations"]` grows by one a pass of a
re-linearizing SCP loop and by one a frozen solve; the polish holds the
CoP inside the foot on talos's first QP and takes no round-off dual of a
CoP row for an active one.  The `cuda` case
holds `block_tridiag.launches["tridiag_factor_lanes"]` to the lanes each
factor call factors:

    python -m pytest --noconftest -m cuda tests/test_torch_talos_bench.py
"""
import dataclasses

import pytest
import torch

from centroidal_mpc_tpu_torch.config import gaits, presets
from centroidal_mpc_tpu_torch.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu_torch.ops import admm, block_tridiag
from centroidal_mpc_tpu_torch.ops import blockqp
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)
from centroidal_mpc_tpu_torch.solver import scp as scp_mod
from centroidal_mpc_tpu_torch.utils.profiling import counters

# talos pace cut to one short cycle: N = 2 + 6 + 2 + 6 + 2 = 18 knots
SHORT_GAIT = dict(step_knots=6, support_knots=2, nb_steps=1)


def _cell():
    from scpbench.harness import Cell
    return Cell.find("talos_pace_b128")


def _leaves(tree):
    """(path, tensor) of every tensor leaf of nested dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [("", tree)]
    if dataclasses.is_dataclass(tree):
        return [(f"{f.name}.{p}", t) for f in dataclasses.fields(tree)
                for p, t in _leaves(getattr(tree, f.name))]
    return []


def test_build_program_builds_the_preset():
    """Model, plan, OCP tensors and warm start equal, leaf for leaf;
    the settings are the file's."""
    from scpbench.harness import build_program
    cell = _cell()
    got = build_program(cell, "cpu")
    want = presets.build_problem(presets.TALOS_PACE, device="cpu")
    for part in ("model", "plan", "ocp"):
        a, b = _leaves(getattr(got, part)), _leaves(getattr(want, part))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), part + path
    assert got.model.contact_model == "wrench6"
    assert torch.equal(got.X0, want.X0) and torch.equal(got.U0, want.U0)
    assert got.preset.robot == presets.TALOS_PACE.robot
    assert got.preset.gait == presets.TALOS_PACE.gait
    cfg = cell.config
    assert got.scp.qp == QPSettings(**cfg["qp"])
    assert got.scp == scp_mod.ScpSettings(**cfg["scp"], qp=got.scp.qp)
    # the preset's trust region and re-linearization, the bench's QP point
    for name in ("trust_region_radius0", "omega0", "rho0", "rho1",
                 "max_iterations", "update_linearization",
                 "convergence_threshold", "lqr_iters"):
        assert getattr(got.scp, name) == getattr(presets.TALOS_PACE.scp,
                                                 name), name
    assert got.scp.qp.adaptive_rho and got.scp.qp.polish
    assert got.scp.qp.adaptive_rho_mode == "always"


@pytest.mark.parametrize("relin", [True, False], ids=["moving", "frozen"])
def test_linearizations_are_counted(relin):
    """One a pass of a re-linearizing loop, one a frozen solve, under the
    `scp.linearize` span; on the CPU as on the card."""
    preset = dataclasses.replace(
        presets.TALOS_PACE,
        gait=dataclasses.replace(gaits.TALOS_PACE, **SHORT_GAIT))
    qp = QPSettings(eps_abs=5e-4, eps_rel=5e-4, check_interval=10,
                    adaptive_rho=True, adaptive_rho_mode="always",
                    max_iter=2000)
    prob = presets.build_problem(preset, dtype=torch.float64, device="cpu",
                                 qp=qp)
    settings = dataclasses.replace(prob.scp, qp_backend="block",
                                   update_linearization=relin,
                                   max_iterations=3)
    X0 = prob.X0[None].repeat(2, 1, 1)
    X0[1, :, :2] += torch.tensor([0.004, -0.003], dtype=torch.float64)
    U0 = prob.U0[None].repeat(2, 1, 1)
    before = counters()
    sol = batched_solve(prob.model, prob.plan.schedule,
                        tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0),
                        X0, U0, settings)
    grown = {k: v - before[k] for k, v in counters().items()}
    assert bool(sol.success.all())
    passes = grown["scp.iterations"]
    assert passes == int(sol.iterations.max()) >= 1
    assert grown["scp.linearizations"] == (passes if relin else 1)


def _first_qp(dtype, **gait):
    """The first block QP of talos pace (its gait changed by `gait`) at 2
    lanes (lane 1 moved 4 mm in x, -3 mm in y) and its unscaled warm
    start (X, U, t)."""
    preset = dataclasses.replace(
        presets.TALOS_PACE,
        gait=dataclasses.replace(gaits.TALOS_PACE, **gait))
    prob = presets.build_problem(preset, dtype=dtype, device="cpu")
    X = prob.X0[None].repeat(2, 1, 1)
    X[1, :, :2] += torch.tensor([0.004, -0.003], dtype=dtype)
    U = prob.U0[None].repeat(2, 1, 1)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                   with_covariance=False)
    qp = blockqp.build_block_qp(
        prob.model, prob.plan.schedule,
        tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X), X, U, data,
        100.0, 100.0)
    return qp, blockqp.WVars(x=X, u=U, t=torch.zeros(X.shape[:2],
                                                      dtype=dtype))


# the JAX bench's talos QP point (scpbench/configs/talos_pace.json)
BENCH_TALOS_QP = QPSettings(
    eps_abs=5e-4, eps_rel=5e-4, check_interval=10, alpha=1.7,
    adaptive_rho=True, adaptive_rho_mode="always", max_iter=4000,
    stall_segments=30, polish=True, polish_iters=12, polish_rounds=2,
    polish_cg_iters=8, polish_cg_restarts=1, factor_method="cholesky")


def test_scp_converges_with_the_cop_inside_the_foot():
    """Float64, talos pace (N=165) as planned, the re-linearizing SCP at
    the bench's QP point: with the polish's CoP rows as a primal-dual
    active set the loop converges in 4 iterations, as the plain reference
    (scpbench/references/wrench6_scp.py) does, and the answer keeps every
    CoP within the foot (to 1e-9 m).  With a set that only grows, CoP
    rows held at an edge of the foot with a dual of the wrong sign kept
    the CoP there, and the loop ran all 10 iterations in a 2-cycle."""
    prob = presets.build_problem(presets.TALOS_PACE, dtype=torch.float64,
                                 device="cpu", qp=BENCH_TALOS_QP)
    settings = dataclasses.replace(prob.scp, qp_backend="block",
                                   norm_method="power")
    X0, U0 = prob.X0[None], prob.U0[None]
    sol = batched_solve(prob.model, prob.plan.schedule,
                        tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0),
                        X0, U0, settings)
    assert bool(sol.success.all()) and int(sol.iterations.max()) <= 5
    assert float(sol.conv.max()) < settings.convergence_threshold
    logic = prob.plan.schedule.logic[None, :, :, None]
    cr = prob.ocp.cop_range                 # [[lxp, lxn], [lyp, lyn]]
    cop = sol.U.reshape(logic.shape[:3] + (6,))[..., :2]
    over = torch.maximum(-cr[:, 1] - cop, cop - cr[:, 0]) * logic
    # the box binds (within 1e-9 m), and nowhere is it left
    assert -1e-9 < float(over.amax()) < 1e-9


def test_polish_ignores_round_off_duals_of_cop_rows():
    """Float32: a CoP row whose dual is round-off (1e-10, under the
    dtype's epsilon) is not taken into the polish's active set, so the
    polish answers as if the dual were 0; a dual above the epsilon is
    taken (the answer moves)."""
    qp, w0 = _first_qp(torch.float32, **SHORT_GAIT)
    s = blockqp._ruiz(qp, 10)
    w, y = blockqp._admm_loop_batched(
        s, blockqp._wpacked(w0) / s.D, torch.zeros_like(s.l),
        dataclasses.replace(BENCH_TALOS_QP, polish=False))[:2]
    cop, Aw_cop = s.zgroups(y).cop, s.zgroups(blockqp._apply_A(s, w)).cop
    free = ((cop == 0) & (s.coph != 0)
            & ((Aw_cop - s.zgroups(s.l).cop).abs() > 1e-2)
            & ((s.zgroups(s.u).cop - Aw_cop).abs() > 1e-2))
    assert int(free.sum()) > 10

    def polished(dual):
        y_n = y.clone()
        s.zgroups(y_n).cop.copy_(torch.where(
            free, torch.full_like(cop, dual), cop))
        return blockqp._polish(s, BENCH_TALOS_QP, BENCH_TALOS_QP.sigma, w,
                               y_n)[0]
    clean = polished(0.0)
    assert torch.equal(polished(1e-10), clean)
    assert not torch.equal(polished(1e-3), clean)


@pytest.mark.cuda
def test_factor_lanes_count_the_gathered_lanes():
    """A talos block QP at B=16 with adaptive rho: every full factor call
    (the first and the polish's rounds) adds B lanes, every refactor the
    lanes it gathered, so the counter grows by B (1 + rounds) plus the
    lanes' refactors; the call counter keeps counting calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    B = 16
    preset = presets.TALOS_PACE
    prob = presets.build_problem(preset, dtype=torch.float32, device="cuda")
    X = prob.X0[None].repeat(B, 1, 1)
    gen = torch.Generator().manual_seed(5)
    X[1:, :, :2] += 0.005 * torch.randn(B - 1, 1, 2, generator=gen).cuda()
    U = prob.U0[None].repeat(B, 1, 1)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                   with_covariance=False)
    qp = blockqp.build_block_qp(
        prob.model, prob.plan.schedule,
        tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X), X, U, data,
        100.0, 100.0)
    settings = QPSettings(eps_abs=5e-4, eps_rel=5e-4, check_interval=10,
                          alpha=1.7, adaptive_rho=True,
                          adaptive_rho_mode="always", polish=True,
                          polish_rounds=2, factor_method="pallas",
                          max_iter=4000)
    seen = []
    real = blockqp.factor_batched

    def factor(diag, off):
        seen.append(diag.shape[0])
        return real(diag, off)
    w0 = blockqp.WVars(x=X, u=U, t=torch.zeros(X.shape[:2], device="cuda"))
    before = {**block_tridiag.launches, **admm.counts}
    blockqp.factor_batched = factor
    try:
        sol = blockqp.solve_block_qp(qp, settings, w0=w0)
        torch.cuda.synchronize()
    finally:
        blockqp.factor_batched = real
    grown = {k: v - before[k] for k, v in
             {**block_tridiag.launches, **admm.counts}.items()}
    refactors = int(sol.refactors.sum())
    assert refactors > 0 and grown["admm.refactor_calls"] > 0
    assert grown["tridiag_factor"] == len(seen) == (
        1 + settings.polish_rounds + grown["admm.refactor_calls"])
    assert grown["tridiag_factor_lanes"] == sum(seen) == (
        B * (1 + settings.polish_rounds) + refactors)
    assert all(0 < n <= B for n in seen[1:-settings.polish_rounds])
