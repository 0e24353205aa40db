"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These need an NVIDIA GPU with nvcc and skip without one; on the
card run them (this file imports no JAX, so skip the JAX test conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import lqr_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# f32 kernels vs f32 plain versions: a few ulp times cond ~10 and V;
# f64: round-off
TOL = {torch.float32: 1e-4, torch.float64: 1e-11}


def _system(b, n, v, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    off = 0.2 * rng.standard_normal((b, n, v, v))
    r = rng.standard_normal((b, n + 1, v, v))
    diag = r @ np.swapaxes(r, -1, -2) / v + 3.0 * np.eye(v)
    rhs = rng.standard_normal((b, n + 1, v))
    return [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (diag, off, rhs)]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# (32, 8, 22) the bench's kernel_exact shape, (128, 50, 22) the main
# path's; (4, 165, 22) wraps the sweeps' ring of stages five times and
# (300, 50, 22) takes more than one wave of the 132 SMs; odd V copies by
# cp.async instead of TMA, V other than 22 runs the generic sweep, and N=0
# has no coupling block (the factor then skips its second launch);
# (1, 20, 22) is the MPC tick's window and (1, 50, 22) one full-plan
# scenario
SHAPES = [(5, 7, 22), (3, 1, 13), (2, 0, 9), (32, 8, 22), (128, 50, 22),
          (4, 165, 22), (300, 50, 22), (3, 20, 31), (6, 30, 16),
          (1, 20, 22), (1, 50, 22)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,n,v", SHAPES)
def test_tridiag_kernels_match_plain(cuda, dtype, b, n, v):
    diag, off, rhs = _system(b, n, v, dtype, cuda)
    counts = dict(bt.launches)
    fac = bt.factor_batched(diag, off)
    ref = bt.factor_plain(diag, off)
    for x, y in zip(fac, ref):
        if y.numel():
            assert _rel(x, y) < TOL[dtype]
    v_k = bt.forward_sweep(fac, rhs)
    assert _rel(v_k, bt.forward_sweep_plain(fac, rhs)) < TOL[dtype]
    w_k = bt.backward_sweep(fac, v_k)
    assert _rel(w_k, bt.backward_sweep_plain(fac, v_k)) < TOL[dtype]
    torch.cuda.synchronize()
    assert bt.launches["tridiag_factor"] == counts["tridiag_factor"] + 1
    assert bt.launches["tridiag_fwd"] == counts["tridiag_fwd"] + 1
    assert bt.launches["tridiag_bwd"] == counts["tridiag_bwd"] + 1


def _assert_close(pairs, dtype):
    for x, y in pairs:
        assert x.shape == y.shape
        if y.numel():
            assert _rel(x, y) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,n,v", SHAPES)
def test_factor_halves_match_plain(cuda, dtype, b, n, v):
    """The chain (Cinv, W) and the couplings (Pfwd, Pbwd) each against
    their plain version on the same inputs; the couplings write Pfwd over
    W in place."""
    diag, off, _ = _system(b, n, v, dtype, cuda)
    cinv, w = bt.factor_chain(diag, off)
    _assert_close(zip((cinv, w), bt.factor_chain_plain(diag, off)), dtype)
    ref = bt.factor_couple_plain(cinv, w)
    w_in = w.clone()
    pfwd, pbwd = bt.factor_couple(cinv, w_in)
    assert pfwd.data_ptr() == w_in.data_ptr()
    _assert_close(zip((pfwd, pbwd), ref), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factor_chain_takes_misaligned_inputs(cuda, dtype):
    """diag and off one element past a 16-byte boundary: the chain copies
    them one element at a time (cp.async of 4 or 8 bytes)."""
    diag, off, _ = _system(3, 6, 22, dtype, cuda)
    odd = [_one_element_in(t) for t in (diag, off)]
    assert all(t.data_ptr() % 16 for t in odd)
    _assert_close(zip(bt.factor_chain(*odd),
                      bt.factor_chain_plain(diag, off)), dtype)
    _assert_close(zip(bt.factor_batched(*odd), bt.factor_plain(diag, off)),
                  dtype)


def _dare_inputs(S, nx, nu, dtype, device, seed=1):
    """Random systems near the real linearizations (A = I + dt J): with
    A = I + 0.05 N(0,1) the 30-step recursion grows a rounding difference
    by the unstable closed loop's rho^60, and an f32 comparison then
    measures the input's conditioning, not the kernel."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.02 * rng.standard_normal((S, nx, nx))
    B = 0.05 * rng.standard_normal((S, nx, nu))
    Q = np.diag(rng.uniform(1e3, 1e4, nx))
    R = np.diag(rng.uniform(1e1, 1e3, nu))
    return [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (Q, R, A, B)]


# (S, nx, nu, n_iter): solo12's (9, 12) at 0, the main path's 2 and the
# stochastic stage's 30 steps, and at the main path's S = 6,400; bolt's
# (9, 6); S = 1 and 3 leave the last warp's second problem empty; (7, 10)
# and (16, 16) run the generic width; S = 20 is the MPC tick's window
DARE_CASES = [(37, 9, 12, 0), (37, 9, 12, 2), (37, 9, 12, 30),
              (6400, 9, 12, 2), (41, 9, 6, 2), (41, 9, 6, 30),
              (1, 9, 12, 2), (3, 9, 6, 2), (5, 7, 10, 2), (3, 16, 16, 2),
              (20, 9, 12, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,nx,nu,n_iter", DARE_CASES)
def test_dare_kernel_matches_plain(cuda, dtype, S, nx, nu, n_iter):
    t = _dare_inputs(S, nx, nu, dtype, cuda)
    count = lqr_kernel.launches["dare_lqr"]
    K = lqr_kernel.lqr_gain_batched(*t, n_iter=n_iter)
    torch.cuda.synchronize()
    assert lqr_kernel.launches["dare_lqr"] == count + 1
    assert K.shape == (S, nu, nx)
    assert _rel(K, lqr_kernel.lqr_gain_plain(*t, n_iter)) < TOL[dtype]


def test_dare_wrapper_raises_on_what_it_does_not_take(cuda):
    Q, R, A, B = _dare_inputs(3, 9, 12, torch.float32, cuda)
    count = lqr_kernel.launches["dare_lqr"]
    with pytest.raises(ValueError, match="<= 16"):
        lqr_kernel.lqr_gain_batched(*_dare_inputs(3, 9, 17, torch.float32,
                                                  cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lqr_kernel.lqr_gain_batched(Q, R, A.mT.contiguous().mT, B)
    with pytest.raises(ValueError, match="share device"):
        lqr_kernel.lqr_gain_batched(Q.cpu(), R, A, B)
    assert lqr_kernel.launches["dare_lqr"] == count


def test_wrappers_raise_on_what_they_do_not_take(cuda):
    diag, off, rhs = _system(2, 3, 9, torch.float32, cuda)
    with pytest.raises(TypeError):
        bt.factor_batched(diag.half(), off.half())
    with pytest.raises(ValueError):
        bt.factor_batched(diag, off.cpu())
    with pytest.raises(ValueError):
        bt.factor_batched(diag.mT, off)      # not contiguous
    fac = bt.factor_batched(diag, off)
    with pytest.raises(ValueError):
        bt.forward_sweep(fac, rhs[:, :-1])   # wrong knot count


def _one_element_in(t):
    """A contiguous copy of t whose data starts one element past a 16-B
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sweeps_raise_on_unaligned_tensors(cuda, dtype):
    """Even V copies the blocks with TMA: Cinv or a coupling block off a
    16-byte boundary raises before any launch.  The rhs is read element
    by element, and odd V copies the blocks with cp.async: those run."""
    diag, off, rhs = _system(2, 3, 22, dtype, cuda)
    fac = bt.factor_batched(diag, off)
    counts = dict(bt.launches)
    for field, sweep in (("Cinv", bt.forward_sweep),
                         ("Pfwd", bt.forward_sweep),
                         ("Cinv", bt.backward_sweep),
                         ("Pbwd", bt.backward_sweep)):
        bad = fac._replace(**{field: _one_element_in(getattr(fac, field))})
        with pytest.raises(ValueError, match="16-byte"):
            sweep(bad, rhs)
    assert bt.launches == counts
    assert _rel(bt.forward_sweep(fac, _one_element_in(rhs)),
                bt.forward_sweep_plain(fac, rhs)) < TOL[dtype]
    diag, off, rhs = _system(2, 3, 9, dtype, cuda)
    fac = bt.factor_batched(diag, off)
    odd = fac._replace(Cinv=_one_element_in(fac.Cinv),
                       Pbwd=_one_element_in(fac.Pbwd))
    assert _rel(bt.backward_sweep(odd, rhs),
                bt.backward_sweep_plain(fac, rhs)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,n,v", [(6, 30, 22), (5, 122, 16)])
def test_factor_of_gathered_lanes_equals_full_factor(cuda, dtype, b, n, v):
    """'cond' rho refactors only the lanes that trigger: the factor of an
    index_select of lanes (fresh, contiguous, aligned tensors) equals those
    lanes of the factor of the whole batch, bit for bit (each scenario is
    factored alone), and scattered back by index_copy it gives the whole
    batch's factor."""
    diag, off, _ = _system(b, n, v, dtype, cuda)
    lanes = torch.tensor([1, 3, b - 1], device=cuda)
    full = bt.factor_batched(diag, off)
    count = bt.launches["tridiag_factor"]
    sub = bt.factor_batched(diag.index_select(0, lanes),
                            off.index_select(0, lanes))
    assert bt.launches["tridiag_factor"] == count + 1
    for x, y in zip(sub, full):
        assert torch.equal(x, y.index_select(0, lanes))
    stale = bt.factor_batched(diag + torch.eye(v, dtype=dtype, device=cuda),
                              off)
    merged = [s.index_copy(0, lanes, g) for s, g in zip(stale, sub)]
    keep = torch.tensor([i for i in range(b) if i not in lanes.tolist()],
                        device=cuda)
    for m, f, s in zip(merged, full, stale):
        assert torch.equal(m.index_select(0, lanes), f.index_select(0, lanes))
        assert torch.equal(m.index_select(0, keep), s.index_select(0, keep))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dare_kernel_on_talos_linearization(cuda, dtype):
    """The DARE on talos's real linearization (wrench6: nu 12, B with the
    CoP and torque columns) at its warm start, 2 steps, S = 165: the
    re-linearizing SCP runs it once an iteration."""
    from centroidal_mpc_tpu_torch.config import presets
    from centroidal_mpc_tpu_torch.models.centroidal import linearize_step
    prob = presets.build_problem(presets.TALOS_PACE, dtype=dtype,
                                 device=cuda)
    sched = prob.plan.schedule
    _, A, B, _ = linearize_step(prob.model, prob.X0[:-1], prob.U0,
                                sched.position, sched.logic,
                                sched.orientation)
    assert B.shape == (165, 9, 12) and B[:, 6:9, 0:2].abs().max() > 0
    args = (prob.model.Q, prob.model.R, A.contiguous(), B.contiguous())
    count = lqr_kernel.launches["dare_lqr"]
    K = lqr_kernel.lqr_gain_batched(*args, n_iter=2)
    torch.cuda.synchronize()
    assert lqr_kernel.launches["dare_lqr"] == count + 1
    assert _rel(K, lqr_kernel.lqr_gain_plain(*args, 2)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 3])
def test_factor_of_one_gathered_lane(cuda, dtype, b):
    """'cond' rho at the MPC tick's shape (N=20, V=22): a segment in which
    one lane triggers factors that lane alone, gathered by index_select
    (B=1 gathers the only lane); the factor equals that lane of the full
    one bit for bit, and index_copy puts it back."""
    diag, off, _ = _system(b, 20, 22, dtype, cuda)
    lane = torch.tensor([b - 1], device=cuda)
    full = bt.factor_batched(diag, off)
    count = bt.launches["tridiag_factor"]
    sub = bt.factor_batched(diag.index_select(0, lane),
                            off.index_select(0, lane))
    assert bt.launches["tridiag_factor"] == count + 1
    for x, y in zip(sub, full):
        assert x.shape[0] == 1 and torch.equal(x, y.index_select(0, lane))
    stale = bt.factor_batched(diag + torch.eye(22, dtype=dtype, device=cuda),
                              off)
    for m, f in zip((s.index_copy(0, lane, g) for s, g in zip(stale, sub)),
                    full):
        assert torch.equal(m.index_select(0, lane), f.index_select(0, lane))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dare_kernel_on_mpc_window_linearization(cuda, dtype):
    """The DARE on the MPC tick's window (solo12_trot_n50's first 20
    knots at its warm start, S = 20, 2 steps): the tick runs it once."""
    from centroidal_mpc_tpu_torch.config import presets
    from centroidal_mpc_tpu_torch.models.centroidal import linearize_step
    prob = presets.build_problem(presets.SOLO12_TROT_N50, dtype=dtype,
                                 device=cuda)
    sched = prob.plan.schedule
    _, A, B, _ = linearize_step(prob.model, prob.X0[:20], prob.U0[:20],
                                sched.position[:20], sched.logic[:20],
                                sched.orientation[:20])
    args = (prob.model.Q, prob.model.R, A.contiguous(), B.contiguous())
    count = lqr_kernel.launches["dare_lqr"]
    K = lqr_kernel.lqr_gain_batched(*args, n_iter=2)
    torch.cuda.synchronize()
    assert lqr_kernel.launches["dare_lqr"] == count + 1
    assert K.shape == (20, 12, 9)
    assert _rel(K, lqr_kernel.lqr_gain_plain(*args, 2)) < TOL[dtype]


def test_mpc_tick_launches_every_kernel(cuda):
    """Two MPC ticks on the card (solo12_trot_n50, window 20, B=1, f32,
    the bench's tick settings): each is solved and launches every kernel;
    the window's slices reach the kernels only through fresh tensors."""
    import dataclasses
    from centroidal_mpc_tpu_torch.config import presets
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
    from centroidal_mpc_tpu_torch.solver.mpc import MpcController
    qp = QPSettings(eps_abs=5e-4, eps_rel=5e-4, polish=False,
                    check_interval=10, alpha=1.7, adaptive_rho=True,
                    adaptive_rho_mode="cond", max_iter=4000,
                    stall_segments=30, factor_method="pallas")
    prob = presets.build_problem(presets.SOLO12_TROT_N50, qp=qp, device=cuda)
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power", max_iterations=1)
    X0, U0 = prob.X0[None], prob.U0[None]
    cfg = dataclasses.replace(tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1],
                                              X0), terminal_equality=False)
    ctrl = MpcController(model=prob.model, schedule=prob.plan.schedule,
                         cfg=cfg, settings=scp, window=20)
    state, x = ctrl.init_state(X0, U0), X0[:, 0]
    for tick in range(2):
        before = {**bt.launches, **lqr_kernel.launches}
        state, sol = ctrl.step(state, x)
        torch.cuda.synchronize()
        after = {**bt.launches, **lqr_kernel.launches}
        assert bool(sol.success[0]) and state.tick == tick + 1
        assert all(after[k] > before[k] for k in after), (before, after)
        x = sol.X[:, 1]


def _mini_f64(device, **qp):
    """solo12_trot_mini in f64 on `device`, B=1, with its block QP and
    dense QP at the warm start."""
    from centroidal_mpc_tpu_torch.config import presets
    from centroidal_mpc_tpu_torch.models.centroidal import (
        compute_trajectory_data)
    from centroidal_mpc_tpu_torch.ops import blockqp
    from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
    from centroidal_mpc_tpu_torch.solver.ocp import build_qp
    prob = presets.build_problem(presets.SOLO12_TROT_MINI,
                                 dtype=torch.float64, device=device)
    X, U = prob.X0[None], prob.U0[None]
    cfg = tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                   with_covariance=False)
    args = (prob.model, prob.plan.schedule, cfg, X, U, data, 100.0, 100.0)
    return build_qp(*args), blockqp.build_block_qp(*args)


def test_dense_solve_on_card_matches_cpu(cuda):
    """The dense solve_qp in f64 on the card and on the CPU: equal
    iterations and statuses, x within 1e-8 of its scale (cuSOLVER's and
    LAPACK's round-off differ)."""
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings, solve_qp
    st = QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=3000)
    card = solve_qp(_mini_f64(cuda)[0], st)
    cpu = solve_qp(_mini_f64("cpu")[0], st)
    assert bool(card.converged[0]) and bool(cpu.converged[0])
    assert torch.equal(card.iterations.cpu(), cpu.iterations)
    assert _rel(card.x.cpu(), cpu.x) < 1e-8


def test_assoc_sweep_launches_factor_only(cuda):
    """A block solve with sweep_method='assoc' on the card factors with
    tridiag_factor and sweeps with the doubling scan: the sweep kernels
    stay at 0, and X/U match the 'scan' solve of the same QP."""
    from centroidal_mpc_tpu_torch.ops import blockqp
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    qp = _mini_f64(cuda)[1]
    st = QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=2000,
                    adaptive_rho=False)
    scan = blockqp.solve_block_qp(qp, st)
    before = dict(bt.launches)
    assoc = blockqp.solve_block_qp(
        qp, dataclasses.replace(st, sweep_method="assoc"))
    torch.cuda.synchronize()
    assert bt.launches["tridiag_factor"] > before["tridiag_factor"]
    assert bt.launches["tridiag_fwd"] == before["tridiag_fwd"]
    assert bt.launches["tridiag_bwd"] == before["tridiag_bwd"]
    assert torch.equal(assoc.iterations, scan.iterations)
    assert _rel(assoc.U, scan.U) < 1e-8


def test_dare_function_jacobian_on_card_matches_cpu(cuda):
    """torch.func.jacrev through ops.lqr_kernel.lqr_gain on the card (the
    forward launches dare_lqr, the backward differentiates the plain
    version) equals the CPU's in f64."""
    rng = np.random.default_rng(5)
    A = np.eye(9) + 0.05 * rng.standard_normal((4, 9, 9))
    B = 0.05 * rng.standard_normal((4, 9, 12))
    Q, R = np.diag(rng.uniform(1, 10, 9)), np.diag(rng.uniform(0.1, 1, 12))

    def jac(device):
        args = [torch.as_tensor(a, device=device) for a in (Q, R, A, B)]
        return torch.func.jacrev(lqr_kernel.lqr_gain, argnums=(2, 3))(
            *args, 2)
    count = lqr_kernel.launches["dare_lqr"]
    card = jac(cuda)
    torch.cuda.synchronize()
    assert lqr_kernel.launches["dare_lqr"] > count
    for g, r in zip(card, jac("cpu")):
        assert _rel(g.cpu(), r) < 1e-9
