"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These need an NVIDIA GPU with nvcc and skip without one; on the
card run them (this file imports no JAX, so skip the JAX test conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
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
# has no coupling block (the factor then skips its second launch)
SHAPES = [(5, 7, 22), (3, 1, 13), (2, 0, 9), (32, 8, 22), (128, 50, 22),
          (4, 165, 22), (300, 50, 22), (3, 20, 31), (6, 30, 16)]


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
# and (16, 16) run the generic width
DARE_CASES = [(37, 9, 12, 0), (37, 9, 12, 2), (37, 9, 12, 30),
              (6400, 9, 12, 2), (41, 9, 6, 2), (41, 9, 6, 30),
              (1, 9, 12, 2), (3, 9, 6, 2), (5, 7, 10, 2), (3, 16, 16, 2)]


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
