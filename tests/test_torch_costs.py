"""The work per kernel launch from which chip_smoke.py computes each
kernel's bound: pinned at the main path's shape, the layout bytes held
against the tensors a launch really reads and writes, and the counted
bytes against the structure of those tensors."""
import pytest
import torch

from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import lqr_kernel


def test_costs_at_the_main_path_shape():
    """B=128 scenarios, N=50 (51 knots), V=22, float32; the DARE on the
    128 x 50 (A, B) pairs of solo12 (nx 9, nu 12) with 2 iterations, and
    with the stochastic stage's 30 (substitution form, no H^-1).
    (bytes, flops, layout bytes)."""
    assert bt.sweep_cost(128, 51, 22) == (20_145_664, 9_639_168, 26_177_536)
    assert bt.factor_cost(128, 51, 22) == (50_383_872, 332_938_496,
                                           62_447_616)
    assert lqr_kernel.lqr_cost(6400, 9, 12, 2) == (7_603_692, 191_347_200,
                                                   7_604_100)
    assert lqr_kernel.lqr_cost(6400, 9, 12, 30) == (7_603_692,
                                                    2_105_203_200,
                                                    7_604_100)
    f64 = bt.sweep_cost(128, 51, 22, itemsize=8)
    assert (f64.bytes, f64.layout_bytes) == (2 * 20_145_664, 2 * 26_177_536)


def test_factor_halves_at_the_main_path_shape():
    """The factor's two launches at B=128, N=50, V=22, float32: their
    operations add up to the factor's, and their bytes exceed its bytes
    (W goes out of the chain and comes back into the couplings)."""
    chain = bt.factor_chain_cost(128, 51, 22)
    couple = bt.factor_couple_cost(128, 51, 22)
    assert chain == (37_993_472, 190_448_896, 50_057_216)
    assert couple == (43_777_536, 142_489_600, 49_809_408)
    whole = bt.factor_cost(128, 51, 22)
    assert chain.flops + couple.flops == whole.flops
    assert chain.bytes + couple.bytes >= whole.bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,n,v", [(3, 4, 7), (2, 0, 9)])
def test_factor_half_bytes_are_their_tensors(dtype, b, n, v):
    """Each half's layout bytes are the nbytes of its inputs and outputs;
    its counted bytes leave out the upper triangles of the diagonal blocks
    and of Cinv."""
    g = torch.Generator().manual_seed(1)
    r = torch.randn(b, n + 1, v, v, generator=g, dtype=dtype)
    diag = r @ r.mT + v * torch.eye(v, dtype=dtype)
    off = 0.1 * torch.randn(b, n, v, v, generator=g, dtype=dtype)
    size = dtype.itemsize
    cinv, w = bt.factor_chain_plain(diag, off)
    pfwd, pbwd = bt.factor_couple_plain(cinv, w)
    upper = b * (n + 1) * v * (v - 1) // 2 * size
    cost = bt.factor_chain_cost(b, n + 1, v, size)
    assert cost.layout_bytes == sum(t.nbytes for t in (diag, off, cinv, w))
    assert cost.bytes == cost.layout_bytes - 2 * upper
    cost = bt.factor_couple_cost(b, n + 1, v, size)
    assert cost.layout_bytes == sum(t.nbytes for t in (cinv, w, pfwd, pbwd))
    assert cost.bytes == cost.layout_bytes - upper


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,n,v", [(3, 4, 7), (2, 0, 9)])
def test_bytes_are_the_tensors_of_one_launch(dtype, b, n, v):
    """Each input once, each output once: the layout bytes are the nbytes
    of the tensors that the wrappers pass to the kernels (outputs as the
    plain versions give them); the counted bytes leave out the zeros
    above the diagonal of Cinv and the upper triangle of each symmetric
    block (the diagonal blocks, Q and R)."""
    g = torch.Generator().manual_seed(0)
    r = torch.randn(b, n + 1, v, v, generator=g, dtype=dtype)
    diag = r @ r.mT + v * torch.eye(v, dtype=dtype)
    off = 0.1 * torch.randn(b, n, v, v, generator=g, dtype=dtype)
    rhs = torch.randn(b, n + 1, v, generator=g, dtype=dtype)
    size = dtype.itemsize
    fac = bt.factor_plain(diag, off)
    out = bt.forward_sweep_plain(fac, rhs)
    assert torch.equal(fac.Cinv, fac.Cinv.tril())
    upper = b * (n + 1) * v * (v - 1) // 2 * size   # of one (B, N+1) stack
    cost = bt.factor_cost(b, n + 1, v, size)
    assert cost.layout_bytes == sum(t.nbytes for t in (diag, off, *fac))
    assert cost.bytes == cost.layout_bytes - 2 * upper
    cost = bt.sweep_cost(b, n + 1, v, size)
    assert cost.layout_bytes == sum(
        t.nbytes for t in (fac.Cinv, fac.Pfwd, rhs, out))
    assert cost.bytes == cost.layout_bytes - upper

    S, nx, nu = 5, 9, 12
    A = torch.eye(nx, dtype=dtype).expand(S, nx, nx)
    B = torch.ones(S, nx, nu, dtype=dtype)
    Q, R = torch.eye(nx, dtype=dtype), torch.eye(nu, dtype=dtype)
    K = lqr_kernel.lqr_gain_plain(Q, R, A, B, 0)
    cost = lqr_kernel.lqr_cost(S, nx, nu, 0, size)
    assert cost.layout_bytes == sum(
        t.nbytes for t in (Q, R, A.contiguous(), B, K))
    assert cost.bytes == cost.layout_bytes - (
        nx * (nx - 1) + nu * (nu - 1)) // 2 * size


def test_flops_grow_with_the_work():
    """Each added knot or iteration adds exactly its own operations: a
    knot of a sweep a triangular matvec, a coupled knot a dense matvec
    and V subtractions more."""
    f = [bt.sweep_cost(1, n1, 22).flops for n1 in (1, 2, 3)]
    assert f[0] == 22 * 23 and f[2] - f[1] == f[1] - f[0] == (
        22 * 23 + 2 * 22 * 22 + 22)
    d = [lqr_kernel.lqr_cost(1, 9, 12, it).flops for it in (0, 1, 2)]
    assert d[2] - d[1] == d[1] - d[0] > 0
    assert bt.factor_cost(2, 5, 8).flops == 2 * bt.factor_cost(1, 5, 8).flops
