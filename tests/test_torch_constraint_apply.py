"""The constraint operator A and its transpose A' of the block ADMM on
the CPU: the plain versions (`ops.blockqp._apply_A_plain`,
`_apply_AT_plain`) are adjoint at the three robots' shapes, the
dispatching `_apply_A` / `_apply_AT` run them on CPU tensors (bit for
bit, no kernel counted), the vectors' layout (`ops.blockqp._zviews`,
`_zflat`, `_Scaled.wvars`, `_wpacked`) gives back what it was given, and
`constraint_apply_cost` counts a product's work.  The kernels themselves
are held to the plain versions on the card
(`tests/test_torch_kernels_cuda.py`)."""
import pytest
import torch

from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops import constraint_apply as ca

from constraint_apply_cases import (ROBOTS, dot, random_scaled, random_w,
                                    random_z)
from test_torch_admm_graph import _block_qp


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_plain_versions_are_adjoint(robot):
    """<A w, z> = <w, A' z> to 1e-12 relative in float64."""
    s = random_scaled(robot, 3, 11)
    w, z = random_w(s), random_z(s)
    lhs = dot(tbq._apply_A_plain(s, w), z)
    rhs = dot(w, tbq._apply_AT_plain(s, z))
    scale = dot(tbq._apply_A_plain(s, w).abs(), z.abs())
    assert abs(lhs - rhs) <= 1e-12 * scale


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_cpu_tensors_take_the_plain_versions(robot, strided):
    """On CPU tensors `_apply_A` and `_apply_AT` equal the plain versions
    bit for bit (z also as a view whose lanes lie further apart than its
    rows) and launch no kernel; A' gives a packed W with a zero dummy
    control slot."""
    s = random_scaled(robot, 2, 7)
    w, z = random_w(s), random_z(s, pad=5 if strided else 0)
    before = dict(ca.launches)
    for got, want in ((tbq._apply_A(s, w), tbq._apply_A_plain(s, w)),
                      (tbq._apply_AT(s, z), tbq._apply_AT_plain(s, z))):
        assert torch.equal(got, want)
    assert tbq._apply_A(s, w).shape == z.shape
    assert not tbq._apply_AT(s, z)[:, -1, 9:-1].any()
    assert ca.launches == before


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_vector_layout_round_trip(robot):
    """A (B, m) buffer's groups are views of it in `ZGroups` field order
    at their shapes, and flattened give it back; groups flattened and
    viewed again are themselves; a packed W's x, u and t are views of it
    and packed give it back; a cold dual is zero groups of one buffer."""
    B, N = 3, 7
    s = random_scaled(robot, B, N)
    C = s.Gh.shape[2]
    shapes = ((9,), (N, 9), (9,), (N, C, 2), (N, C, 5), (N + 1, 8),
              (N + 1,))
    z = random_z(s)
    g = s.zgroups(z)
    assert [tuple(a.shape) for a in g] == [(B,) + sh for sh in shapes]
    assert torch.equal(tbq._zflat(g), z)
    g.dyn[1, 2, 3] = 42.0                       # a view: writes z
    assert float(z[1, 9 + 2 * 9 + 3]) == 42.0
    groups = tbq.ZGroups(*(torch.randn((B,) + sh, dtype=torch.float64)
                           for sh in shapes))
    for a, b in zip(tbq._zviews(tbq._zflat(groups), N, C), groups):
        assert torch.equal(a, b)
    W = random_w(s)
    w = s.wvars(W)
    assert [tuple(a.shape) for a in w] == [(B, N + 1, 9),
                                           (B, N, C * s.Gh.shape[4]),
                                           (B, N + 1)]
    assert torch.equal(tbq._wpacked(w), W)
    w.u[0, 0, 0] = 7.0                          # a view: writes W
    assert float(W[0, 0, 9]) == 7.0
    cold = tbq.zero_zgroups(B, N, C, torch.float64, "cpu")
    assert torch.equal(tbq._zflat(cold), torch.zeros_like(z))


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_kernel_wrappers_refuse_cpu_tensors(robot):
    """The wrappers launch or raise: CPU tensors are refused, never
    computed another way."""
    s = random_scaled(robot, 2, 4)
    coef = tbq._coefficients(s)
    with pytest.raises(ValueError, match="CUDA"):
        ca.apply_A(coef, *s.wvars(random_w(s)))
    with pytest.raises(ValueError, match="CUDA"):
        ca.apply_AT(coef, random_z(s))


def test_scaled_coefficients_are_contiguous_without_scaling():
    """`_ruiz` hands the kernels contiguous coefficient blocks, also with
    no scaling iteration (Th and wh start as broadcast views)."""
    qp, _ = _block_qp(presets.SOLO12_TROT_MINI, 2, "cpu", torch.float64)
    for iters in (0, 1):
        s = tbq._ruiz(qp, iters)
        for name in ca.COEFFICIENTS:
            assert getattr(s, name).is_contiguous(), (iters, name)


def test_constraint_apply_cost_at_the_b1024_cell():
    """Bytes and flops of one product at trot165_b1024 (B=1024, N=165,
    solo12, f32), written out: the four large blocks (Ah 54.7 MB, Bh
    73.0, Gh 40.6, Th 16.3) and every other tensor once."""
    B, N, nx, nu, C, nuc = 1024, 165, 9, 12, 4, 3
    cost = ca.constraint_apply_cost(B, N, nx, nu, C, nuc)
    large = B * (N * (81 + 108 + 60) + (N + 1) * 24) * 4
    assert large == 184_602_624
    coef = (B * (N * (81 + 108 + 60) + (N + 1) * 24)
            + B * N * (9 + 8)            # Ih, coph
            + B * (N + 1) * (8 + 1)      # wh, sh
            + B * 2 * 9)                 # d0, dN
    w = B * ((N + 1) * 9 + N * 12 + (N + 1))
    z = B * (2 * 9 + N * (9 + 8 + 20) + (N + 1) * (8 + 1))
    assert cost.bytes == (coef + w + z) * 4 == 248_393_728
    assert cost.flops == 2 * coef
    assert cost.layout_bytes == cost.bytes
    assert ca.constraint_apply_cost(B, N, nx, nu, C, nuc, 8).bytes == \
        2 * cost.bytes


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_cost_counts_each_tensor_of_a_product(robot):
    """The cost's bytes are the elements of every tensor a product reads
    or writes, at each robot's shapes."""
    B, N = 3, 5
    s = random_scaled(robot, B, N)
    w, z = random_w(s), random_z(s)
    elems = sum(t.numel()
                for t in (*tbq._coefficients(s), *s.wvars(w), z))
    C, nuc, _ = ROBOTS[robot]
    cost = ca.constraint_apply_cost(B, N, 9, C * nuc, C, nuc, 8)
    assert cost.bytes == 8 * elems
    assert cost.flops == 2 * sum(t.numel() for t in tbq._coefficients(s))
