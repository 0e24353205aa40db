"""Random scaled block-QP coefficients at the robots' shapes, for the
tests of the constraint operator A, A' (`ops.constraint_apply` and the
plain versions in `ops.blockqp`).  Imports no JAX, so that the card's
tests can use it too."""
import torch

from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops import constraint_apply as ca

NX = 9
# robot: (contacts C, entries a contact nuc, live CoP rows)
ROBOTS = {"solo12": (4, 3, False), "bolt": (2, 3, False),
          "talos": (2, 6, True)}


def random_scaled(robot, B, N, dtype=torch.float64, device="cpu", seed=0):
    """A `_Scaled` with random coefficient blocks of the robot's shapes
    (the fields A and A' do not read are None).  The point-foot robots'
    CoP coefficients are zero, as `build_block_qp` makes them; talos's
    wrench6 feet have live ones."""
    C, nuc, live_cop = ROBOTS[robot]
    nu = C * nuc
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, positive=False):
        a = torch.randn((B,) + shape, generator=g, dtype=torch.float64)
        a = a.abs() + 0.1 if positive else a
        return a.to(dtype=dtype, device=device)

    coph = rnd(N, C, 2) if live_cop else torch.zeros(
        (B, N, C, 2), dtype=dtype, device=device)
    return tbq._Scaled(
        Px=None, Pu=None, q=None, d0=rnd(NX, positive=True),
        Ah=rnd(N, NX, NX), Bh=rnd(N, NX, nu), Ih=rnd(N, NX, positive=True),
        dN=rnd(NX, positive=True), Gh=rnd(N, C, 5, nuc), coph=coph,
        Th=rnd(N + 1, 8, 3), wh=rnd(N + 1, 8, positive=True),
        sh=rnd(N + 1, positive=True), l=None, u=None, D=None, E=None,
        c=None)


def random_w(s, seed=1):
    """A random variable-space vector for s, packed (B, N+1, V) as the
    ADMM carries it, its dummy control slot zero."""
    B, N, nx, nu = s.Ah.shape[0], s.Ah.shape[1], NX, s.Bh.shape[-1]
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((B, N + 1, nx + nu + 1), generator=g,
                    dtype=torch.float64).to(s.Ah)
    W[:, -1, nx:-1] = 0
    return W


def random_z(s, seed=2, pad=0):
    """A random constraint-space vector for s, one lane-major (B, m)
    buffer; pad > 0: the first m columns of a (B, m + pad) one, so that
    its lanes lie m + pad apart."""
    B, N = s.Ah.shape[0], s.Ah.shape[1]
    m = ca._zwidth(N, s.Gh.shape[2])
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, m + pad), generator=g,
                       dtype=torch.float64).to(s.Ah)[:, :m]


def dot(a, b) -> float:
    """<a, b> over every entry, in float64."""
    return float((a.double() * b.double()).sum())
