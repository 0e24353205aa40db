"""Frozen yardstick: the work of the block-tridiagonal and DARE kernels
and the card's published peaks.

Copied from the program's `ops/cuda_lib.py` (Cost, tri),
`ops/block_tridiag.py` (sweep_cost, factor_cost), `ops/lqr_kernel.py`
(lqr_cost) and `chip_smoke.py` (the peaks and `bound`), so that a later
change to the program cannot move the bounds it is measured against.
Bytes count each input read once and each output written once, a
triangular or symmetric block as its lower triangle; flops count two a
multiply-add.
"""
from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12


class Cost(NamedTuple):
    bytes: int
    flops: int


def tri(n: int) -> int:
    """Entries of the lower triangle of an n x n block."""
    return n * (n + 1) // 2


def sweep_cost(B: int, n1: int, V: int, itemsize: int = 4) -> Cost:
    """One forward or backward block sweep over n1 knots of V x V blocks:
    the inverse diagonal factors (triangular), the couplings and the
    right-hand side in, the solution out."""
    n, t = n1 - 1, tri(V)
    return Cost(bytes=B * (n1 * t + n * V * V + 2 * n1 * V) * itemsize,
                flops=B * (n1 * 2 * t + n * (2 * V * V + V)))


def factor_cost(B: int, n1: int, V: int, itemsize: int = 4) -> Cost:
    """One blocked Cholesky factorization with pre-inverted factors: the
    diagonal (symmetric) and coupling blocks in, the inverse factors
    (triangular) and both coupling products out."""
    n, t = n1 - 1, tri(V)
    return Cost(bytes=B * (2 * n1 * t + 3 * n * V * V) * itemsize,
                flops=B * (n1 * 2 * V ** 3 // 3
                           + n * (4 * V * V * (V + 1) + t)))


def lqr_cost(S: int, nx: int, nu: int, n_iter: int = 2,
             itemsize: int = 4) -> Cost:
    """One launch of the truncated DARE over S problems, in the
    substitution form, which forms no H^-1: A, B and the symmetric Q, R
    in, K out.  Per gain step B'P, the symmetric H = R + B'P B, its
    Cholesky factor L (nu^3/3), B'PA and Y = L^-1 B'PA (nu^2 nx); per
    update the symmetric Q + (A'P) A and the symmetric P - Y'Y; then
    K = -L^-T Y by back substitution (nu^2 nx)."""
    gains = (2 * nu * nx * nx              # B'P
             + 2 * tri(nu) * nx + tri(nu)  # H = R + B'P B
             + nu ** 3 // 3                # Cholesky
             + 2 * nu * nx * nx            # B'PA
             + nu * nu * nx)               # Y = L^-1 B'PA
    update = (2 * nx ** 3 + 2 * tri(nx) * nx + tri(nx)  # Q + (A'P) A
              + 2 * tri(nx) * nu + tri(nx))             # P - Y'Y
    pairs = S * (nx * nx + 2 * nx * nu)    # A, B in and K out
    return Cost(bytes=(pairs + tri(nx) + tri(nu)) * itemsize,
                flops=S * ((n_iter + 1) * gains + n_iter * update
                           + nu * nu * nx))


def bound_s(cost: Cost) -> tuple[float, str]:
    """(seconds, what bounds them): the larger of the bytes over the HBM
    rate and the flops over the float32 rate."""
    t_bytes, t_ops = cost.bytes / PEAK_BYTES, cost.flops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
