"""Batched truncated-DARE LQR gains.

Counterpart of `centroidal_mpc_tpu/ops/pallas_lqr.py`.  The CUDA kernel
`dare_lqr` (`csrc/dare_lqr.cu`) replaces its `pl.pallas_call`
(pallas_lqr.py:114, `_dare_kernel`): for S independent (A_s, B_s) pairs
with shared Q and R, n_iter steps of P <- Q + A'PA - A'PB H^-1 B'PA,
H = R + B'PB, then K = -H^-1 B'PA.  The kernel never forms H^-1: with
H = L L' it takes Y = L^-1 B'PA by forward substitution, P <- Q + A'PA -
Y'Y, and K = -L^-T Y by back substitution.

The plain PyTorch version below runs the same function through a
Cholesky inverse (not the JAX package's f64 Newton-Schulz chain).  On a
CPU tensor the wrapper runs it; on a CUDA tensor it launches the kernel
or raises.  `launches` counts kernel launches.  What bounds the kernel on
an H100 and how it is laid out is written at the top of the CUDA source.
"""
from __future__ import annotations

import torch

from centroidal_mpc_tpu_torch.ops import cuda_lib

launches = {"dare_lqr": 0}

MAX_DIM = 16   # nx, nu bound: the kernel's generic width


def lqr_gain_plain(Q: torch.Tensor, R: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, n_iter: int = 2) -> torch.Tensor:
    """Q (nx, nx), R (nu, nu), A (S, nx, nx), B (S, nx, nu) -> K (S, nu, nx)."""
    nu = B.shape[-1]
    eye = torch.eye(nu, dtype=A.dtype, device=A.device)
    P = Q.expand(A.shape)
    for it in range(n_iter + 1):
        BtP = B.mT @ P
        H = R + BtP @ B
        linv = torch.linalg.solve_triangular(torch.linalg.cholesky(H),
                                             eye.expand_as(H), upper=False)
        hinv = linv.mT @ linv
        BtPA = BtP @ A
        if it == n_iter:   # K uses H and B'PA of the n_iter-step P
            break
        P = (Q + (A.mT @ P) @ A) - (BtPA.mT @ hinv) @ BtPA
    return -(hinv @ BtPA)


def lqr_cost(S: int, nx: int, nu: int, n_iter: int = 2,
             itemsize: int = 4) -> cuda_lib.Cost:
    """Work of one launch (for bounds) in the substitution form, which
    forms no H^-1: A, B and the symmetric Q, R in, K out.  Per gain step
    B'P, the symmetric H = R + B'P B, its Cholesky factor L (nu^3/3),
    B'PA and Y = L^-1 B'PA (nu^2 nx); per update the symmetric
    Q + (A'P) A and the symmetric P - Y'Y; then K = -L^-T Y by back
    substitution (nu^2 nx).  A symmetric result counts its lower triangle
    only."""
    t = cuda_lib.tri
    gains = (2 * nu * nx * nx              # B'P
             + 2 * t(nu) * nx + t(nu)      # H = R + B'P B
             + nu ** 3 // 3                # Cholesky
             + 2 * nu * nx * nx            # B'PA
             + nu * nu * nx)               # Y = L^-1 B'PA
    update = (2 * nx ** 3 + 2 * t(nx) * nx + t(nx)  # Q + (A'P) A
              + 2 * t(nx) * nu + t(nx))             # P - Y'Y
    pairs = S * (nx * nx + 2 * nx * nu)    # A, B in and K out
    return cuda_lib.Cost(
        bytes=(pairs + t(nx) + t(nu)) * itemsize,
        flops=S * ((n_iter + 1) * gains + n_iter * update
                   + nu * nu * nx),
        layout_bytes=(pairs + nx * nx + nu * nu) * itemsize)


def lqr_gain_batched(Q: torch.Tensor, R: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, n_iter: int = 2) -> torch.Tensor:
    """K gains for S independent (A, B) pairs in one kernel launch."""
    if A.device.type == "cpu":
        return lqr_gain_plain(Q, R, A, B, n_iter)
    S, nx, nu = A.shape[0], A.shape[1], B.shape[-1]
    sfx = cuda_lib.check_args("dare_lqr", (A, (S, nx, nx)), (B, (S, nx, nu)),
                              (Q, (nx, nx)), (R, (nu, nu)))
    if max(nx, nu) > MAX_DIM or n_iter < 0:
        raise ValueError(f"dare_lqr: needs nx, nu <= {MAX_DIM} and "
                         f"n_iter >= 0 (nx={nx}, nu={nu}, n_iter={n_iter})")
    K = torch.empty((S, nu, nx), dtype=A.dtype, device=A.device)
    cuda_lib.launch("cmpc_dare_lqr", sfx, A.device, Q, R, A, B, K, S, nx,
                    nu, n_iter)
    launches["dare_lqr"] += 1
    return K
