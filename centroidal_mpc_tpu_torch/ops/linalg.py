"""Matmul-only linear-algebra primitives.

Port of `centroidal_mpc_tpu/ops/linalg.py`: the Jacobi-scaled
Newton-Schulz inverse of a symmetric positive-definite matrix, batched
over leading axes, which the block-Thomas factor of `ops/blockqp.py`
uses for its Schur complements.
"""
from __future__ import annotations

import torch


def spd_inverse(H: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Inverse of SPD matrices H (..., n, n) by Jacobi-scaled Newton-Schulz
    iteration X <- X (2I - H X), quadratically convergent.  Jacobi scaling
    D^-1/2 H D^-1/2 brings the spectrum near 1; the row-sum bound on
    lambda_max starts the iteration inside its basin (||I - X0 Ht|| < 1)."""
    d_isqrt = 1.0 / torch.sqrt(torch.diagonal(H, dim1=-2, dim2=-1))
    Ht = H * d_isqrt[..., :, None] * d_isqrt[..., None, :]
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    lam = Ht.abs().sum(-1).amax(-1)
    X = eye / lam[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - Ht @ X)
    return X * d_isqrt[..., :, None] * d_isqrt[..., None, :]


def spd_solve(H: torch.Tensor, B: torch.Tensor,
              iters: int = 16) -> torch.Tensor:
    """Solve H X = B for SPD H via `spd_inverse` (matmul-only)."""
    return spd_inverse(H, iters) @ B
