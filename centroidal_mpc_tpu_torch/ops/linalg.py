"""Matmul-only linear-algebra primitives.

Port of `centroidal_mpc_tpu/ops/linalg.py`: the Jacobi-scaled
Newton-Schulz inverse of a symmetric positive-definite matrix, batched
over leading axes, which the block-Thomas factor of `ops/blockqp.py`
uses for its Schur complements and the iLQR of `solver/ddp.py` for its
Quu.  Also `solve`, a dense solve whose derivatives hold under
`torch.func` (the rigid-body dynamics differentiate through it).
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


class _Solve(torch.autograd.Function):
    """torch.linalg.solve with its own forward- and reverse-mode rules.

    Under `vmap(jacfwd(f))` (a batch of knots, then a batch of tangents)
    PyTorch's own forward-mode rule for `linalg.solve` returns wrong
    tangents, without an error, as soon as the batch's matrices pivot
    differently (torch 2.13, CPU): its `lu_solve` of the tangent pairs
    the pivots of one level of batching with the right-hand sides of
    another.  Here the tangent dx = A^-1 (db - dA x) is one more solve,
    whose batching is PyTorch's own and correct."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, b):
        return torch.linalg.solve_ex(A, b)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _ = inputs
        ctx.save_for_forward(A, output)
        ctx.save_for_backward(A, output)

    @staticmethod
    def jvp(ctx, dA, db):
        A, x = ctx.saved_tensors
        rhs = torch.zeros_like(x) if db is None else db
        if dA is not None:
            rhs = rhs - dA @ x
        return _Solve.apply(A, rhs)

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        gb = _Solve.apply(A.mT, g)
        return -gb @ x.mT, gb


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for A (..., n, n), b (..., n, k), with derivatives
    that hold under `torch.func` (see `_Solve`).  As `jnp.linalg.solve`,
    a singular A gives inf/NaN instead of an error, and no call waits for
    the device to report one (`torch.linalg.solve_ex`)."""
    return _Solve.apply(A, b)
