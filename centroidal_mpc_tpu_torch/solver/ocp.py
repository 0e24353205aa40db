"""OCP constants and per-problem configuration.

Port of the part of `centroidal_mpc_tpu/solver/ocp.py` that the
block-structured QP path reads: the sentinel infinity, the dynamics-row
slack, the friction pyramid, the L1 trust-region sign enumeration,
`OcpConfig` and the reference-layout dimension count.  The dense QP
assembly (`build_qp`) and the chance-constraint back-offs are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config.robots import N_X, POINT3

INF = 1e20  # OSQP-style infinity; finite in float32

# Reference dynamics-row feasibility slack (src/constraints.py:45-47).
DYN_SLACK = 1e-12


def friction_pyramid_matrix(mu: float, dtype=torch.float64, *,
                            device) -> torch.Tensor:
    """Inner linear approximation of the friction cone, 5 rows:
    4 tangential + unilateral (reference src/utils.py:9-16)."""
    mu_lin = mu / np.sqrt(2.0)
    return torch.as_tensor(
        [[1.0, 0.0, -mu_lin],
         [-1.0, 0.0, -mu_lin],
         [0.0, 1.0, -mu_lin],
         [0.0, -1.0, -mu_lin],
         [0.0, 0.0, -1.0]], dtype=dtype, device=device)


def sign_enumeration_matrix(n: int, dtype=torch.float64, *,
                            device) -> torch.Tensor:
    """(2^n, n) matrix of +-1 sign patterns for the L1 trust region,
    column j = (-1)^(row // 2^j) (reference src/optimizer.py:111-112)."""
    rows = np.arange(2**n)[:, None]
    cols = 2 ** np.arange(n)[None, :]
    return torch.as_tensor((-1.0) ** (rows // cols), dtype=dtype,
                           device=device)


@dataclasses.dataclass(frozen=True)
class OcpConfig:
    """Per-problem data for QP assembly.  Under `parallel.batch` every
    tensor leaf carries a leading scenario axis B."""

    x_init: torch.Tensor          # (nx,)
    x_final: torch.Tensor         # (nx,)
    X_track: torch.Tensor         # (N+1, nx) tracking reference
    Wx: torch.Tensor              # (nx, nx) state cost weights
    Wu: torch.Tensor              # (nu, nu) control cost weights
    pyramid: torch.Tensor         # (5, 3) friction pyramid matrix
    xi: torch.Tensor              # chance-constraint quantile
    cop_range: torch.Tensor       # (2, 2): [[lxp, lxn], [lyp, lyn]]
    track_state: bool = True
    stochastic: bool = False
    # False relaxes the final-state equality to free rows (MPC windows)
    terminal_equality: bool = True
    # the reference leaves the unilateral (5th) pyramid row unfilled
    fill_unilateral: bool = False


def qp_dims(model, N: int):
    """(n_vars, row-segment sizes) of the reference dense layout."""
    nx, nu, c = N_X, model.n_u, model.n_contacts
    n = nx * (N + 1) + nu * N + (N + 1) + N
    m_cop = 2 * c * N if model.contact_model != POINT3 else 0
    segs = dict(initial=nx, dynamics=nx * N, final=nx, cop=m_cop,
                friction=c * 5 * N, trust=8 * (N + 1), slack=N + 1)
    return n, segs
