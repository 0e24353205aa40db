"""Exact chance-constraint linearization (the reference's intended math),
batch-first.

Port of `centroidal_mpc_tpu/solver/stochastic.py`.  The reference
linearizes the friction chance-constraint back-offs
xi * 2 G sqrt((K Sigma K')_jj) through dSigma/d(x, u) tensors that are
identically zero (src/centroidal_model.py:239-240,
src/constraints.py:187-214), so only the constant back-off survives; the
default stochastic mode (`solver/ocp._chance_backoffs`) replicates that.

Here `backoff_jacobians` differentiates the true back-off function --
through the closed-loop covariance recursion and the dependence of A, B,
C and the LQR gains K on the trajectory -- with one `torch.func.jacrev`
over the whole horizon, and `apply_exact_backoffs` adds the row
coefficients and bound shifts in the reference's own form:

    A[idx, z] += xi * J,   ub[idx] += xi * (J @ zbar) - backoff(zbar)

The gains come from `models/centroidal.lqr_gain`, whose autograd.Function
launches the DARE kernel on the card and differentiates its plain
version.  Cost: one reverse pass per back-off row (N*C*5 outputs, all
lanes at once), a validation path, not a throughput one.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import (CentroidalModel,
                                                        compute_trajectory_data)
from centroidal_mpc_tpu_torch.solver.ocp import (N_X, OcpConfig, QPData,
                                                 _offsets, qp_dims,
                                                 rotated_pyramid)


def backoff_values(model: CentroidalModel, schedule: ContactSchedule,
                   cfg: OcpConfig, X: torch.Tensor,
                   U: torch.Tensor) -> torch.Tensor:
    """(B, N, C, 5) chance-constraint back-offs at trajectories X (B, N+1,
    nx), U (B, N, nu); cfg carries the leading B axis.

    b_kcr = xi * sum_j gate * 2 G_kcrj sqrt((K_k Sigma_k K_k')_jj), zero at
    knot 0 (reference src/constraints.py:187-214).  Differentiable in
    (X, U) through the full covariance recursion; the active-set gate is
    held constant."""
    data = compute_trajectory_data(model, schedule, X, U)
    rot_pyr = rotated_pyramid(cfg, schedule)                 # (B, N, C, 5, 3)
    nb, N, C = rot_pyr.shape[:3]
    nuc = model.n_u_per_contact
    K_full = data.K.reshape(nb, N, C, nuc, N_X)
    K_c = K_full[:, :, :, 2:5] if nuc == 6 else K_full
    KS = torch.einsum("bkcjx,bkxy->bkcjy", K_c, data.Sigma[:, :N])
    ksk_diag = torch.einsum("bkcjy,bkcjy->bkcj", KS, K_c)
    sqrt_ksk = torch.sqrt(ksk_diag.clamp(min=1e-16))[:, :, :, None, :]
    # the JAX package's slice, kept as is: on a wrench6 robot it keeps the
    # z column of the 3-column pyramid
    G = rot_pyr[..., 2:5] if nuc == 6 else rot_pyr
    gate = ((G > 1e-6) & (sqrt_ksk > 1e-6)).to(G.dtype).detach()
    backoff = (cfg.xi[:, None, None, None] * 2.0
               * (G * sqrt_ksk * gate).sum(-1))
    # no back-off at knot 0 (reference src/constraints.py:187 `time_idx>0`)
    knots = torch.ones(N, dtype=backoff.dtype, device=backoff.device)
    knots[0] = 0.0
    return backoff * knots[:, None, None]


def backoff_jacobians(model: CentroidalModel, schedule: ContactSchedule,
                      cfg: OcpConfig, X: torch.Tensor, U: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(b, dB_dX, dB_dU): back-offs and their exact trajectory Jacobians,
    lane by lane.  Shapes: b (B, N, C, 5); dB_dX (B, N, C, 5, N+1, nx);
    dB_dU (B, N, C, 5, N, nu).

    Lanes are independent, so one jacrev of the lane sum gives every
    lane's Jacobian (N*C*5 reverse passes whatever B is)."""
    b = backoff_values(model, schedule, cfg, X, U)
    jx, ju = torch.func.jacrev(
        lambda x, u: backoff_values(model, schedule, cfg, x, u).sum(0),
        argnums=(0, 1))(X, U)
    # (N, C, 5, B, ...) -> (B, N, C, 5, ...)
    return b, jx.movedim(3, 0), ju.movedim(3, 0)


def apply_exact_backoffs(qp: QPData, model: CentroidalModel,
                         schedule: ContactSchedule, cfg: OcpConfig,
                         X: torch.Tensor, U: torch.Tensor) -> QPData:
    """Add the exact back-off linearization to a batch of dense nominal
    QPs (`solver/ocp.build_qp` with cfg.stochastic=False), whose friction
    rows read G u <= 0: row += J and ub += J zbar - b, so the constraint
    reads G u + J (z - zbar) <= -b(zbar).  Returns new QPData; `qp` is
    left as it is."""
    nb, N = U.shape[0], U.shape[1]
    nx, nu, C = N_X, model.n_u, model.n_contacts
    _, segs = qp_dims(model, N)
    off_row, _ = _offsets(segs)
    b, dB_dX, dB_dU = backoff_jacobians(model, schedule, cfg, X, U)
    dev = X.device
    rows = (off_row["friction"]
            + torch.arange(C, device=dev)[None, :, None] * (5 * N)
            + torch.arange(N, device=dev)[:, None, None] * 5
            + torch.arange(5, device=dev)).reshape(-1)      # (N*C*5,)
    jx = dB_dX.reshape(nb, N * C * 5, (N + 1) * nx)
    ju = dB_dU.reshape(nb, N * C * 5, N * nu)
    # the Jacobians' row order is knot-major; the rows above follow it
    A = qp.A.clone()
    A[:, rows, :(N + 1) * nx] += jx
    A[:, rows, (N + 1) * nx:(N + 1) * nx + N * nu] += ju
    shift = (jx @ X.reshape(nb, -1, 1) + ju @ U.reshape(nb, -1, 1))[..., 0]
    u = qp.u.clone()
    u[:, rows] += shift - b.reshape(nb, -1)
    return dataclasses.replace(qp, A=A, u=u)
