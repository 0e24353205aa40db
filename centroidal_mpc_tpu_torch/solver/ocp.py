"""QP assembly for one SCP subproblem, batch-first.

Port of `centroidal_mpc_tpu/solver/ocp.py`: the sentinel infinity, the
dynamics-row slack, the friction pyramid, the L1 trust-region sign
enumeration, `OcpConfig`, the chance-constraint back-offs and the dense
OSQP-form assembly `build_qp`

    min 1/2 z' P z + q' z    s.t.  l <= A z <= u

in the reference's decision-vector layout (src/centroidal_model.py:25-26)

    z = [ X (knot-major, nx*(N+1)) | U (knot-major, nu*N)
        | t_state (N+1) | t_ctrl (N) ]

and row order (src/scp_solver.py:28-48)

    [ initial (nx) | dynamics (nx*N) | final (nx) | cop (wrench6 only)
    | friction (C*5*N) | trust-l1 (2^3*(N+1)) | trust-slack (N+1) ]

Every scenario of a batch gets its own (P, q, A, l, u) on a leading B
axis; the per-knot blocks are written by vectorized index scatters over
knots and contacts, as the JAX package writes them with `.at[].set`.
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
    # built where it is used: a copy from the host would wait for the
    # card's queue to drain
    rows = torch.arange(2**n, device=device)[:, None]
    cols = 2 ** torch.arange(n, device=device)[None, :]
    return (1 - 2 * ((rows // cols) % 2)).to(dtype)


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


@dataclasses.dataclass(frozen=True)
class QPData:
    """Dense OSQP-form problem data of B scenarios: P (B, n, n), q (B, n),
    A (B, m, n), l (B, m), u (B, m)."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor


def qp_dims(model, N: int):
    """(n_vars, row-segment sizes) of the reference dense layout."""
    nx, nu, c = N_X, model.n_u, model.n_contacts
    n = nx * (N + 1) + nu * N + (N + 1) + N
    m_cop = 2 * c * N if model.contact_model != POINT3 else 0
    segs = dict(initial=nx, dynamics=nx * N, final=nx, cop=m_cop,
                friction=c * 5 * N, trust=8 * (N + 1), slack=N + 1)
    return n, segs


def _offsets(segs):
    off, acc = {}, 0
    for k, v in segs.items():
        off[k] = acc
        acc += v
    return off, acc


def per_lane(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) value as a (B,) tensor of like's dtype/device."""
    if isinstance(v, (int, float)):
        # a fill on the card: a copy from the host would wait for its queue
        return torch.full(like.shape[:1], v, dtype=like.dtype,
                          device=like.device)
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.expand(like.shape[0])


def rotated_pyramid(cfg: OcpConfig, schedule) -> torch.Tensor:
    """G R' per contact and knot, gated by the contact logic: (B, N, C,
    5, 3).  The reference fills only the 4 tangential rows
    (src/constraints.py:180), so the unilateral row is zero unless
    cfg.fill_unilateral."""
    rot_pyr = torch.einsum("bri,kcji->bkcrj", cfg.pyramid,
                           schedule.orientation)
    rot_pyr = rot_pyr * schedule.logic[:, :, None, None]
    if not cfg.fill_unilateral:
        rot_pyr[..., 4, :] = 0.0
    return rot_pyr


def build_qp(model, schedule, cfg: OcpConfig, X_prev: torch.Tensor,
             U_prev: torch.Tensor, data, radius, weight) -> QPData:
    """Assemble the dense QP of every scenario for one SCP iteration.

    cfg, X_prev (B, N+1, nx), U_prev (B, N, nu) and data carry the
    leading B axis; radius and weight (the trust-region state) are
    scalars or (B,), so the `-1/weight` slack entries are per lane.  A
    stochastic cfg lowers the friction upper bounds by the chance
    back-offs of data.K and data.Sigma."""
    nb, N = U_prev.shape[0], U_prev.shape[1]
    nx, nu, C = N_X, model.n_u, model.n_contacts
    nuc = model.n_u_per_contact
    dtype, dev = X_prev.dtype, X_prev.device
    n, segs = qp_dims(model, N)
    off_row, m = _offsets(segs)
    off_u = nx * (N + 1)
    off_tx = off_u + nu * N

    def ar(k):
        return torch.arange(k, device=dev)

    # ---------------- cost ----------------
    # block-diagonal per-knot weights (reference src/cost.py:9-16)
    P = torch.zeros((nb, n, n), dtype=dtype, device=dev)
    kx = ar(N + 1)[:, None, None] * nx
    P[:, kx + ar(nx)[:, None], kx + ar(nx)] = cfg.Wx[:, None].expand(
        nb, N + 1, nx, nx)
    ku = off_u + ar(N)[:, None, None] * nu
    P[:, ku + ar(nu)[:, None], ku + ar(nu)] = cfg.Wu[:, None].expand(
        nb, N, nu, nu)
    q = torch.zeros((nb, n), dtype=dtype, device=dev)
    if cfg.track_state:
        # -Wx @ x_ref per knot (reference src/cost.py:21-29)
        q[:, :off_u] = (-(cfg.X_track @ cfg.Wx.mT)).reshape(nb, -1)
    # L1 exact-penalty cost on the state slacks (src/cost.py:34-39)
    q[:, off_tx:off_tx + N + 1] = 1.0

    A = torch.zeros((nb, m, n), dtype=dtype, device=dev)
    l = torch.full((nb, m), -INF, dtype=dtype, device=dev)
    u = torch.full((nb, m), INF, dtype=dtype, device=dev)
    eye_nx = torch.eye(nx, dtype=dtype, device=dev)

    # ---------------- boundary conditions ----------------
    r0 = off_row["initial"]
    A[:, r0:r0 + nx, 0:nx] = eye_nx
    l[:, r0:r0 + nx] = cfg.x_init
    u[:, r0:r0 + nx] = cfg.x_init
    rf = off_row["final"]
    A[:, rf:rf + nx, N * nx:(N + 1) * nx] = eye_nx
    if cfg.terminal_equality:
        l[:, rf:rf + nx] = cfg.x_final
        u[:, rf:rf + nx] = cfg.x_final

    # ---------------- linearized dynamics ----------------
    # A_k x_k + B_k u_k - x_{k+1} = A_k xbar_k + B_k ubar_k - f_k
    # (reference src/constraints.py:36-49)
    rd = off_row["dynamics"]
    k_idx = ar(N)
    ri = (rd + k_idx * nx)[:, None, None] + ar(nx)[None, :, None]
    cxj = (k_idx * nx)[:, None, None] + ar(nx)[None, None, :]
    cuj = (off_u + k_idx * nu)[:, None, None] + ar(nu)[None, None, :]
    A[:, ri, cxj] = data.A
    A[:, ri, cuj] = data.B
    A[:, ri, cxj + nx] = -eye_nx
    resid = (torch.einsum("bkij,bkj->bki", data.A, X_prev[:, :-1])
             + torch.einsum("bkij,bkj->bki", data.B, U_prev)
             - data.f).reshape(nb, -1)
    l[:, rd:rd + nx * N] = resid - DYN_SLACK
    u[:, rd:rd + nx * N] = resid + DYN_SLACK

    # ---------------- CoP box (wrench6 only) ----------------
    if model.contact_model != POINT3:
        # per contact: N rows (cop_x) then N rows (cop_y)
        # (reference src/constraints.py:111-145); inactive rows 0 <= 0
        rc = off_row["cop"]
        act = schedule.logic.T                                   # (C, N)
        for axis in range(2):
            rows = rc + ar(C)[:, None] * 2 * N + axis * N + k_idx  # (C, N)
            cols = off_u + k_idx * nu + ar(C)[:, None] * nuc + axis
            A[:, rows, cols] = act
            lo = torch.where(act > 0, -cfg.cop_range[:, axis, 1, None, None],
                             torch.zeros_like(act))
            hi = torch.where(act > 0, cfg.cop_range[:, axis, 0, None, None],
                             torch.zeros_like(act))
            l[:, rows] = lo
            u[:, rows] = hi

    # ---------------- friction pyramid ----------------
    # contact blocks stacked contact-major, row k*5 + r within a block
    # (src/constraints.py:169-217)
    rfr = off_row["friction"]
    rot_pyr = rotated_pyramid(cfg, schedule)                # (B, N, C, 5, 3)
    fric_rows = (rfr + ar(C)[None, :, None] * (5 * N)
                 + k_idx[:, None, None] * 5 + ar(5))         # (N, C, 5)
    fric_cols = (off_u + k_idx[:, None, None] * nu
                 + (ar(C) * nuc + (0 if nuc == 3 else 2))[None, :, None]
                 + ar(3))                                    # (N, C, 3)
    A[:, fric_rows[..., None], fric_cols[:, :, None, :]] = rot_pyr
    ub_fric = torch.zeros((nb, N, C, 5), dtype=dtype, device=dev)
    if cfg.stochastic:
        ub_fric = ub_fric - _chance_backoffs(model, cfg, data, rot_pyr)
    u[:, fric_rows] = ub_fric    # lb stays -inf (src/constraints.py:217)

    # ---------------- state trust region (L1 exact penalty) -----------
    #   penum @ (x_ang - xbar_ang) - t_k / weight <= radius
    # (reference src/constraints.py:260-293)
    rt = off_row["trust"]
    penum = sign_enumeration_matrix(3, dtype, device=dev)      # (8, 3)
    kk = ar(N + 1)
    t_rows = rt + kk[:, None] * 8 + ar(8)                      # (N+1, 8)
    ang_cols = (kk * nx)[:, None] + 6 + ar(3)                  # (N+1, 3)
    A[:, t_rows[..., None], ang_cols[:, None, :]] = penum
    slack_cols = off_tx + kk                                   # (N+1,)
    A[:, t_rows, slack_cols[:, None]] = (
        -1.0 / per_lane(weight, X_prev))[:, None, None]
    ub_trust = (per_lane(radius, X_prev)[:, None, None]
                + X_prev[..., 6:9] @ penum.T)                  # (B, N+1, 8)
    u[:, rt:rt + 8 * (N + 1)] = ub_trust.reshape(nb, -1)
    # -t_k <= 0 (src/constraints.py:287-289)
    rs = off_row["slack"]
    A[:, rs + kk, slack_cols] = -1.0
    u[:, rs:rs + N + 1] = 0.0
    return QPData(P=P, q=q, A=A, l=l, u=u)


def _chance_backoffs(model, cfg: OcpConfig, data,
                     rot_pyr: torch.Tensor) -> torch.Tensor:
    """Individual chance-constraint back-offs xi * 2 G_ij sqrt((K S K')_jj),
    batch-first: data.K (B, N, nu, nx), data.Sigma (B, N+1, nx, nx),
    rot_pyr (B, N, C, 5, 3), cfg.xi (B,) -> (B, N, C, 5).

    The reference (src/constraints.py:187-214) also adds dSigma/dz terms
    built from gradient tensors that are identically zero, so only the
    constant back-off survives: per row i, the sum over force dims j with
    G_ij > 1e-6 and sqrt((K S K')_jj) > 1e-6, for knots k > 0.  A wrench6
    robot's force rows are rows 2:5 of each contact's K block."""
    nb, N, C = rot_pyr.shape[0], rot_pyr.shape[1], rot_pyr.shape[2]
    if model.contact_model == POINT3:
        K_c = data.K.reshape(nb, N, C, 3, N_X)
    else:
        K_c = data.K.reshape(nb, N, C, 6, N_X)[:, :, :, 2:5, :]
    KS = torch.einsum("bkcjx,bkxy->bkcjy", K_c, data.Sigma[:, :N])
    ksk_diag = torch.einsum("bkcjy,bkcjy->bkcj", KS, K_c)
    sqrt_ksk = torch.sqrt(ksk_diag.clamp(min=0.0))[:, :, :, None, :]
    G = rot_pyr
    gate = ((G > 1e-6) & (sqrt_ksk > 1e-6)).to(G.dtype)
    backoff = (cfg.xi[:, None, None, None] * 2.0
               * (G * sqrt_ksk * gate).sum(-1))
    # no back-off at knot 0 (reference src/constraints.py:187 `time_idx>0`)
    backoff[:, 0] = 0.0
    return backoff
