"""Structure-exploiting ADMM QP solver on per-knot blocks, batch-first.

Port of `centroidal_mpc_tpu/ops/blockqp.py` (`build_block_qp` with the
chance back-offs, and `_admm_loop_batched` with fixed or adaptive rho
and its refinement polish, with the 'cholesky'/'pallas' or 'thomas'
factor and the 'scan' or 'assoc' sweep).  The QP is the
same OSQP-form problem: decision variables per knot W = (N+1, V) with
V = nx + nu + 1 (state, control, trust slack; the control slot of knot N
is a padded dummy), the constraint operator A and A' applied by
`ops.constraint_apply` (a CUDA kernel a product on the card, batched
einsums on the CPU), and the block-tridiagonal ADMM normal matrix
M = P + sigma I + A' diag(rho) A factorized by `ops.block_tridiag`
(CUDA kernels on the card, their plain versions on the CPU) or, with
factor_method='thomas', by the block-Thomas recursion below (plain
PyTorch, as the JAX package's is XLA).

Every tensor carries a leading scenario axis B; per-scenario scalars
(residuals, step sizes, statuses) are (B,) tensors; inside the solve
every QP vector is one tensor, the packed W (its dummy slot zero) or a
(B, m) buffer of the `ZGroups` rows in field order.  The JAX package
runs this loop once for the whole vmapped batch and freezes converged
lanes by masking; the port does the same with `torch.where`, and leaves
the loop when no lane is active (one host sync per residual segment).  A segment has no host read, so on the card it is
captured once as a CUDA graph per device, shapes and settings, and
replayed (`_SegmentGraph`); on the CPU it runs eagerly.  The loop
counts its work in `ops.admm.counts` and opens the spans `qp.scale`,
`admm.factor`, `admm.segment`, `qp.polish` and one `sync.*` a blocking
host read (`utils.profiling.span`).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import NamedTuple, Optional

import torch

from centroidal_mpc_tpu_torch import _tree
from centroidal_mpc_tpu_torch._tree import select
from centroidal_mpc_tpu_torch.models.centroidal import (CentroidalModel,
                                                        TrajectoryData)
from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.ops.admm import (QPSettings, STATUS_MAX_ITER,
                                               STATUS_SOLVED,
                                               STATUS_PRIMAL_INFEASIBLE,
                                               STATUS_DUAL_INFEASIBLE,
                                               counts)
from centroidal_mpc_tpu_torch.ops import constraint_apply
from centroidal_mpc_tpu_torch.ops.block_tridiag import (_matvec,
                                                        factor_batched,
                                                        solve_assoc,
                                                        solve_batched)
from centroidal_mpc_tpu_torch.ops.linalg import spd_inverse
from centroidal_mpc_tpu_torch.solver.ocp import (DYN_SLACK, INF, OcpConfig,
                                                 N_X, _chance_backoffs,
                                                 per_lane, rotated_pyramid,
                                                 sign_enumeration_matrix)
from centroidal_mpc_tpu_torch.utils import profiling
from centroidal_mpc_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class BlockQP:
    """Block-structured QP data (unscaled), leading axis B.

    Cost: 1/2 x'Wx x + qx'x per state knot, 1/2 u'Wu u per control knot,
    qt't on trust slacks.  Constraints per group:
      init:  x_0 = x_init
      dyn:   A_k x_k + B_k u_k - x_{k+1} = r_k (+- DYN_SLACK)
      final: x_N in [final_l, final_u]
      fric:  G_kcr . u_force <= fric_ub   (5 rows/contact, inner pyramid)
      cop:   CoP box rows (wrench6; inert zero rows for point3)
      trust: penum x_ang - t/omega <= trust_ub
      slack: -t <= 0
    """

    Wx: torch.Tensor        # (B, nx, nx)
    Wu: torch.Tensor        # (B, nu, nu)
    qx: torch.Tensor        # (B, N+1, nx)
    qt: torch.Tensor        # (B, N+1)
    A: torch.Tensor         # (B, N, nx, nx)
    B: torch.Tensor         # (B, N, nx, nu)
    r_dyn: torch.Tensor     # (B, N, nx)
    x_init: torch.Tensor    # (B, nx)
    final_l: torch.Tensor   # (B, nx)
    final_u: torch.Tensor   # (B, nx)
    G: torch.Tensor         # (B, N, C, 5, nuc)
    fric_ub: torch.Tensor   # (B, N, C, 5)
    cop_act: torch.Tensor   # (B, N, C, 2)
    cop_l: torch.Tensor     # (B, N, C, 2)
    cop_u: torch.Tensor     # (B, N, C, 2)
    penum: torch.Tensor     # (8, 3), shared
    inv_omega: torch.Tensor  # (B,)
    trust_ub: torch.Tensor  # (B, N+1, 8)

    @property
    def horizon(self) -> int:
        return self.A.shape[1]

    @property
    def n_u(self) -> int:
        return self.B.shape[-1]


def build_block_qp(model: CentroidalModel, schedule: ContactSchedule,
                   cfg: OcpConfig, X_prev: torch.Tensor,
                   U_prev: torch.Tensor, data: TrajectoryData, radius,
                   weight) -> BlockQP:
    """Assemble the block QP of every scenario.  cfg, X_prev (B, N+1, nx),
    U_prev (B, N, nu) and data carry the leading B axis; radius and
    weight are scalars or (B,).  A stochastic cfg lowers the friction
    upper bounds by the chance back-offs of data.K and data.Sigma."""
    dtype, dev = X_prev.dtype, X_prev.device
    nb = X_prev.shape[0]
    nuc = model.n_u_per_contact
    rot_pyr = rotated_pyramid(cfg, schedule)
    N, C = rot_pyr.shape[1], rot_pyr.shape[2]
    fric_ub = torch.zeros((nb, N, C, 5), dtype=dtype, device=dev)
    if cfg.stochastic:
        fric_ub = fric_ub - _chance_backoffs(model, cfg, data, rot_pyr)
    zeros_cop = torch.zeros((nb, N, C, 2), dtype=dtype, device=dev)
    if nuc == 3:
        G = rot_pyr
        cop_act = cop_l = cop_u = zeros_cop
    else:  # wrench6: forces sit at columns 2:5; CoP box on columns 0:2
        G = torch.zeros((nb, N, C, 5, nuc), dtype=dtype, device=dev)
        G[..., 2:5] = rot_pyr
        cop_act = schedule.logic[None, :, :, None].expand(nb, N, C, 2)
        cr = cfg.cop_range
        lo = torch.stack([-cr[:, 0, 1], -cr[:, 1, 1]], dim=-1)[:, None, None]
        hi = torch.stack([cr[:, 0, 0], cr[:, 1, 0]], dim=-1)[:, None, None]
        cop_l = torch.where(cop_act > 0, lo, zeros_cop)
        cop_u = torch.where(cop_act > 0, hi, zeros_cop)
    qx = (-(cfg.X_track @ cfg.Wx.mT) if cfg.track_state
          else torch.zeros_like(X_prev))
    penum = sign_enumeration_matrix(3, dtype, device=dev)
    r_dyn = (torch.einsum("bkij,bkj->bki", data.A, X_prev[:, :-1])
             + torch.einsum("bkij,bkj->bki", data.B, U_prev) - data.f)
    radius = per_lane(radius, X_prev)
    return BlockQP(
        Wx=cfg.Wx, Wu=cfg.Wu, qx=qx,
        qt=torch.ones((nb, N + 1), dtype=dtype, device=dev),
        A=data.A, B=data.B, r_dyn=r_dyn, x_init=cfg.x_init,
        final_l=(cfg.x_final if cfg.terminal_equality
                 else torch.full_like(cfg.x_final, -INF)),
        final_u=(cfg.x_final if cfg.terminal_equality
                 else torch.full_like(cfg.x_final, INF)),
        G=G, fric_ub=fric_ub, cop_act=cop_act, cop_l=cop_l, cop_u=cop_u,
        penum=penum, inv_omega=1.0 / per_lane(weight, X_prev),
        trust_ub=radius[:, None, None] + X_prev[..., 6:9] @ penum.T,
    )


class ZGroups(NamedTuple):
    """Constraint-space vector, grouped by row family (reference row
    order: initial, dynamics, final, cop, friction, trust, slack)."""

    init: torch.Tensor    # (B, nx)
    dyn: torch.Tensor     # (B, N, nx)
    final: torch.Tensor   # (B, nx)
    cop: torch.Tensor     # (B, N, C, 2) -- zero rows for point3 robots
    fric: torch.Tensor    # (B, N, C, 5)
    trust: torch.Tensor   # (B, N+1, 8)
    slack: torch.Tensor   # (B, N+1)


def zero_zgroups(B: int, N: int, C: int, dtype, device) -> ZGroups:
    """Zero constraint-space vector (a cold dual warm start)."""
    m = sum(math.prod(sh) for sh in _zshapes(N, C))
    return _zviews(torch.zeros((B, m), dtype=dtype, device=device), N, C)


class WVars(NamedTuple):
    """Variable-space vector: states, controls, trust slacks."""

    x: torch.Tensor   # (B, N+1, nx)
    u: torch.Tensor   # (B, N, nu)
    t: torch.Tensor   # (B, N+1)


def _zshapes(N: int, C: int) -> tuple:
    """The shape of each `ZGroups` group of one lane, in field order."""
    return ((N_X,), (N, N_X), (N_X,), (N, C, 2), (N, C, 5), (N + 1, 8),
            (N + 1,))


def _zviews(z: torch.Tensor, N: int, C: int) -> ZGroups:
    """The groups of a lane-major (B, m) constraint-space buffer as views
    of it (dyn a (B, N, nx) view, and so on)."""
    shapes = _zshapes(N, C)
    parts = z.split([math.prod(sh) for sh in shapes], dim=1)
    return ZGroups(*(p.unflatten(1, sh) for p, sh in zip(parts, shapes)))


def _zflat(z: ZGroups) -> torch.Tensor:
    """One (B, m) buffer of a grouped constraint-space vector."""
    return torch.cat([g.flatten(1) for g in z], dim=1)


def _wpacked(w: WVars) -> torch.Tensor:
    """The packed (B, N+1, V) form of w, its dummy control slot of knot N
    zero (`_Scaled.wvars` gives x, u and t back as views of it)."""
    x, u, t = w
    nx = x.shape[-1]
    W = x.new_zeros(x.shape[:2] + (nx + u.shape[-1] + 1,))
    W[..., :nx], W[:, :-1, nx:-1], W[..., -1] = x, u, t
    return W


def _lane_absmax(a: torch.Tensor) -> torch.Tensor:
    """Per-lane inf-norm of a (B, ...) tensor."""
    return a.abs().flatten(1).amax(1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product of two (B, ...) tensors."""
    return (a * b).flatten(1).sum(1)


class _Scaled(NamedTuple):
    """Ruiz-scaled problem blocks.  Hatted quantities absorb both the row
    scaling E (per constraint) and column scaling D (per variable)."""

    Px: torch.Tensor       # (B, N+1, nx, nx) scaled state cost (includes c)
    Pu: torch.Tensor       # (B, N, nu, nu)
    q: torch.Tensor        # (B, N+1, V) scaled linear cost, packed
    d0: torch.Tensor       # (B, nx) init-row diagonal
    Ah: torch.Tensor       # (B, N, nx, nx)
    Bh: torch.Tensor       # (B, N, nx, nu)
    Ih: torch.Tensor       # (B, N, nx) diagonal coefficient of x_{k+1}
    dN: torch.Tensor       # (B, nx) final-row diagonal
    Gh: torch.Tensor       # (B, N, C, 5, nuc)
    coph: torch.Tensor     # (B, N, C, 2) scaled CoP row coefficients
    Th: torch.Tensor       # (B, N+1, 8, 3) trust rows on angular momentum
    wh: torch.Tensor       # (B, N+1, 8) trust-row slack coefficient
    sh: torch.Tensor       # (B, N+1) slack-row coefficient
    l: torch.Tensor        # (B, m) lower bounds
    u: torch.Tensor        # (B, m) upper bounds
    D: torch.Tensor        # (B, N+1, V) variable scaling, packed; its
                           # dummy slot 1, so that w / D keeps it zero
    E: torch.Tensor        # (B, m) row scaling
    c: torch.Tensor        # (B,) cost scaling

    def zgroups(self, z: torch.Tensor) -> ZGroups:
        """The groups of a (B, m) buffer of this problem, as views."""
        return _zviews(z, self.Ah.shape[1], self.Gh.shape[2])

    def wvars(self, W: torch.Tensor) -> WVars:
        """x, u and t of a packed variable-space vector, as views."""
        nx = self.Ah.shape[2]
        return WVars(x=W[..., :nx], u=W[:, :-1, nx:-1], t=W[..., -1])


def _apply_A_plain(s: _Scaled, W: torch.Tensor) -> torch.Tensor:
    x, u, t = s.wvars(W)
    nb, n = s.Ah.shape[0], s.Ah.shape[1]
    C, nuc = s.Gh.shape[2], s.Gh.shape[4]
    u_c = u.reshape(nb, n, C, nuc)
    return _zflat(ZGroups(
        init=s.d0 * x[:, 0],
        dyn=(torch.einsum("bkij,bkj->bki", s.Ah, x[:, :-1])
             + torch.einsum("bkij,bkj->bki", s.Bh, u) - s.Ih * x[:, 1:]),
        final=s.dN * x[:, -1],
        cop=s.coph * u_c[..., :2],
        fric=torch.einsum("bkcrj,bkcj->bkcr", s.Gh, u_c),
        trust=(torch.einsum("bkpj,bkj->bkp", s.Th, x[..., 6:9])
               - s.wh * t[..., None]),
        slack=-s.sh * t,
    ))


def _apply_AT_plain(s: _Scaled, z: torch.Tensor) -> torch.Tensor:
    z = s.zgroups(z)
    nb, n, nx = s.Ah.shape[0], s.Ah.shape[1], s.Ah.shape[2]
    C, nuc = s.Gh.shape[2], s.Gh.shape[4]
    x = torch.zeros((nb, n + 1, nx), dtype=z.dyn.dtype, device=z.dyn.device)
    x[:, 0] += s.d0 * z.init
    x[:, :-1] += torch.einsum("bkij,bki->bkj", s.Ah, z.dyn)
    x[:, 1:] += -s.Ih * z.dyn
    x[:, -1] += s.dN * z.final
    x[..., 6:9] += torch.einsum("bkpj,bkp->bkj", s.Th, z.trust)
    u = torch.einsum("bkij,bki->bkj", s.Bh, z.dyn)
    u_c = torch.einsum("bkcrj,bkcr->bkcj", s.Gh, z.fric)
    u_c[..., :2] += s.coph * z.cop
    u = u + u_c.reshape(nb, n, C * nuc)
    t = -(s.wh * z.trust).sum(-1) - s.sh * z.slack
    return _wpacked(WVars(x=x, u=u, t=t))


def _coefficients(s: _Scaled) -> tuple:
    return tuple(getattr(s, f) for f in constraint_apply.COEFFICIENTS)


def _apply_A(s: _Scaled, W: torch.Tensor) -> torch.Tensor:
    """z = A w, (B, m) from a packed W: one `constraint_apply` kernel for
    CUDA tensors, the plain einsums for CPU tensors."""
    if s.Ah.device.type == "cpu":
        return _apply_A_plain(s, W)
    return constraint_apply.apply_A(_coefficients(s), *s.wvars(W))


def _apply_AT(s: _Scaled, z: torch.Tensor) -> torch.Tensor:
    """w = A' z, packed, from a (B, m) z: one `constraint_apply_T` kernel
    for CUDA tensors, the plain einsums for CPU tensors."""
    if s.Ah.device.type == "cpu":
        return _apply_AT_plain(s, z)
    return constraint_apply.apply_AT(_coefficients(s), z)


def _row_norms(s: _Scaled) -> torch.Tensor:
    return _zflat(ZGroups(
        init=s.d0.abs(),
        dyn=torch.maximum(s.Ah.abs().amax(-1),
                          torch.maximum(s.Bh.abs().amax(-1), s.Ih.abs())),
        final=s.dN.abs(),
        cop=s.coph.abs(),
        fric=s.Gh.abs().amax(-1),
        trust=torch.maximum(s.Th.abs().amax(-1), s.wh),
        slack=s.sh,
    ))


def _col_norms(s: _Scaled) -> torch.Tensor:
    """Per-variable inf-norm over the stacked [P; A] columns, packed (the
    dummy slot 0)."""
    nb, n = s.Ah.shape[0], s.Ah.shape[1]
    C, nuc = s.Gh.shape[2], s.Gh.shape[4]
    cx = s.Px.abs().amax(2)                                # (B, N+1, nx)
    cx[:, :-1] = torch.maximum(cx[:, :-1], s.Ah.abs().amax(2))
    cx[:, 1:] = torch.maximum(cx[:, 1:], s.Ih.abs())
    cx[:, 0] = torch.maximum(cx[:, 0], s.d0.abs())
    cx[:, -1] = torch.maximum(cx[:, -1], s.dN.abs())
    cx[..., 6:9] = torch.maximum(cx[..., 6:9], s.Th.abs().amax(2))
    cu_c = s.Gh.abs().amax(3)                              # (B, N, C, nuc)
    cu_c[..., :2] = torch.maximum(cu_c[..., :2], s.coph.abs())
    cu = s.Pu.abs().amax(2)
    cu = torch.maximum(cu, cu_c.reshape(nb, n, C * nuc))
    cu = torch.maximum(cu, s.Bh.abs().amax(2))
    ct = torch.maximum(s.wh.amax(-1), s.sh)
    return _wpacked(WVars(x=cx, u=cu, t=ct))


def _ruiz(qp: BlockQP, iters: int) -> _Scaled:
    nb, N, nx, nu = qp.A.shape[0], qp.horizon, qp.A.shape[2], qp.n_u
    dtype, dev = qp.A.dtype, qp.A.device
    eps = torch.full((), DYN_SLACK, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones((nb,) + shape, dtype=dtype, device=dev)

    def full(like, v):
        return torch.full_like(like, v)

    l = _zflat(ZGroups(init=qp.x_init, dyn=qp.r_dyn - eps, final=qp.final_l,
                       cop=qp.cop_l, fric=full(qp.fric_ub, -INF),
                       trust=full(qp.trust_ub, -INF),
                       slack=full(qp.qt, -INF)))
    s = _Scaled(
        Px=qp.Wx[:, None].expand(nb, N + 1, nx, nx),
        Pu=qp.Wu[:, None].expand(nb, N, nu, nu),
        q=_wpacked(WVars(x=qp.qx, u=torch.zeros((nb, N, nu), dtype=dtype,
                                                device=dev), t=qp.qt)),
        d0=ones(nx), Ah=qp.A, Bh=qp.B, Ih=ones(N, nx), dN=ones(nx),
        Gh=qp.G, coph=qp.cop_act,
        Th=qp.penum.expand(nb, N + 1, 8, 3),
        wh=qp.inv_omega[:, None, None].expand(nb, N + 1, 8),
        sh=ones(N + 1),
        l=l,
        u=_zflat(ZGroups(init=qp.x_init, dyn=qp.r_dyn + eps,
                         final=qp.final_u, cop=qp.cop_u, fric=qp.fric_ub,
                         trust=qp.trust_ub, slack=torch.zeros_like(qp.qt))),
        D=ones(N + 1, nx + nu + 1), E=torch.ones_like(l), c=ones(),
    )

    def rescale(s: _Scaled, D: torch.Tensor, E: torch.Tensor) -> _Scaled:
        d, e = s.wvars(D), s.zgroups(E)
        C, nuc = s.Gh.shape[2], s.Gh.shape[4]
        du_f = d.u.reshape(nb, N, C, nuc)
        return s._replace(
            Px=s.Px * d.x[..., :, None] * d.x[..., None, :],
            Pu=s.Pu * d.u[..., :, None] * d.u[..., None, :],
            q=s.q * D,
            d0=s.d0 * e.init * d.x[:, 0],
            Ah=s.Ah * e.dyn[..., None] * d.x[:, :-1, None, :],
            Bh=s.Bh * e.dyn[..., None] * d.u[:, :, None, :],
            Ih=s.Ih * e.dyn * d.x[:, 1:],
            dN=s.dN * e.final * d.x[:, -1],
            Gh=s.Gh * e.fric[..., None] * du_f[..., None, :],
            coph=s.coph * e.cop * du_f[..., :2],
            Th=s.Th * e.trust[..., None] * d.x[:, :, None, 6:9],
            wh=s.wh * e.trust * d.t[..., None],
            sh=s.sh * e.slack * d.t,
            l=s.l * E, u=s.u * E, D=s.D * D, E=s.E * E,
        )

    def inv_sqrt(a):
        return 1.0 / torch.sqrt(torch.where(a > 0, a, torch.ones_like(a)))

    n_dense = (nx * (N + 1) + nu * N) + (N + 1) + N
    for _ in range(iters):
        # column and row norms both from the SAME current scaled problem,
        # applied together (the OSQP iteration)
        s = rescale(s, inv_sqrt(_col_norms(s)), inv_sqrt(_row_norms(s)))
        # cost normalization: gamma = 1/max(mean |P| col norm, |q|_inf),
        # the mean over the full dense variable count
        p_sum = (s.Px.abs().amax(2).flatten(1).sum(1)
                 + s.Pu.abs().amax(2).flatten(1).sum(1))
        gamma_den = torch.maximum(p_sum / n_dense, _lane_absmax(s.q))
        gamma = 1.0 / torch.where(gamma_den > 0, gamma_den,
                                  torch.ones_like(gamma_den))
        s = s._replace(Px=s.Px * gamma[:, None, None, None],
                       Pu=s.Pu * gamma[:, None, None, None],
                       q=gamma[:, None, None] * s.q, c=s.c * gamma)
    # the constraint kernels take contiguous blocks (without scaling
    # iterations Th, wh are still broadcast views)
    return s._replace(**{f: getattr(s, f).contiguous()
                         for f in constraint_apply.COEFFICIENTS})


def _rho_rows(settings: QPSettings, rho: torch.Tensor,
              s: _Scaled) -> torch.Tensor:
    """Per-row ADMM step sizes (B, m) from per-lane rho (B,): rho times
    a row factor, eq_rho_scale on the equality rows (init, dyn, final)
    and 1 elsewhere."""
    scale = torch.ones_like(s.l[:1])
    for rows in s.zgroups(scale)[:3]:
        rows.fill_(settings.eq_rho_scale)
    return rho[:, None] * scale


def _assemble_blocks(s: _Scaled, r: torch.Tensor, sigma: float):
    """Block-tridiagonal M = P + sigma I + A' diag(rho) A for per-row step
    sizes r (B, m).  Returns (diag (B, N+1, V, V), off (B, N, V, V)) with
    per-knot variable order [x (nx), u (nu), t (1)]; the control slot of
    knot N is a padded dummy with unit diagonal."""
    nb, N, nx, nu = s.Ah.shape[0], s.Ah.shape[1], s.Ah.shape[2], s.Bh.shape[-1]
    V = nx + nu + 1
    dtype, dev = s.Ah.dtype, s.Ah.device
    C, nuc = s.Gh.shape[2], s.Gh.shape[4]
    xs, us = slice(0, nx), slice(nx, nx + nu)
    r = s.zgroups(r)
    eye_nx = torch.eye(nx, dtype=dtype, device=dev)

    diag = (torch.zeros((nb, N + 1, V, V), dtype=dtype, device=dev)
            + sigma * torch.eye(V, dtype=dtype, device=dev))
    diag[:, :, xs, xs] += s.Px
    diag[:, :-1, us, us] += s.Pu
    diag[:, -1, us, us] += torch.eye(nu, dtype=dtype, device=dev)
    diag[:, 0, xs, xs] += (r.init * s.d0**2)[..., None] * eye_nx
    diag[:, -1, xs, xs] += (r.final * s.dN**2)[..., None] * eye_nx
    # dynamics rows k: (A B)' rho (A B) on knot k, I' rho I on knot k+1
    diag[:, :-1, xs, xs] += torch.einsum("bki,bkij,bkil->bkjl",
                                         r.dyn, s.Ah, s.Ah)
    rAB = torch.einsum("bki,bkij,bkil->bkjl", r.dyn, s.Ah, s.Bh)
    diag[:, :-1, xs, us] += rAB
    diag[:, :-1, us, xs] += rAB.mT
    diag[:, :-1, us, us] += torch.einsum("bki,bkij,bkil->bkjl",
                                         r.dyn, s.Bh, s.Bh)
    diag[:, 1:, xs, xs] += (r.dyn * s.Ih**2)[..., None] * eye_nx
    # friction + CoP rows: per-contact nuc x nuc blocks on the block
    # diagonal of the control block
    gtg = torch.einsum("bkcr,bkcrj,bkcrl->bkcjl", r.fric, s.Gh, s.Gh)
    cop_full = torch.zeros((nb, N, C, nuc), dtype=dtype, device=dev)
    cop_full[..., :2] = r.cop * s.coph**2
    gtg = gtg + cop_full[..., None] * torch.eye(nuc, dtype=dtype, device=dev)
    blk = (gtg[:, :, :, :, None, :]
           * torch.eye(C, dtype=dtype, device=dev)[:, None, :, None])
    diag[:, :-1, us, us] += blk.reshape(nb, N, nu, nu)
    # trust rows: on (ang, t)
    diag[:, :, 6:9, 6:9] += torch.einsum("bkp,bkpj,bkpl->bkjl",
                                         r.trust, s.Th, s.Th)
    cross = -torch.einsum("bkp,bkpj,bkp->bkj", r.trust, s.Th, s.wh)
    diag[:, :, 6:9, V - 1] += cross
    diag[:, :, V - 1, 6:9] += cross
    diag[:, :, V - 1, V - 1] += ((r.trust * s.wh**2).sum(-1)
                                 + r.slack * s.sh**2)

    off = torch.zeros((nb, N, V, V), dtype=dtype, device=dev)
    # rows of knot k+1 (x part) coupling to knot k's (x, u)
    rI = (r.dyn * s.Ih)[..., None]
    off[:, :, xs, xs] = -rI * s.Ah
    off[:, :, xs, us] = -rI * s.Bh
    return diag, off


class ThomasFactor(NamedTuple):
    """Block-Thomas factorization with explicit Schur-complement inverses:
    T_k = S_k^-1 with S_0 = D_0, S_k = D_k - O_{k-1} T_{k-1} O_{k-1}';
    G_k = O_{k-1} T_{k-1} (forward coupling), H_k = T_k O_k' (backward).
    The inverses come from the Newton-Schulz iteration of ops/linalg, as
    in the JAX package (`_ThomasFactor`)."""

    T: torch.Tensor    # (B, N+1, V, V)
    G: torch.Tensor    # (B, N, V, V)
    H: torch.Tensor    # (B, N, V, V)


def thomas_factor(diag: torch.Tensor, off: torch.Tensor) -> ThomasFactor:
    """The block-Thomas factor of every scenario's M, a plain loop over
    the knots.  diag (B, N+1, V, V), off (B, N, V, V)."""
    ts = [spd_inverse(diag[:, 0])]
    for k in range(1, diag.shape[1]):
        o = off[:, k - 1]
        ts.append(spd_inverse(diag[:, k] - o @ ts[-1] @ o.mT))
    T = torch.stack(ts, dim=1)
    return ThomasFactor(T=T, G=off @ T[:, :-1], H=T[:, :-1] @ off.mT)


def thomas_solve(f: ThomasFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve M w = b with the Thomas factor: forward elimination, one
    knot-parallel application of T, backward substitution."""
    ys = [b[:, 0]]
    for k in range(1, b.shape[1]):
        ys.append(b[:, k] - _matvec(f.G[:, k - 1], ys[-1]))
    t = _matvec(f.T, torch.stack(ys, dim=1))
    ws = [t[:, -1]]
    for k in range(b.shape[1] - 2, -1, -1):
        ws.append(t[:, k] - _matvec(f.H[:, k], ws[-1]))
    return torch.stack(ws[::-1], dim=1)


def _backend(settings: QPSettings):
    """(factorize(diag, off), backsolve(factor, b)) of the settings'
    factor_method and sweep_method."""
    if settings.factor_method == "thomas":
        return thomas_factor, thomas_solve
    if settings.sweep_method == "assoc":
        return factor_batched, solve_assoc
    return factor_batched, solve_batched


def _applyP(s: _Scaled, W: torch.Tensor) -> torch.Tensor:
    """P w, packed (no cost on t; the dummy slot zero)."""
    w, out = s.wvars(W), torch.zeros_like(W)
    p = s.wvars(out)
    p.x.copy_(torch.einsum("bkij,bkj->bki", s.Px, w.x))
    p.u.copy_(torch.einsum("bkij,bkj->bki", s.Pu, w.u))
    return out


def _certificates(s: _Scaled, settings: QPSettings, dw: torch.Tensor,
                  dy: torch.Tensor):
    """OSQP primal/dual infeasibility certificate tests (Stellato et al.
    sec. 3.4) on the iterate deltas of one residual segment; (B,) bools.

    Candidate primal certificate ybar = E dy, dual certificate xbar =
    D dw, both tested against the unscaled problem data.  Infinite-bound
    rows require the recession-feasible sign of dy to within eps instead
    of entering the support function."""
    fin_l, fin_u = s.l / s.E > -0.5 * INF, s.u / s.E < 0.5 * INF
    ey = dy * s.E
    y_norm = _lane_absmax(ey)
    atdy = _lane_absmax(_apply_AT(s, dy) / s.D)
    eps_p = settings.eps_pinf * y_norm
    zero = torch.zeros_like(dy)
    sup = (torch.where(fin_u, s.u * dy.clamp(min=0.0), zero)
           + torch.where(fin_l, s.l * dy.clamp(max=0.0), zero)).sum(1)
    ep = eps_p[:, None]
    sign_ok = ((fin_u | (ey <= ep)).all(1)
               & (fin_l | (ey >= -ep)).all(1))
    pinf = (y_norm > 0) & (atdy <= eps_p) & sign_ok & (sup <= -eps_p)

    x_norm = _lane_absmax(dw * s.D)
    pdx = _lane_absmax(_applyP(s, dw) / s.D) / s.c
    qdx = _dot(s.q, dw) / s.c
    a_un = _apply_A(s, dw) / s.E
    ed = (settings.eps_dinf * x_norm)[:, None]
    cone_ok = ((~fin_u | (a_un <= ed)).all(1)
               & (~fin_l | (a_un >= -ed)).all(1))
    dinf = (x_norm > 0) & (pdx <= ed[:, 0]) & (qdx <= -ed[:, 0]) & cone_ok
    return pinf, dinf


def _two_sum(hi: torch.Tensor, lo: torch.Tensor, d: torch.Tensor):
    """Accumulate a correction d into the two-float dual (hi, lo):
    hi' = fl(hi + d) with the exact rounding error folded into lo (Knuth
    TwoSum, branch-free, no FMA).  Plain tensor ops: PyTorch neither
    reassociates nor contracts them."""
    s_ = hi + d
    bb = s_ - hi
    err = (hi - (s_ - bb)) + (d - bb)
    return s_, lo + err


def _residuals(s: _Scaled, settings: QPSettings, w: torch.Tensor,
               z: torch.Tensor, y: torch.Tensor,
               y_lo: Optional[torch.Tensor] = None):
    """Unscaled OSQP termination residuals and their relative scales,
    each (B,).  y_lo: optional low part of a two-float dual (the dual
    residual is then P w + q + A'y + A'y_lo)."""
    Aw = _apply_A(s, w)
    Pw = _applyP(s, w)
    ATy = _apply_AT(s, y)
    if y_lo is not None:
        ATy = ATy + _apply_AT(s, y_lo)
    prim = _lane_absmax((Aw - z) / s.E)
    dual = _lane_absmax((Pw + s.q + ATy) / s.D) / s.c
    prim_scale = torch.maximum(_lane_absmax(Aw / s.E),
                               _lane_absmax(z / s.E))
    dual_scale = torch.maximum(
        torch.maximum(_lane_absmax(Pw / s.D), _lane_absmax(ATy / s.D)),
        _lane_absmax(s.q / s.D)) / s.c
    eps_prim = settings.eps_abs + settings.eps_rel * prim_scale
    eps_dual = settings.eps_abs + settings.eps_rel * dual_scale
    return prim, dual, eps_prim, eps_dual, prim_scale, dual_scale


def _polish(s: _Scaled, settings: QPSettings, sigma: float, w: torch.Tensor,
            y: torch.Tensor):
    """OSQP-style solution polish as augmented-Lagrangian iterative
    refinement, then CG dual refinement with a two-float dual.

    Active rows (detected from the iterate) keep a large penalty
    polish_rho, inactive rows drop out (rho = 0); each round factorizes
    that M once (with the proximal shift raised to polish_sigma) and runs
    polish_iters residual-form corrections M dw = r_dual + A' rho r_prim.
    The CG stage then solves S dy = -A M^-1 g with S = A_act M^-1 A_act'
    for the dual, accumulating dy into (y, y_lo) by TwoSum.  Returns
    (w, z, y, y_lo); the caller keeps the polished iterate only if its
    normalized worst residual improves.

    The CoP rows (wrench6 feet; the JAX package has no such rule) are
    detected as a primal-dual active set: in the first round from the
    iterate as the other rows, but with a dual tolerance above the dtype's
    epsilon; in later rounds a CoP row is active at a bound only if it
    lies within polish_active_tol of it (or beyond it) and its dual has
    not the wrong sign for that bound.  Under the other groups' rule a
    row held at an edge stays held whatever its dual: the SCP's warm
    start carries the duals of the CoP rows that the last QP bound, those
    rows held the CoP at the edge of the foot where the optimum has it
    inside (26 rows in the second QP of talos pace), and the
    re-linearizing loop alternated between two answers.
    """
    atol = settings.polish_active_tol
    ytol = 1e-12
    dtype, dev = s.sh.dtype, s.sh.device
    factorize, backsolve = _backend(settings)
    # a row that left its bound keeps a dual of the iterate's round-off
    # (~1e-10 in float32): taken as active, it pins the CoP to an edge
    ytol_cop = max(ytol, torch.finfo(dtype).eps)
    cop = torch.zeros_like(s.l[0], dtype=torch.bool)
    s.zgroups(cop[None]).cop.fill_(True)
    # the first round's dual tolerance of each row
    ytol_first = torch.where(cop, torch.full_like(s.l[0], ytol_cop),
                             torch.full_like(s.l[0], ytol))
    # finiteness judged on unscaled bounds: row scaling moves the 1e20
    # sentinel by O(1) factors
    fin_l, fin_u = s.l / s.E > -0.5 * INF, s.u / s.E < 0.5 * INF

    def detect(z, y, first: bool):
        near_l, near_u = (z - s.l) < atol, (s.u - z) < atol
        if first:
            low = near_l | (y < -ytol_first)
            high = near_u | (y > ytol_first)
        else:
            low = torch.where(cop, near_l & (y <= ytol_cop),
                              near_l | (y < -ytol))
            high = torch.where(cop, near_u & (y >= -ytol_cop),
                               near_u | (y > ytol))
        low, high = low & fin_l, high & fin_u
        m = low | high
        return m, torch.where(m, torch.where(high, s.u, s.l),
                              torch.zeros_like(z))

    w_p, y_p = w, y
    Aw = _apply_A(s, w_p)   # maintained as A w_p
    eye = torch.eye(w.shape[-1], dtype=dtype, device=dev)
    for rnd in range(max(settings.polish_rounds, 1)):
        # later rounds raise the penalty at constant cond(M)
        ramp = settings.polish_rho_ramp ** rnd
        beta = settings.polish_rho * ramp
        dsig = (torch.full((), settings.polish_sigma * ramp, dtype=dtype,
                           device=dev) - sigma)
        mask, b_a = detect(Aw, y_p, rnd == 0)
        rho_p = mask.to(dtype) * beta
        diag, off = _assemble_blocks(s, rho_p, sigma)
        fac_p = factorize(diag + dsig * eye, off)

        y_p = torch.where(mask, y_p, torch.zeros_like(y_p))
        for _ in range(settings.polish_iters):
            r_p = rho_p * (b_a - Aw)                      # rho-scaled
            rhs = -(_applyP(s, w_p) + s.q) + _apply_AT(s, r_p - y_p)
            w_p = w_p + backsolve(fac_p, rhs)
            Aw = _apply_A(s, w_p)
            y_p = y_p + rho_p * (Aw - b_a)

    # two-float dual from here on (see _two_sum)
    y_lo = torch.zeros_like(y_p)

    if settings.polish_cg_iters > 0:
        maskf = mask.to(dtype)

        def S_op(v):
            return maskf * _apply_A(s, backsolve(fac_p,
                                                 _apply_AT(s, maskf * v)))

        for _ in range(max(settings.polish_cg_restarts, 1)):
            g = (_applyP(s, w_p) + s.q + _apply_AT(s, y_p)
                 + _apply_AT(s, y_lo))
            r = -(maskf * _apply_A(s, backsolve(fac_p, g)))
            dy = torch.zeros_like(r)
            p = r
            rr_old = _dot(r, r)
            for _ in range(settings.polish_cg_iters):
                Sp = S_op(p)
                alpha = (rr_old / _dot(p, Sp).clamp(min=1e-30))[:, None]
                dy = dy + alpha * p
                r = r - alpha * Sp
                rr_new = _dot(r, r)
                beta_cg = rr_new / rr_old.clamp(min=1e-30)
                p = r + beta_cg[:, None] * p
                rr_old = rr_new
            y_p, y_lo = _two_sum(y_p, y_lo, dy)

    # the CG refinement moved only y, so Aw still equals A w_p
    return w_p, torch.clamp(Aw, s.l, s.u), y_p, y_lo


def _max_iter(settings: QPSettings) -> int:
    """The iteration cap, rounded up to whole segments."""
    n_segments = -(-settings.max_iter // settings.check_interval)
    return n_segments * settings.check_interval


def _admm_iter(s: _Scaled, settings: QPSettings, backsolve,
               rho: torch.Tensor, fac, w: torch.Tensor, z: torch.Tensor,
               y: torch.Tensor):
    """One over-relaxed ADMM iteration at per-row step sizes rho (B, m)."""
    sigma, alpha = settings.sigma, settings.alpha
    w_t = backsolve(fac, sigma * w + _apply_AT(s, rho * z - y) - s.q)
    z_t = _apply_A(s, w_t)
    w_new = alpha * w_t + (1 - alpha) * w
    z_rel = alpha * z_t + (1 - alpha) * z
    z_new = torch.clamp(z_rel + y / rho, s.l, s.u)
    y_new = y + rho * (z_rel - z_new)
    return w_new, z_new, y_new


class _LoopState(NamedTuple):
    """What the ADMM loop carries from one residual segment to the next,
    every leaf with the leading lane axis: the iterate (w packed, z and y
    (B, m)), the best-so-far iterate and its residuals, each lane's
    termination state and step size, `frozen` (the lanes that keep their
    state in the next segment: done or out of iterations) and, with
    adaptive rho only, `run_on` (the lanes whose rho moved and that run
    on: the ones to refactor)."""

    w: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    wb: torch.Tensor
    yb: torch.Tensor
    pb: torch.Tensor
    db: torch.Tensor
    it: torch.Tensor
    prim: torch.Tensor
    dual: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    stall: torch.Tensor
    rho_b: torch.Tensor
    frozen: torch.Tensor
    run_on: Optional[torch.Tensor]


def _segment(s: _Scaled, settings: QPSettings, backsolve, rho_g,
             fac, st: _LoopState) -> _LoopState:
    """One residual segment: `check_interval` ADMM iterations, the
    residuals, the infeasibility certificates, the adaptive-rho ratio
    test, the best-so-far and stall bookkeeping, and the state of the next
    check.  No host read: the same operations in the same order whatever
    the data, so that on the card it can be captured once and replayed."""
    frozen, rho_b = st.frozen, st.rho_b
    i32 = dict(dtype=torch.int32, device=frozen.device)
    max_it = _max_iter(settings)
    w2, z2, y2 = st.w, st.z, st.y
    for _ in range(settings.check_interval):
        w2, z2, y2 = _admm_iter(s, settings, backsolve, rho_g, fac,
                                w2, z2, y2)

    (prim_n, dual_n, eps_prim, eps_dual,
     prim_scale, dual_scale) = _residuals(s, settings, w2, z2, y2)
    done_new = (prim_n < eps_prim) & (dual_n < eps_dual)
    status_new = torch.where(
        done_new, torch.full((), STATUS_SOLVED, **i32),
        torch.full((), STATUS_MAX_ITER, **i32))
    if settings.check_infeasibility:
        pinf, dinf = _certificates(s, settings, w2 - st.w, y2 - st.y)
        status_new = torch.where(
            pinf & ~done_new,
            torch.full((), STATUS_PRIMAL_INFEASIBLE, **i32),
            torch.where(dinf & ~done_new,
                        torch.full((), STATUS_DUAL_INFEASIBLE, **i32),
                        status_new))
        done_new = done_new | ((pinf | dinf) & ~done_new)

    rho_next = rho_b
    if settings.adaptive_rho:
        ratio = torch.sqrt(
            (prim_n / prim_scale.clamp(min=1e-30))
            / (dual_n / dual_scale.clamp(min=1e-30)).clamp(min=1e-30))
        new_rho = (rho_b * ratio).clamp(1e-6, 1e6)
        trigger = (((ratio > settings.adaptive_rho_tol)
                    | (ratio < 1.0 / settings.adaptive_rho_tol))
                   & ~done_new)
        rho_next = torch.where(trigger, new_rho, rho_b)

    w3, z3, y3 = select(frozen, (st.w, st.z, st.y), (w2, z2, y2))
    # best-so-far safeguard: track the iterate with the smallest
    # max(prim, dual) and return it if the final one is worse
    improve = ((torch.maximum(prim_n, dual_n)
                < 0.99 * torch.maximum(st.pb, st.db)) & ~frozen)
    stall = torch.where(frozen, st.stall,
                        torch.where(improve, torch.zeros_like(st.stall),
                                    st.stall + 1))
    wb, yb = select(improve, (w3, y3), (st.wb, st.yb))
    pb = torch.where(improve, prim_n, st.pb)
    db = torch.where(improve, dual_n, st.db)
    if settings.stall_segments > 0:
        done_new = done_new | (stall >= settings.stall_segments)
    it = torch.where(frozen, st.it, st.it + settings.check_interval)
    done = st.done | (done_new & ~frozen)
    return _LoopState(
        w=w3, z=z3, y=y3, wb=wb, yb=yb, pb=pb, db=db, it=it,
        prim=torch.where(frozen, st.prim, prim_n),
        dual=torch.where(frozen, st.dual, dual_n), done=done,
        status=torch.where(frozen, st.status, status_new), stall=stall,
        rho_b=torch.where(frozen, rho_b, rho_next),
        frozen=done | (it >= max_it),
        run_on=(trigger & ~done & (it < max_it) if settings.adaptive_rho
                else None))


def _leaves(tree) -> list:
    """The tensor leaves of nested tuples, in order (None skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for part in tree for t in _leaves(part)]
    return []


def _copy_leaves(dst, src) -> None:
    """Copy every tensor leaf of src into the matching leaf of dst, one
    multi-tensor copy a dtype."""
    groups = {}
    for d, v in zip(_leaves(dst), _leaves(src), strict=True):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(v)
    for ds, vs in groups.values():
        torch._foreach_copy_(ds, vs)


class _EagerSegments:
    """The segments dispatched one operation at a time (CPU tensors)."""

    def __init__(self, s, settings, backsolve, rho_g, fac, st):
        self.s, self.settings, self.backsolve = s, settings, backsolve
        self.rho_g, self.fac, self.state = rho_g, fac, st

    def run(self) -> None:
        self.state = _segment(self.s, self.settings, self.backsolve,
                              self.rho_g, self.fac, self.state)

    def set_factor(self, rho_g, fac) -> None:
        self.rho_g, self.fac = rho_g, fac

    def result(self) -> _LoopState:
        return self.state


class _SegmentGraph:
    """One segment captured as a CUDA graph and replayed at every segment
    of every solve of the same shapes and settings.

    The graph reads and writes fixed-address buffers: the scaled problem,
    the step sizes, the factor and the loop state.  `load` copies a
    solve's inputs into them, `set_factor` a refactored factor, and
    `result` copies the final state out.  The program's counters
    (`utils.profiling.counter_dicts`: the kernel wrappers' launches among
    them) grow once, during capture; each replay adds that growth, so
    they count the solve API's calls as the eager loop does.  While a
    capture runs, other threads may work on the card, but not draw from
    its default random generator (PyTorch ties it to every capture)."""

    def __init__(self, s, settings, backsolve, rho_g, fac, st):
        self.device = st.frozen.device
        self.s, self.rho_g, self.fac, self.state = _tree.map_tensors(
            torch.empty_like, (s, rho_g, fac, st))
        self.load(s, rho_g, fac, st)
        counted = profiling.counter_dicts()
        before = [dict(d) for d in counted]

        def body():
            return _segment(self.s, settings, backsolve, self.rho_g,
                            self.fac, self.state)

        try:
            with torch.cuda.device(self.device):
                # warm up outside the capture (library handles,
                # workspaces); the state is left as it was
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    body()
                torch.cuda.current_stream().wait_stream(side)
                warm = [dict(d) for d in counted]
                # thread-local: CUDA then forbids the potentially unsafe
                # calls (cudaMalloc) of this thread alone, not those of
                # other threads (say, the server's control loop)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    _copy_leaves(self.state, body())
            # (counter dict, its growth) for each dict that grew
            grown = [(d, {k: d[k] - w[k] for k in d if d[k] != w[k]})
                     for d, w in zip(counted, warm)]
            self.grown = [(d, g) for d, g in grown if g]
        finally:
            for d, b in zip(counted, before):
                d.update(b)             # neither ran a solve's segment
        counts["admm.graph_captures"] += 1

    def load(self, s, rho_g, fac, st) -> None:
        _copy_leaves((self.s, self.rho_g, self.fac, self.state),
                     (s, rho_g, fac, st))

    def run(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        for d, grew in self.grown:
            for k, n in grew.items():
                d[k] += n
        counts["admm.graph_replays"] += 1

    def set_factor(self, rho_g, fac) -> None:
        _copy_leaves((self.rho_g, self.fac), (rho_g, fac))

    def result(self) -> _LoopState:
        return _tree.map_tensors(torch.clone, self.state)


# Captured segments by shapes and settings, the most recently used last.
# A solve takes its graph out while it runs and puts it back at its end,
# so two solves (say, of two threads) never share buffers; the oldest
# beyond the cap are dropped with their memory.
_SEGMENT_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_SEGMENT_GRAPHS_KEPT = 4
_SEGMENT_GRAPHS_LOCK = threading.Lock()


def _graph_key(s: _Scaled, settings: QPSettings, rho_g, fac,
               st: _LoopState) -> tuple:
    """What a captured segment bakes in: the device, the settings (the
    backend among them) and the shape and dtype of every buffer."""
    return (s.Ah.device, settings,
            tuple((t.shape, t.dtype) for t in _leaves((s, rho_g, fac, st))))


def _segments(s: _Scaled, settings: QPSettings, backsolve, rho_g, fac,
              st: _LoopState):
    """The runner of a solve's segments: eager for CPU tensors; on the
    card the graph of these shapes and settings, captured on first use.
    Returns (runner, cache key or None)."""
    if s.Ah.device.type != "cuda":
        return _EagerSegments(s, settings, backsolve, rho_g, fac, st), None
    key = _graph_key(s, settings, rho_g, fac, st)
    with _SEGMENT_GRAPHS_LOCK:
        graph = _SEGMENT_GRAPHS.pop(key, None)
    if graph is None:
        graph = _SegmentGraph(s, settings, backsolve, rho_g, fac, st)
    else:
        graph.load(s, rho_g, fac, st)
    return graph, key


def _keep_graph(key, graph) -> None:
    """Put a solve's graph back into the cache as its newest entry."""
    with _SEGMENT_GRAPHS_LOCK:
        _SEGMENT_GRAPHS[key] = graph
        _SEGMENT_GRAPHS.move_to_end(key)
        while len(_SEGMENT_GRAPHS) > _SEGMENT_GRAPHS_KEPT:
            _SEGMENT_GRAPHS.popitem(last=False)


def _admm_loop_batched(s: _Scaled, w: torch.Tensor, y: torch.Tensor,
                       settings: QPSettings):
    """Batch-first ADMM loop (+ optional polish): fixed rho, or adaptive
    rho, where each lane carries its rho and its factorization across
    segments and is refactored only when its residual ratio leaves the
    deadband.  The JAX package's 'always' mode refactors every lane at
    every segment, but a lane's rho only moves when it triggers and the
    factor is a function of rho alone, so both modes give these iterates.

    Lanes that are done (converged, certified infeasible or stalled) or
    out of iterations are frozen: they run along but keep their state,
    the semantics a vmapped while_loop gives the per-scenario loop.  The
    loop ends when every lane is frozen.  Each segment (`_segment`) runs
    eagerly on the CPU and as a replayed CUDA graph on the card; the
    refactors stay outside it.  Returns
    (w, y, y_lo, it, prim, dual, status, rho, refactors): w packed, y
    and y_lo (B, m), the rest (B,) termination state; y_lo is the low
    part of the polish's two-float dual (zeros where the polish was not
    accepted), rho each lane's final step size and refactors its 'cond'
    refactorizations.
    """
    nb = s.sh.shape[0]
    dtype, dev = s.sh.dtype, s.sh.device
    sigma = settings.sigma
    factorize, backsolve = _backend(settings)

    def refactor_lanes(rho_b, fac, lanes):
        """The factor of the given lanes at their new rho, scattered into
        the carried factor; the other lanes keep theirs."""
        diag, off = _assemble_blocks(s, _rho_rows(settings, rho_b, s),
                                     sigma)
        sub = factorize(diag.index_select(0, lanes),
                        off.index_select(0, lanes))
        return type(fac)(*(f.index_copy(0, lanes, g)
                           for f, g in zip(fac, sub)))

    rho_b = torch.full((nb,), settings.rho, dtype=dtype, device=dev)
    rho_g = _rho_rows(settings, rho_b, s)
    with span("admm.factor"):
        fac = factorize(*_assemble_blocks(s, rho_g, sigma))
    refactors = torch.zeros(nb, dtype=torch.int32, device=dev)

    i32 = dict(dtype=torch.int32, device=dev)
    it = torch.zeros(nb, **i32)
    prim = torch.full((nb,), float("inf"), dtype=dtype, device=dev)
    dual = prim.clone()
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    st = _LoopState(
        w=w, z=_apply_A(s, w), y=y, wb=w, yb=y, pb=prim, db=dual, it=it,
        prim=prim, dual=dual, done=done, status=torch.zeros(nb, **i32),
        stall=torch.zeros(nb, **i32), rho_b=rho_b,
        frozen=done | (it >= _max_iter(settings)),
        run_on=torch.zeros_like(done) if settings.adaptive_rho else None)
    loop, key = _segments(s, settings, backsolve, rho_g, fac, st)

    while True:
        counts["sync.admm"] += 1
        with span("sync.admm"):
            stop = bool(loop.state.frozen.all())   # one host sync a segment
        if stop:
            break
        counts["admm.segments"] += 1
        counts["admm.iterations"] += settings.check_interval
        with span("admm.segment"):
            loop.run()
        if settings.adaptive_rho:
            # refactor only the lanes that triggered and run on; a
            # segment after which none does launches no factor
            counts["sync.refactor"] += 1
            with span("sync.refactor"):
                lanes = loop.state.run_on.nonzero()[:, 0]
            if lanes.numel():
                counts["admm.refactor_calls"] += 1
                with span("admm.factor"):
                    rho_b = loop.state.rho_b
                    loop.set_factor(_rho_rows(settings, rho_b, s),
                                    refactor_lanes(rho_b, loop.fac, lanes))
                    refactors = refactors.index_add(
                        0, lanes, torch.ones_like(lanes, dtype=torch.int32))
    st = loop.result()
    if key is not None:
        _keep_graph(key, loop)

    # adopt the best-so-far iterate where it beats the final one
    adopt = torch.maximum(st.pb, st.db) < torch.maximum(st.prim, st.dual)
    w, y = select(adopt, (st.wb, st.yb), (st.w, st.y))
    prim = torch.where(adopt, st.pb, st.prim)
    dual = torch.where(adopt, st.db, st.dual)
    it, status = st.it, st.status
    y_lo = torch.zeros_like(y)

    if settings.polish:
        with span("qp.polish"):
            w_p, z_p, y_p, y_lo_p = _polish(s, settings, sigma, w, y)
            (prim_p, dual_p, eps_prim_p, eps_dual_p,
             _, _) = _residuals(s, settings, w_p, z_p, y_p, y_lo_p)
            # normalized worst-residual acceptance gate, as shipped in the
            # JAX package (ops/blockqp.py there)
            worst = torch.maximum(prim / eps_prim_p, dual / eps_dual_p)
            worst_p = torch.maximum(prim_p / eps_prim_p,
                                    dual_p / eps_dual_p)
            better = worst_p < worst
            w, y, y_lo = select(better, (w_p, y_p, y_lo_p), (w, y, y_lo))
            prim = torch.where(better, prim_p, prim)
            dual = torch.where(better, dual_p, dual)
            newly = better & (prim_p < eps_prim_p) & (dual_p < eps_dual_p)
            status = torch.where(newly, torch.full((), STATUS_SOLVED, **i32),
                                 status)

    return w, y, y_lo, it, prim, dual, status, st.rho_b, refactors


@dataclasses.dataclass(frozen=True)
class BlockQPSolution:
    X: torch.Tensor            # (B, N+1, nx)
    U: torch.Tensor            # (B, N, nu)
    t: torch.Tensor            # (B, N+1)
    y: ZGroups                 # unscaled dual (the high part)
    y_lo: ZGroups              # unscaled low part of the two-float dual
                               # (zeros unless the polish was accepted);
                               # the JAX package drops it, so a dual
                               # residual rebuilt from y alone floors
                               # above tight tolerances
    iterations: torch.Tensor   # (B,) int32
    prim_res: torch.Tensor     # (B,)
    dual_res: torch.Tensor     # (B,)
    converged: torch.Tensor    # (B,) bool
    status: torch.Tensor       # (B,) int32 STATUS_*
    # the port's additions (the JAX package returns neither):
    rho: torch.Tensor          # (B,) final ADMM step size of each lane
    refactors: torch.Tensor    # (B,) int32 adaptive-rho refactorizations


def check_settings(settings: QPSettings) -> None:
    """Raise ValueError for an unknown mode name."""
    if settings.adaptive_rho_mode not in ("always", "cond"):
        raise ValueError(
            f"unknown adaptive_rho_mode {settings.adaptive_rho_mode!r}")
    if settings.factor_method not in ("cholesky", "pallas", "thomas"):
        raise ValueError(f"unknown factor_method {settings.factor_method!r}")
    if settings.sweep_method not in ("scan", "assoc"):
        raise ValueError(f"unknown sweep_method {settings.sweep_method!r}")


def solve_block_qp(qp: BlockQP, settings: QPSettings = QPSettings(),
                   w0: Optional[WVars] = None,
                   y0: Optional[ZGroups] = None) -> BlockQPSolution:
    """Structured ADMM solve of a batch of block QPs (leading axis B);
    OSQP semantics.  w0 / y0: unscaled primal / dual warm starts."""
    check_settings(settings)
    with span("qp.scale"):
        s = _ruiz(qp, settings.scaling_iters)
    w = (torch.zeros_like(s.D) if w0 is None else _wpacked(w0) / s.D)
    y = (torch.zeros_like(s.l) if y0 is None
         else s.c[:, None] * _zflat(y0) / s.E)
    w, y, y_lo, it, prim, dual, status, rho, refactors = _admm_loop_batched(
        s, w, y, settings)
    w_un = s.wvars(w * s.D)
    c = s.c[:, None]
    return BlockQPSolution(X=w_un.x, U=w_un.u, t=w_un.t,
                           y=s.zgroups(y * s.E / c),
                           y_lo=s.zgroups(y_lo * s.E / c),
                           iterations=it, prim_res=prim, dual_res=dual,
                           converged=(status == STATUS_SOLVED),
                           status=status, rho=rho, refactors=refactors)
