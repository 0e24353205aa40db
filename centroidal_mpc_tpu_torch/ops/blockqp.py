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
(residuals, step sizes, statuses) are (B,) tensors.  The JAX package runs
this loop once for the whole vmapped batch and freezes converged lanes by
masking; the port does the same with `torch.where`, and leaves the loop
when no lane is active (one host sync per residual segment).  A segment
has no host read, so on the card it is captured once as a CUDA graph per
device, shapes and settings, and replayed (`_SegmentGraph`); on the CPU it
runs eagerly.  The loop
counts its work in `ops.admm.counts` and opens the spans `qp.scale`,
`admm.factor`, `admm.segment`, `qp.polish` and one `sync.*` a blocking
host read (`utils.profiling.span`).
"""
from __future__ import annotations

import collections
import dataclasses
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
from centroidal_mpc_tpu_torch.ops import block_tridiag, constraint_apply
from centroidal_mpc_tpu_torch.ops.block_tridiag import (_matvec,
                                                        factor_batched,
                                                        solve_assoc,
                                                        solve_batched)
from centroidal_mpc_tpu_torch.ops.linalg import spd_inverse
from centroidal_mpc_tpu_torch.solver.ocp import (DYN_SLACK, INF, OcpConfig,
                                                 N_X, _chance_backoffs,
                                                 per_lane, rotated_pyramid,
                                                 sign_enumeration_matrix)
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
    def z(*shape):
        return torch.zeros((B,) + shape, dtype=dtype, device=device)
    return ZGroups(init=z(N_X), dyn=z(N, N_X), final=z(N_X), cop=z(N, C, 2),
                   fric=z(N, C, 5), trust=z(N + 1, 8), slack=z(N + 1))


class WVars(NamedTuple):
    """Variable-space vector: states, controls, trust slacks."""

    x: torch.Tensor   # (B, N+1, nx)
    u: torch.Tensor   # (B, N, nu)
    t: torch.Tensor   # (B, N+1)


def _zmap(f, *zs: ZGroups) -> ZGroups:
    return ZGroups(*(f(*parts) for parts in zip(*zs)))


def _wmap(f, *ws: WVars) -> WVars:
    return WVars(*(f(*parts) for parts in zip(*ws)))


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) per-lane values broadcastable against `like` (B, ...)."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _lane_absmax(a: torch.Tensor) -> torch.Tensor:
    return a.abs().flatten(1).amax(1)


def _zmax(z) -> torch.Tensor:
    """Per-lane inf-norm over every group of a ZGroups/WVars."""
    out = _lane_absmax(z[0])
    for part in z[1:]:
        out = torch.maximum(out, _lane_absmax(part))
    return out


_wmax = _zmax


def _lane_sum(a: torch.Tensor) -> torch.Tensor:
    return a.flatten(1).sum(1)


def _dot(a, b) -> torch.Tensor:
    """Per-lane inner product of two ZGroups (or WVars)."""
    return sum(_lane_sum(x * y) for x, y in zip(a, b))


def _scale(c: torch.Tensor, z):
    """Per-lane scalar c (B,) times every group of z."""
    return type(z)(*(_bc(c, v) * v for v in z))


class _Scaled(NamedTuple):
    """Ruiz-scaled problem blocks.  Hatted quantities absorb both the row
    scaling E (per constraint) and column scaling D (per variable)."""

    Px: torch.Tensor       # (B, N+1, nx, nx) scaled state cost (includes c)
    Pu: torch.Tensor       # (B, N, nu, nu)
    q: WVars               # scaled linear cost
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
    l: ZGroups
    u: ZGroups
    D: WVars               # variable scaling
    E: ZGroups             # row scaling
    c: torch.Tensor        # (B,) cost scaling


def _apply_A_plain(s: _Scaled, w: WVars) -> ZGroups:
    x, u, t = w
    nb, n = s.Ah.shape[0], s.Ah.shape[1]
    C, nuc = s.Gh.shape[2], s.Gh.shape[4]
    u_c = u.reshape(nb, n, C, nuc)
    return ZGroups(
        init=s.d0 * x[:, 0],
        dyn=(torch.einsum("bkij,bkj->bki", s.Ah, x[:, :-1])
             + torch.einsum("bkij,bkj->bki", s.Bh, u) - s.Ih * x[:, 1:]),
        final=s.dN * x[:, -1],
        cop=s.coph * u_c[..., :2],
        fric=torch.einsum("bkcrj,bkcj->bkcr", s.Gh, u_c),
        trust=(torch.einsum("bkpj,bkj->bkp", s.Th, x[..., 6:9])
               - s.wh * t[..., None]),
        slack=-s.sh * t,
    )


def _apply_AT_plain(s: _Scaled, z: ZGroups) -> WVars:
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
    return WVars(x=x, u=u, t=t)


def _coefficients(s: _Scaled) -> tuple:
    return tuple(getattr(s, f) for f in constraint_apply.COEFFICIENTS)


def _apply_A(s: _Scaled, w: WVars) -> ZGroups:
    """z = A w: one `constraint_apply` kernel for CUDA tensors, the plain
    einsums for CPU tensors."""
    if s.Ah.device.type == "cpu":
        return _apply_A_plain(s, w)
    return ZGroups(*constraint_apply.apply_A(_coefficients(s), *w))


def _apply_AT(s: _Scaled, z: ZGroups) -> WVars:
    """w = A' z: one `constraint_apply_T` kernel for CUDA tensors, the
    plain einsums for CPU tensors."""
    if s.Ah.device.type == "cpu":
        return _apply_AT_plain(s, z)
    return WVars(*constraint_apply.apply_AT(_coefficients(s), z))


def _row_norms(s: _Scaled) -> ZGroups:
    return ZGroups(
        init=s.d0.abs(),
        dyn=torch.maximum(s.Ah.abs().amax(-1),
                          torch.maximum(s.Bh.abs().amax(-1), s.Ih.abs())),
        final=s.dN.abs(),
        cop=s.coph.abs(),
        fric=s.Gh.abs().amax(-1),
        trust=torch.maximum(s.Th.abs().amax(-1), s.wh),
        slack=s.sh,
    )


def _col_norms(s: _Scaled) -> WVars:
    """Per-variable inf-norm over the stacked [P; A] columns."""
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
    return WVars(x=cx, u=cu, t=ct)


def _ruiz(qp: BlockQP, iters: int) -> _Scaled:
    nb, N, nx, nu = qp.A.shape[0], qp.horizon, qp.A.shape[2], qp.n_u
    dtype, dev = qp.A.dtype, qp.A.device
    eps = torch.full((), DYN_SLACK, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones((nb,) + shape, dtype=dtype, device=dev)

    def full(like, v):
        return torch.full_like(like, v)

    s = _Scaled(
        Px=qp.Wx[:, None].expand(nb, N + 1, nx, nx),
        Pu=qp.Wu[:, None].expand(nb, N, nu, nu),
        q=WVars(x=qp.qx, u=torch.zeros((nb, N, nu), dtype=dtype,
                                       device=dev), t=qp.qt),
        d0=ones(nx), Ah=qp.A, Bh=qp.B, Ih=ones(N, nx), dN=ones(nx),
        Gh=qp.G, coph=qp.cop_act,
        Th=qp.penum.expand(nb, N + 1, 8, 3),
        wh=qp.inv_omega[:, None, None].expand(nb, N + 1, 8),
        sh=ones(N + 1),
        l=ZGroups(init=qp.x_init, dyn=qp.r_dyn - eps, final=qp.final_l,
                  cop=qp.cop_l, fric=full(qp.fric_ub, -INF),
                  trust=full(qp.trust_ub, -INF),
                  slack=full(qp.qt, -INF)),
        u=ZGroups(init=qp.x_init, dyn=qp.r_dyn + eps, final=qp.final_u,
                  cop=qp.cop_u, fric=qp.fric_ub, trust=qp.trust_ub,
                  slack=torch.zeros_like(qp.qt)),
        D=WVars(x=ones(N + 1, nx), u=ones(N, nu), t=ones(N + 1)),
        E=ZGroups(init=ones(nx), dyn=ones(N, nx), final=ones(nx),
                  cop=torch.ones_like(qp.cop_act),
                  fric=torch.ones_like(qp.fric_ub),
                  trust=torch.ones_like(qp.trust_ub), slack=ones(N + 1)),
        c=ones(),
    )

    def rescale(s: _Scaled, d: WVars, e: ZGroups) -> _Scaled:
        C, nuc = s.Gh.shape[2], s.Gh.shape[4]
        du_f = d.u.reshape(nb, N, C, nuc)
        return s._replace(
            Px=s.Px * d.x[..., :, None] * d.x[..., None, :],
            Pu=s.Pu * d.u[..., :, None] * d.u[..., None, :],
            q=WVars(x=s.q.x * d.x, u=s.q.u * d.u, t=s.q.t * d.t),
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
            l=_zmap(lambda a, b: a * b, s.l, e),
            u=_zmap(lambda a, b: a * b, s.u, e),
            D=_wmap(lambda a, b: a * b, s.D, d),
            E=_zmap(lambda a, b: a * b, s.E, e),
        )

    def inv_sqrt(a):
        return 1.0 / torch.sqrt(torch.where(a > 0, a, torch.ones_like(a)))

    n_dense = (nx * (N + 1) + nu * N) + (N + 1) + N
    for _ in range(iters):
        # column and row norms both from the SAME current scaled problem,
        # applied together (the OSQP iteration)
        d = _wmap(inv_sqrt, _col_norms(s))
        e = _zmap(inv_sqrt, _row_norms(s))
        s = rescale(s, d, e)
        # cost normalization: gamma = 1/max(mean |P| col norm, |q|_inf),
        # the mean over the full dense variable count
        p_sum = (s.Px.abs().amax(2).flatten(1).sum(1)
                 + s.Pu.abs().amax(2).flatten(1).sum(1))
        gamma_den = torch.maximum(p_sum / n_dense, _wmax(s.q))
        gamma = 1.0 / torch.where(gamma_den > 0, gamma_den,
                                  torch.ones_like(gamma_den))
        s = s._replace(Px=s.Px * _bc(gamma, s.Px), Pu=s.Pu * _bc(gamma, s.Pu),
                       q=_scale(gamma, s.q), c=s.c * gamma)
    # the constraint kernels take contiguous blocks (without scaling
    # iterations Th, wh are still broadcast views)
    return s._replace(**{f: getattr(s, f).contiguous()
                         for f in constraint_apply.COEFFICIENTS})


def _rho_groups(settings: QPSettings, rho: torch.Tensor,
                s: _Scaled) -> ZGroups:
    """Per-row ADMM step sizes at full group shapes from per-lane rho
    (B,); equality rows get eq_rho_scale * rho."""
    req = settings.eq_rho_scale * rho
    return ZGroups(*(_bc(r, like).expand_as(like)
                     for r, like in zip((req, req, req, rho, rho, rho, rho),
                                        s.l)))


def _assemble_blocks(s: _Scaled, r: ZGroups, sigma: float):
    """Block-tridiagonal M = P + sigma I + A' diag(rho) A for per-row step
    sizes r.  Returns (diag (B, N+1, V, V), off (B, N, V, V)) with per-knot
    variable order [x (nx), u (nu), t (1)]; the control slot of knot N is
    a padded dummy with unit diagonal."""
    nb, N, nx, nu = s.Ah.shape[0], s.Ah.shape[1], s.Ah.shape[2], s.Bh.shape[-1]
    V = nx + nu + 1
    dtype, dev = s.Ah.dtype, s.Ah.device
    C, nuc = s.Gh.shape[2], s.Gh.shape[4]
    xs, us = slice(0, nx), slice(nx, nx + nu)
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


def _pack(w: WVars, nx: int, nu: int) -> torch.Tensor:
    nb, n = w.u.shape[0], w.u.shape[1]
    W = torch.zeros((nb, n + 1, nx + nu + 1), dtype=w.x.dtype,
                    device=w.x.device)
    W[..., :nx] = w.x
    W[:, :-1, nx:nx + nu] = w.u
    W[..., -1] = w.t
    return W


def _unpack(W: torch.Tensor, nx: int, nu: int) -> WVars:
    return WVars(x=W[..., :nx], u=W[:, :-1, nx:nx + nu], t=W[..., -1])


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


def _solve(backsolve, fac, w: WVars, nx: int, nu: int) -> WVars:
    return _unpack(backsolve(fac, _pack(w, nx, nu)), nx, nu)


def _applyP(s: _Scaled, w: WVars) -> WVars:
    return WVars(x=torch.einsum("bkij,bkj->bki", s.Px, w.x),
                 u=torch.einsum("bkij,bkj->bki", s.Pu, w.u),
                 t=torch.zeros_like(w.t))


def _certificates(s: _Scaled, settings: QPSettings, dw: WVars,
                  dy: ZGroups):
    """OSQP primal/dual infeasibility certificate tests (Stellato et al.
    sec. 3.4) on the iterate deltas of one residual segment; (B,) bools.

    Candidate primal certificate ybar = E dy, dual certificate xbar =
    D dw, both tested against the unscaled problem data.  Infinite-bound
    rows require the recession-feasible sign of dy to within eps instead
    of entering the support function."""
    nb = s.sh.shape[0]
    dev = s.sh.device
    y_norm = _zmax(_zmap(lambda a, e: a * e, dy, s.E))
    atdy = _wmax(_wmap(lambda a, d: a / d, _apply_AT(s, dy), s.D))
    eps_p = settings.eps_pinf * y_norm
    sup = torch.zeros_like(y_norm)
    sign_ok = torch.ones(nb, dtype=torch.bool, device=dev)
    for lo, hi, d, e in zip(s.l, s.u, dy, s.E):
        fin_u = (hi / e) < 0.5 * INF
        fin_l = (lo / e) > -0.5 * INF
        zero = torch.zeros_like(d)
        sup = sup + _lane_sum(torch.where(fin_u, hi * d.clamp(min=0.0), zero)
                              + torch.where(fin_l, lo * d.clamp(max=0.0),
                                            zero))
        ep = _bc(eps_p, d)
        sign_ok = sign_ok & (fin_u | (e * d <= ep)).flatten(1).all(1)
        sign_ok = sign_ok & (fin_l | (e * d >= -ep)).flatten(1).all(1)
    pinf = (y_norm > 0) & (atdy <= eps_p) & sign_ok & (sup <= -eps_p)

    x_norm = _wmax(_wmap(lambda a, d: a * d, dw, s.D))
    pdx = _wmax(_wmap(lambda a, d: a / d, _applyP(s, dw), s.D)) / s.c
    qdx = _dot(s.q, dw) / s.c
    Adw = _apply_A(s, dw)
    eps_d = settings.eps_dinf * x_norm
    cone_ok = torch.ones(nb, dtype=torch.bool, device=dev)
    for lo, hi, a, e in zip(s.l, s.u, Adw, s.E):
        a_un = a / e
        fin_u = (hi / e) < 0.5 * INF
        fin_l = (lo / e) > -0.5 * INF
        ed = _bc(eps_d, a)
        cone_ok = cone_ok & (~fin_u | (a_un <= ed)).flatten(1).all(1)
        cone_ok = cone_ok & (~fin_l | (a_un >= -ed)).flatten(1).all(1)
    dinf = (x_norm > 0) & (pdx <= eps_d) & (qdx <= -eps_d) & cone_ok
    return pinf, dinf


def _two_sum(hi: ZGroups, lo: ZGroups, d: ZGroups):
    """Accumulate a correction d into the two-float dual (hi, lo):
    hi' = fl(hi + d) with the exact rounding error folded into lo (Knuth
    TwoSum, branch-free, no FMA).  Plain tensor ops: PyTorch neither
    reassociates nor contracts them."""
    def one(h, l, dd):
        s_ = h + dd
        bb = s_ - h
        err = (h - (s_ - bb)) + (dd - bb)
        return s_, l + err
    out = [one(h, l, dd) for h, l, dd in zip(hi, lo, d)]
    return (ZGroups(*(o[0] for o in out)), ZGroups(*(o[1] for o in out)))


def _residuals(s: _Scaled, settings: QPSettings, w: WVars, z: ZGroups,
               y: ZGroups, y_lo: Optional[ZGroups] = None):
    """Unscaled OSQP termination residuals and their relative scales,
    each (B,).  y_lo: optional low part of a two-float dual (the dual
    residual is then P w + q + A'y + A'y_lo)."""
    Aw = _apply_A(s, w)
    Pw = _applyP(s, w)
    ATy = _apply_AT(s, y)
    if y_lo is not None:
        ATy = _wmap(lambda a, b: a + b, ATy, _apply_AT(s, y_lo))
    prim = _zmax(_zmap(lambda a, b, e: (a - b) / e, Aw, z, s.E))
    dual = _wmax(_wmap(lambda p, q, at, d: (p + q + at) / d,
                       Pw, s.q, ATy, s.D)) / s.c
    prim_scale = torch.maximum(
        _zmax(_zmap(lambda a, e: a / e, Aw, s.E)),
        _zmax(_zmap(lambda a, e: a / e, z, s.E)))
    dual_scale = torch.maximum(
        torch.maximum(_wmax(_wmap(lambda a, d: a / d, Pw, s.D)),
                      _wmax(_wmap(lambda a, d: a / d, ATy, s.D))),
        _wmax(_wmap(lambda a, d: a / d, s.q, s.D))) / s.c
    eps_prim = settings.eps_abs + settings.eps_rel * prim_scale
    eps_dual = settings.eps_abs + settings.eps_rel * dual_scale
    return prim, dual, eps_prim, eps_dual, prim_scale, dual_scale


def _polish(s: _Scaled, settings: QPSettings, sigma: float, w: WVars,
            y: ZGroups, nx: int, nu: int):
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

    def detect(z, y, first: bool):
        masks, targets = [], []
        for name, lo, hi, zz, yy, ee in zip(ZGroups._fields, s.l, s.u, z, y,
                                            s.E):
            # finiteness judged on unscaled bounds: row scaling moves the
            # 1e20 sentinel by O(1) factors
            fin_l, fin_u = lo / ee > -0.5 * INF, hi / ee < 0.5 * INF
            if name != "cop":
                low = (((zz - lo) < atol) | (yy < -ytol)) & fin_l
                high = (((hi - zz) < atol) | (yy > ytol)) & fin_u
            elif first:
                low = (((zz - lo) < atol) | (yy < -ytol_cop)) & fin_l
                high = (((hi - zz) < atol) | (yy > ytol_cop)) & fin_u
            else:
                low = ((zz - lo) < atol) & (yy <= ytol_cop) & fin_l
                high = ((hi - zz) < atol) & (yy >= -ytol_cop) & fin_u
            m = low | high
            masks.append(m)
            targets.append(torch.where(m, torch.where(high, hi, lo),
                                       torch.zeros_like(zz)))
        return ZGroups(*masks), ZGroups(*targets)

    w_p, y_p = w, y
    Aw = _apply_A(s, w_p)   # maintained as A w_p
    V = nx + nu + 1
    eye = torch.eye(V, dtype=dtype, device=dev)
    for rnd in range(max(settings.polish_rounds, 1)):
        # later rounds raise the penalty at constant cond(M)
        ramp = settings.polish_rho_ramp ** rnd
        beta = settings.polish_rho * ramp
        dsig = (torch.full((), settings.polish_sigma * ramp, dtype=dtype,
                           device=dev) - sigma)
        mask, b_a = detect(Aw, y_p, rnd == 0)
        rho_p = ZGroups(*(m.to(dtype) * beta for m in mask))
        diag, off = _assemble_blocks(s, rho_p, sigma)
        fac_p = factorize(diag + dsig * eye, off)

        y_p = ZGroups(*(torch.where(m, yy, torch.zeros_like(yy))
                        for m, yy in zip(mask, y_p)))
        for _ in range(settings.polish_iters):
            r_p = ZGroups(*(rr * (bb - aa) for rr, bb, aa in
                            zip(rho_p, b_a, Aw)))            # rho-scaled
            rpy = ZGroups(*(rp - yy for rp, yy in zip(r_p, y_p)))
            rhs = _wmap(lambda pw, qq, at: -(pw + qq) + at,
                        _applyP(s, w_p), s.q, _apply_AT(s, rpy))
            dw = _solve(backsolve, fac_p, rhs, nx, nu)
            w_p = _wmap(lambda a, b: a + b, w_p, dw)
            Aw = _apply_A(s, w_p)
            y_p = ZGroups(*(yy + rr * (aa - bb) for yy, rr, aa, bb in
                            zip(y_p, rho_p, Aw, b_a)))

    # two-float dual from here on (see _two_sum)
    y_lo = ZGroups(*(torch.zeros_like(v) for v in y_p))

    if settings.polish_cg_iters > 0:
        maskf = ZGroups(*(m.to(dtype) for m in mask))

        def S_op(v):
            vm = ZGroups(*(mf * vv for mf, vv in zip(maskf, v)))
            out = _apply_A(s, _solve(backsolve, fac_p, _apply_AT(s, vm),
                                         nx, nu))
            return ZGroups(*(mf * oo for mf, oo in zip(maskf, out)))

        for _ in range(max(settings.polish_cg_restarts, 1)):
            g = _wmap(lambda pw, qq, at, atl: pw + qq + at + atl,
                      _applyP(s, w_p), s.q, _apply_AT(s, y_p),
                      _apply_AT(s, y_lo))
            rhs_cg = _apply_A(s, _solve(backsolve, fac_p, g, nx, nu))
            r = ZGroups(*(-(mf * rr) for mf, rr in zip(maskf, rhs_cg)))
            dy = ZGroups(*(torch.zeros_like(v) for v in r))
            p = r
            rr_old = _dot(r, r)
            for _ in range(settings.polish_cg_iters):
                Sp = S_op(p)
                alpha = rr_old / _dot(p, Sp).clamp(min=1e-30)
                dy = ZGroups(*(d + av for d, av in
                               zip(dy, _scale(alpha, p))))
                r = ZGroups(*(rv - av for rv, av in
                              zip(r, _scale(alpha, Sp))))
                rr_new = _dot(r, r)
                beta_cg = rr_new / rr_old.clamp(min=1e-30)
                p = ZGroups(*(rv + bv for rv, bv in
                              zip(r, _scale(beta_cg, p))))
                rr_old = rr_new
            y_p, y_lo = _two_sum(y_p, y_lo, dy)

    # the CG refinement moved only y, so Aw still equals A w_p
    z_p = ZGroups(*(torch.clamp(aa, lo, hi) for aa, lo, hi in
                    zip(Aw, s.l, s.u)))
    return w_p, z_p, y_p, y_lo


def _max_iter(settings: QPSettings) -> int:
    """The iteration cap, rounded up to whole segments."""
    n_segments = -(-settings.max_iter // settings.check_interval)
    return n_segments * settings.check_interval


def _admm_iter(s: _Scaled, settings: QPSettings, backsolve, rho_g: ZGroups,
               fac, w: WVars, z: ZGroups, y: ZGroups):
    """One over-relaxed ADMM iteration at per-row step sizes rho_g."""
    sigma, alpha = settings.sigma, settings.alpha
    nx, nu = s.Ah.shape[2], s.Bh.shape[-1]
    rz_y = ZGroups(*(rr * zz - yy for zz, yy, rr in zip(z, y, rho_g)))
    rhs = _wmap(lambda ww, at, qq: sigma * ww + at - qq,
                w, _apply_AT(s, rz_y), s.q)
    w_t = _solve(backsolve, fac, rhs, nx, nu)
    z_t = _apply_A(s, w_t)
    w_new = _wmap(lambda wt, ww: alpha * wt + (1 - alpha) * ww, w_t, w)
    z_rel = _zmap(lambda zt, zz: alpha * zt + (1 - alpha) * zz, z_t, z)
    z_new = ZGroups(*(torch.clamp(zr + yy / rr, lo, hi)
                      for zr, yy, rr, lo, hi in
                      zip(z_rel, y, rho_g, s.l, s.u)))
    y_new = ZGroups(*(yy + rr * (zr - zn) for yy, rr, zr, zn in
                      zip(y, rho_g, z_rel, z_new)))
    return w_new, z_new, y_new


class _LoopState(NamedTuple):
    """What the ADMM loop carries from one residual segment to the next,
    every leaf with the leading lane axis: the iterate, the best-so-far
    iterate and its residuals, each lane's termination state and step
    size, `frozen` (the lanes that keep their state in the next segment:
    done or out of iterations) and, with adaptive rho only, `run_on` (the
    lanes whose rho moved and that run on: the ones to refactor)."""

    w: WVars
    z: ZGroups
    y: ZGroups
    wb: WVars
    yb: ZGroups
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


def _segment(s: _Scaled, settings: QPSettings, backsolve, rho_g: ZGroups,
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
        dw = _wmap(lambda a, b: a - b, w2, st.w)
        dy = _zmap(lambda a, b: a - b, y2, st.y)
        pinf, dinf = _certificates(s, settings, dw, dy)
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


# The launch counters to which a replayed segment adds its capture's.
_COUNTED = (block_tridiag.launches, constraint_apply.launches)


class _SegmentGraph:
    """One segment captured as a CUDA graph and replayed at every segment
    of every solve of the same shapes and settings.

    The graph reads and writes fixed-address buffers: the scaled problem,
    the step sizes, the factor and the loop state.  `load` copies a
    solve's inputs into them, `set_factor` a refactored factor, and
    `result` copies the final state out.  The kernel wrappers' launch
    counters (`_COUNTED`) grow once, during capture; each replay adds
    that growth, so they count the solve API's calls as the eager loop
    does.  While a capture runs, other threads may work on the card, but
    not draw from its default random generator (PyTorch ties it to every
    capture)."""

    def __init__(self, s, settings, backsolve, rho_g, fac, st):
        self.device = st.frozen.device
        self.s, self.rho_g, self.fac, self.state = _tree.map_tensors(
            torch.empty_like, (s, rho_g, fac, st))
        self.load(s, rho_g, fac, st)
        before = [dict(d) for d in _COUNTED]

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
                warm = [dict(d) for d in _COUNTED]
                # thread-local: CUDA then forbids the potentially unsafe
                # calls (cudaMalloc) of this thread alone, not those of
                # other threads (say, the server's control loop)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    _copy_leaves(self.state, body())
            self.launches = [{k: d[k] - w[k] for k in d}
                             for d, w in zip(_COUNTED, warm)]
        finally:
            for d, b in zip(_COUNTED, before):
                d.update(b)             # neither ran a solve's segment
        counts["admm.graph_captures"] += 1

    def load(self, s, rho_g, fac, st) -> None:
        _copy_leaves((self.s, self.rho_g, self.fac, self.state),
                     (s, rho_g, fac, st))

    def run(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        for d, grown in zip(_COUNTED, self.launches):
            for k, n in grown.items():
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


def _admm_loop_batched(s: _Scaled, w: WVars, y: ZGroups,
                       settings: QPSettings, nx: int, nu: int):
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
    (w, y, y_lo, it, prim, dual, status, rho, refactors) with (B,)
    termination state; y_lo is the low part of the polish's two-float
    dual (zeros where the polish was not accepted), rho each lane's final
    step size and refactors its 'cond' refactorizations.
    """
    nb = s.sh.shape[0]
    dtype, dev = s.sh.dtype, s.sh.device
    sigma = settings.sigma
    factorize, backsolve = _backend(settings)

    def refactor_lanes(rho_b, fac, lanes):
        """The factor of the given lanes at their new rho, scattered into
        the carried factor; the other lanes keep theirs."""
        diag, off = _assemble_blocks(s, _rho_groups(settings, rho_b, s),
                                     sigma)
        sub = factorize(diag.index_select(0, lanes),
                        off.index_select(0, lanes))
        return type(fac)(*(f.index_copy(0, lanes, g)
                           for f, g in zip(fac, sub)))

    rho_b = torch.full((nb,), settings.rho, dtype=dtype, device=dev)
    rho_g = _rho_groups(settings, rho_b, s)
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
                    loop.set_factor(_rho_groups(settings, rho_b, s),
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
    y_lo = ZGroups(*(torch.zeros_like(v) for v in y))

    if settings.polish:
        with span("qp.polish"):
            w_p, z_p, y_p, y_lo_p = _polish(s, settings, sigma, w, y, nx, nu)
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
    nx, nu = qp.A.shape[2], qp.n_u
    with span("qp.scale"):
        s = _ruiz(qp, settings.scaling_iters)
    if w0 is None:
        w = WVars(*(torch.zeros_like(d) for d in s.D))
    else:
        w = _wmap(lambda a, b: a / b, w0, s.D)
    if y0 is None:
        y = _zmap(torch.zeros_like, s.l)
    else:
        y = _zmap(lambda a, b: _bc(s.c, a) * a / b, y0, s.E)
    w, y, y_lo, it, prim, dual, status, rho, refactors = _admm_loop_batched(
        s, w, y, settings, nx, nu)
    w_un = _wmap(lambda a, d: a * d, w, s.D)

    def unscale(a, e):
        return a * e / _bc(s.c, a)
    return BlockQPSolution(X=w_un.x, U=w_un.u, t=w_un.t,
                           y=_zmap(unscale, y, s.E),
                           y_lo=_zmap(unscale, y_lo, s.E),
                           iterations=it, prim_res=prim, dual_res=dual,
                           converged=(status == STATUS_SOLVED),
                           status=status, rho=rho, refactors=refactors)
