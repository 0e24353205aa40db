"""Dense ADMM QP solver with OSQP semantics, batch-first, and the QP
settings and status codes that the block solver shares.

Port of `centroidal_mpc_tpu/ops/admm.py`: `QPSettings` (every field, the
same defaults), `STATUS_*`, `ruiz_equilibrate` and `solve_qp` with
OSQP's modified Ruiz equilibration, per-row step sizes (rho_eq = 1e3 rho
on equality rows, rho / 1e3 on free rows), over-relaxation, unscaled
residual termination, the primal/dual infeasibility certificates, the
best-so-far safeguard, adaptive rho and warm starts.

Every tensor carries a leading scenario axis B.  The loop runs segments
of `check_interval` iterations with one host sync a segment, as the
block solver's does; a lane that is done keeps its state (the semantics
of the JAX package's `while_loop` under vmap), and with adaptive rho only
the lanes whose residual ratio leaves the deadband are refactored.  The
products, Cholesky factors and triangular solves are PyTorch library
calls: the JAX package computes them in XLA, outside any Pallas kernel.

`counts` counts the ADMM loop's work and its blocking host reads, for
this solver and the block solver (`ops.blockqp`) alike, and how the block
solver ran its segments on the card: `admm.graph_captures`, the segments
captured as a CUDA graph (one a new combination of device, shapes and
settings), and `admm.graph_replays`, the segments run as a replay of
one (all of them on the card; none on the CPU, and none in this solver,
which dispatches its segments eagerly).  The loops' spans
(`utils.profiling.span`) are `qp.scale`, `admm.factor`, `admm.segment`
and one `sync.*` a blocking read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from centroidal_mpc_tpu_torch._tree import select
from centroidal_mpc_tpu_torch.solver.ocp import INF, QPData
from centroidal_mpc_tpu_torch.utils.profiling import span

# Solver status codes (QPSolution.status / BlockQPSolution.status).
# MAX_ITER means the iteration budget ran out without meeting the
# tolerance OR certifying infeasibility; SOLVED mirrors `converged`.
STATUS_MAX_ITER = 0
STATUS_SOLVED = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_DUAL_INFEASIBLE = 3

# The ADMM loops' counters (read through `utils.profiling.counters`):
# residual segments run, ADMM iterations run (segments x check_interval,
# on every lane of the batch), refactor calls after the first factor, and
# the blocking host reads: the end-of-loop test (`sync.admm`, one a
# segment and one at the loop's end) and the refactored lanes' gather
# (`sync.refactor`, one a segment with adaptive rho); and the block
# solver's captured segment graphs and their replays (module docstring).
counts = {"admm.segments": 0, "admm.iterations": 0,
          "admm.refactor_calls": 0, "sync.admm": 0, "sync.refactor": 0,
          "admm.graph_captures": 0, "admm.graph_replays": 0}


@dataclasses.dataclass(frozen=True)
class QPSettings:
    """Static solver settings (OSQP defaults unless noted)."""

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-7   # reference src/scp_solver.py:63
    eps_rel: float = 1e-7
    max_iter: int = 20000
    check_interval: int = 25   # residual/adaptation cadence (OSQP default)
    scaling_iters: int = 10
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0
    # 'cond': refactor only when the prim/dual ratio leaves the deadband;
    # 'always': refactor at every residual check with the deadbanded rho.
    # The port's block solver takes both names and runs one loop for
    # them: a lane's rho moves only when it triggers, so refactoring it
    # then ('cond') or at every check ('always') gives the same iterates.
    # Each lane carries its own rho and factor.  The dense solver
    # refactors a lane when it triggers, whatever the mode name.
    adaptive_rho_mode: str = "cond"
    eq_rho_scale: float = 1e3
    # Block-solver factorization.  'cholesky' and 'pallas' both run the
    # blocked Cholesky with pre-inverted factors of ops/block_tridiag
    # (the hand-written CUDA kernels on a CUDA tensor, their plain
    # PyTorch versions on a CPU tensor); 'thomas' is the block-Thomas
    # factor with Newton-Schulz Schur-complement inverses (plain PyTorch;
    # its inverse error compounds through the knot recursion and breaks
    # f32 convergence, as in the JAX package).  Ignored by the dense
    # solver.
    factor_method: str = "cholesky"
    # Block-solver sweep: 'scan' (sequential over knots: the sweep
    # kernels on the card) or 'assoc' (a log-depth doubling scan over the
    # knots in plain PyTorch, more operations and fewer dependent steps).
    # Ignored by the dense solver and by 'thomas'.
    sweep_method: str = "scan"
    # Block-solver solution polish (the OSQP polish step, reference
    # src/scp_solver.py:62, as a masked active-set ALM — see
    # blockqp._polish).  One extra factorization + polish_iters sweeps
    # after termination; the polished iterate is kept only if it improves
    # max(prim, dual).  Lets the main loop run at loose eps while
    # delivering tight-solution quality.  Ignored by the dense solver.
    polish: bool = False
    polish_rho: float = 1e3
    polish_iters: int = 12
    polish_active_tol: float = 1e-3
    # Proximal regularization of the polish factorization only (the
    # polish fixed point is sigma-independent -- see blockqp._polish).
    # Sized so cond(M) ~ polish_rho / polish_sigma keeps cond * eps_f32
    # well below 1 (the refinement contracts) while staying small
    # against P's weakest curvature.
    polish_sigma: float = 1e-3
    # Active-set re-detection rounds: at loose main-loop eps the first
    # detection can mislabel weakly-active rows; each round re-detects
    # from the polished iterate (one extra factorization per round).
    polish_rounds: int = 2
    # Per-round multiplier of (polish_rho, polish_sigma): the ALM
    # multiplier iteration contracts like 1/(1 + rho*lambda) per active-
    # row eigendirection, so near-degenerate directions need larger rho;
    # ramping keeps round 1 f32-conservative and sharpens later rounds
    # at constant cond(M).
    polish_rho_ramp: float = 1.0
    # Dual refinement: CG iterations on the ALM-preconditioned dual
    # normal equations S dy = -A M^-1 g (see blockqp._polish).  The ALM
    # y-update is Richardson iteration on the same system and leaves the
    # dual residual large on near-degenerate active-row directions; CG
    # converges those.  The refined dual is carried as a two-float
    # (hi, lo) pair (blockqp._two_sum): one f32 ulp of the O(1e2) scaled
    # equality duals is the size of a whole eps=1e-5 dual residual.
    # 0 disables.
    polish_cg_iters: int = 15
    # CG restart phases, each from a freshly evaluated residual.
    polish_cg_restarts: int = 2
    # Stall exit (block solver): leave the ADMM loop early when the
    # best-so-far max(prim, dual) has not improved by >= 1% for this
    # many consecutive residual checks -- an f32 iterate at its
    # arithmetic floor makes no further progress, and with polish on
    # the refinement pass closes the remaining gap far cheaper than
    # burning max_iter.  0 disables (run to tolerance or max_iter).
    stall_segments: int = 0
    # OSQP primal/dual infeasibility certificates (delta-y / delta-x
    # tests at every residual check; see blockqp._certificates).  An
    # infeasible QP exits with a distinct status in well under the
    # iteration budget instead of burning max_iter (the reference aborts
    # its SCP loop on OSQP's version of these statuses,
    # src/scp_solver.py:59-68).
    check_infeasibility: bool = True
    eps_pinf: float = 1e-4   # OSQP eps_prim_inf default
    eps_dinf: float = 1e-4   # OSQP eps_dual_inf default


@dataclasses.dataclass(frozen=True)
class QPSolution:
    """Result of a batch of dense solves (unscaled)."""

    x: torch.Tensor            # (B, n) primal solution
    y: torch.Tensor            # (B, m) dual solution
    z: torch.Tensor            # (B, m) projected constraint values
    iterations: torch.Tensor   # (B,) int32
    prim_res: torch.Tensor     # (B,)
    dual_res: torch.Tensor     # (B,)
    converged: torch.Tensor    # (B,) bool
    status: torch.Tensor       # (B,) int32 STATUS_*
    # the port's addition (the JAX QPSolution has none):
    refactors: torch.Tensor    # (B,) int32 adaptive-rho refactorizations


def _lane_max(a: torch.Tensor) -> torch.Tensor:
    return a.abs().amax(-1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: M (B, r, c), v (B, c) -> (B, r)."""
    return (M @ v[..., None])[..., 0]


def ruiz_equilibrate(qp: QPData, iters: int):
    """Modified Ruiz equilibration of [[P, A'], [A, 0]] with cost scaling,
    per scenario.  Returns (scaled QPData, D (B, n), E (B, m), c (B,)).
    All-zero rows or columns scale by 1."""
    P, q, A = qp.P, qp.q, qp.A
    nb, n, m = P.shape[0], P.shape[-1], A.shape[-2]
    D = torch.ones((nb, n), dtype=P.dtype, device=P.device)
    E = torch.ones((nb, m), dtype=P.dtype, device=P.device)
    c = torch.ones(nb, dtype=P.dtype, device=P.device)

    def inv_sqrt(a):
        return 1.0 / torch.sqrt(torch.where(a > 0, a, torch.ones_like(a)))

    for _ in range(iters):
        d = inv_sqrt(torch.maximum(P.abs().amax(-2), A.abs().amax(-2)))
        e = inv_sqrt(A.abs().amax(-1))
        P = d[:, :, None] * P * d[:, None, :]
        A = e[:, :, None] * A * d[:, None, :]
        q = d * q
        # cost normalization (OSQP): gamma = 1/max(mean col norm P, |q|_inf)
        gamma_den = torch.maximum(P.abs().amax(-2).mean(-1), _lane_max(q))
        gamma = 1.0 / torch.where(gamma_den > 0, gamma_den,
                                  torch.ones_like(gamma_den))
        P, q, c = P * gamma[:, None, None], q * gamma[:, None], c * gamma
        D, E = D * d, E * e
    l = torch.clamp(E * qp.l, -INF, INF)
    u = torch.clamp(E * qp.u, -INF, INF)
    return QPData(P=P, q=q, A=A, l=l, u=u), D, E, c


def _rho_vector(l, u, rho, settings: QPSettings):
    """Per-row step sizes from per-lane rho (B, 1) or a scalar."""
    eq = (u - l) < 1e-10
    loose = (l <= -INF) & (u >= INF)
    return torch.where(eq, settings.eq_rho_scale * rho,
                       torch.where(loose, rho / settings.eq_rho_scale,
                                   rho * torch.ones_like(l)))


def solve_qp(qp: QPData, settings: QPSettings = QPSettings(),
             x0: Optional[torch.Tensor] = None,
             y0: Optional[torch.Tensor] = None) -> QPSolution:
    """Solve min 1/2 x'Px + q'x s.t. l <= Ax <= u for every scenario of
    the batch.  x0 (B, n) / y0 (B, m): unscaled warm starts."""
    with span("qp.scale"):
        scaled, D, E, c = ruiz_equilibrate(qp, settings.scaling_iters)
    P, q, A, l, u = scaled.P, scaled.q, scaled.A, scaled.l, scaled.u
    nb, n = P.shape[0], P.shape[-1]
    dtype, dev = P.dtype, P.device
    sigma, alpha = settings.sigma, settings.alpha
    n_segments = -(-settings.max_iter // settings.check_interval)
    max_it = n_segments * settings.check_interval
    sigma_eye = sigma * torch.eye(n, dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def factor(rho_b, lanes=None):
        """Cholesky factor of M = P + sigma I + A' diag(rho) A and the row
        step sizes of the given lanes (all when None)."""
        Pl, Al, ll, ul = ((P, A, l, u) if lanes is None else
                          (t.index_select(0, lanes) for t in (P, A, l, u)))
        rho_vec = _rho_vector(ll, ul, rho_b[:, None], settings)
        M = Pl + sigma_eye + (Al.mT * rho_vec[:, None, :]) @ Al
        return torch.linalg.cholesky(M), rho_vec

    rho_b = torch.full((nb,), settings.rho, dtype=dtype, device=dev)
    with span("admm.factor"):
        L, rho_vec = factor(rho_b)
    refactors = torch.zeros(nb, **i32)

    # warm start in scaled space: x = D x_scaled, y = E y_scaled / c
    x = torch.zeros((nb, n), dtype=dtype, device=dev) if x0 is None \
        else x0 / D
    y = torch.zeros_like(l) if y0 is None else c[:, None] * y0 / E
    z = _mv(A, x)

    def admm_iter(x, z, y):
        rhs = sigma * x - q + _mv(A.mT, rho_vec * z - y)
        w = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
        x_t = torch.linalg.solve_triangular(L.mT, w, upper=True)[..., 0]
        z_t = _mv(A, x_t)
        x_new = alpha * x_t + (1 - alpha) * x
        z_rel = alpha * z_t + (1 - alpha) * z
        z_new = torch.clamp(z_rel + y / rho_vec, l, u)
        y_new = y + rho_vec * (z_rel - z_new)
        return x_new, z_new, y_new

    fin_u = (u / E) < 0.5 * INF
    fin_l = (l / E) > -0.5 * INF

    def certificates(dx, dy):
        """OSQP primal/dual infeasibility tests (Stellato et al. sec. 3.4)
        on a segment's iterate deltas, against the unscaled problem
        (candidates ybar = E dy, xbar = D dx; positive scalars dropped);
        (B,) bools."""
        y_norm = _lane_max(E * dy)
        atdy = _lane_max(_mv(A.mT, dy) / D)
        eps_p = (settings.eps_pinf * y_norm)[:, None]
        zero = torch.zeros_like(dy)
        # support over finite bounds only; infinite-bound rows need the
        # recession-feasible dy sign within eps (OSQP convention)
        sup = (torch.where(fin_u, u * dy.clamp(min=0.0), zero)
               + torch.where(fin_l, l * dy.clamp(max=0.0), zero)).sum(-1)
        sign_ok = ((fin_u | (E * dy <= eps_p)).all(-1)
                   & (fin_l | (E * dy >= -eps_p)).all(-1))
        pinf = ((y_norm > 0) & (atdy <= eps_p[:, 0]) & sign_ok
                & (sup <= -eps_p[:, 0]))

        x_norm = _lane_max(D * dx)
        pdx = _lane_max(_mv(P, dx) / D) / c
        qdx = (q * dx).sum(-1) / c
        adx = _mv(A, dx) / E
        eps_d = (settings.eps_dinf * x_norm)[:, None]
        cone_ok = ((~fin_u | (adx <= eps_d)).all(-1)
                   & (~fin_l | (adx >= -eps_d)).all(-1))
        dinf = ((x_norm > 0) & (pdx <= eps_d[:, 0]) & (qdx <= -eps_d[:, 0])
                & cone_ok)
        return pinf, dinf

    it = torch.zeros(nb, **i32)
    inf = torch.full((nb,), float("inf"), dtype=dtype, device=dev)
    prim, dual = inf, inf
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    status = torch.zeros(nb, **i32)
    xb, zb, yb, pb, db = x, z, y, inf, inf

    while True:
        frozen = done | (it >= max_it)
        counts["sync.admm"] += 1
        with span("sync.admm"):
            stop = bool(frozen.all())       # one host sync a segment
        if stop:
            break
        counts["admm.segments"] += 1
        counts["admm.iterations"] += settings.check_interval
        with span("admm.segment"):
            x2, z2, y2 = x, z, y
            for _ in range(settings.check_interval):
                x2, z2, y2 = admm_iter(x2, z2, y2)

            # unscaled residuals (OSQP sec. 5.1), once per segment
            Ax, Px, Aty = _mv(A, x2), _mv(P, x2), _mv(A.mT, y2)
            prim_n = _lane_max((Ax - z2) / E)
            dual_n = _lane_max((Px + q + Aty) / D) / c
            prim_scale = torch.maximum(_lane_max(Ax / E), _lane_max(z2 / E))
            dual_scale = torch.maximum(
                torch.maximum(_lane_max(Px / D), _lane_max(Aty / D)),
                _lane_max(q / D)) / c
            eps_prim = settings.eps_abs + settings.eps_rel * prim_scale
            eps_dual = settings.eps_abs + settings.eps_rel * dual_scale
            done_new = (prim_n < eps_prim) & (dual_n < eps_dual)
            status_new = torch.where(done_new,
                                     torch.full((), STATUS_SOLVED, **i32),
                                     torch.full((), STATUS_MAX_ITER, **i32))
            if settings.check_infeasibility:
                pinf, dinf = certificates(x2 - x, y2 - y)
                status_new = torch.where(
                    pinf & ~done_new,
                    torch.full((), STATUS_PRIMAL_INFEASIBLE, **i32),
                    torch.where(dinf & ~done_new,
                                torch.full((), STATUS_DUAL_INFEASIBLE, **i32),
                                status_new))
                done_new = done_new | ((pinf | dinf) & ~done_new)

            # best-so-far safeguard: a stalled or drifting iterate never
            # worsens the returned solution
            improve = (torch.maximum(prim_n, dual_n)
                       < torch.maximum(pb, db)) & ~frozen
            xb, zb, yb = select(improve, (x2, z2, y2), (xb, zb, yb))
            pb = torch.where(improve, prim_n, pb)
            db = torch.where(improve, dual_n, db)

            x, z, y = select(frozen, (x, z, y), (x2, z2, y2))
            it = torch.where(frozen, it, it + settings.check_interval)
            prim = torch.where(frozen, prim, prim_n)
            dual = torch.where(frozen, dual, dual_n)
            status = torch.where(frozen, status, status_new)
            done = done | (done_new & ~frozen)
            if settings.adaptive_rho:
                # OSQP adaptive rho at segment granularity; only the lanes
                # that trigger and run on are refactored
                ratio = torch.sqrt(
                    (prim_n / prim_scale.clamp(min=1e-30))
                    / (dual_n / dual_scale.clamp(min=1e-30)).clamp(min=1e-30))
                trigger = (((ratio > settings.adaptive_rho_tol)
                            | (ratio < 1.0 / settings.adaptive_rho_tol))
                           & ~done & (it < max_it))
        if settings.adaptive_rho:
            counts["sync.refactor"] += 1
            with span("sync.refactor"):
                lanes = trigger.nonzero()[:, 0]
            if lanes.numel():
                counts["admm.refactor_calls"] += 1
                with span("admm.factor"):
                    rho_b = torch.where(
                        trigger, (rho_b * ratio).clamp(1e-6, 1e6), rho_b)
                    L_sub, rv_sub = factor(rho_b.index_select(0, lanes),
                                           lanes)
                    L = L.index_copy(0, lanes, L_sub)
                    rho_vec = rho_vec.index_copy(0, lanes, rv_sub)
                    refactors = refactors.index_add(
                        0, lanes, torch.ones_like(lanes, dtype=torch.int32))

    # adopt the best-so-far iterate where it beats the final one
    adopt = torch.maximum(pb, db) < torch.maximum(prim, dual)
    x, z, y = select(adopt, (xb, zb, yb), (x, z, y))
    prim = torch.where(adopt, pb, prim)
    dual = torch.where(adopt, db, dual)
    return QPSolution(x=D * x, y=E * y / c[:, None], z=z / E,
                      iterations=it, prim_res=prim, dual_res=dual,
                      converged=(status == STATUS_SOLVED), status=status,
                      refactors=refactors)
