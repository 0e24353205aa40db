"""QP solver settings and status codes.

Port of `QPSettings` and `STATUS_*` from `centroidal_mpc_tpu/ops/admm.py`
(every field, the same defaults).  The dense solver `solve_qp` is not
ported; the block solver in `ops/blockqp.py` reads these settings.
"""
from __future__ import annotations

import dataclasses

# Solver status codes (QPSolution.status / BlockQPSolution.status).
# MAX_ITER means the iteration budget ran out without meeting the
# tolerance OR certifying infeasibility; SOLVED mirrors `converged`.
STATUS_MAX_ITER = 0
STATUS_SOLVED = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_DUAL_INFEASIBLE = 3


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
    # Each lane carries its own rho and factor.
    adaptive_rho_mode: str = "cond"
    eq_rho_scale: float = 1e3
    # Block-solver factorization.  'cholesky' and 'pallas' both run the
    # blocked Cholesky with pre-inverted factors of ops/block_tridiag
    # (the hand-written CUDA kernels on a CUDA tensor, their plain
    # PyTorch versions on a CPU tensor); 'thomas' raises
    # NotImplementedError.
    factor_method: str = "cholesky"
    # Block-solver sweep: 'scan' (sequential over knots); 'assoc' raises
    # NotImplementedError.
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
