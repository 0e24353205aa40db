"""Independent QP solution certification (host-side, scipy, float64).

A copy of `centroidal_mpc_tpu/ops/certify.py` (numpy and scipy only),
kept in the port so that it imports nothing of the JAX package;
`flatten_block_solution` reads the port's batch-first BlockQPSolution.

The reference certifies nothing: it trusts OSQP at eps 1e-7 with polish
(src/scp_solver.py:59-68).  That oracle cannot run here (no osqp in the
environment), so this module is the strongest feasible substitute
(VERDICT round 1, item 2a): a from-first-principles *active-set KKT
solver* built only on scipy sparse LU -- a completely independent code
path from the ADMM solvers (ops/admm.py, ops/blockqp.py) -- used to

  1. compute a reference solution x_ref whose KKT residuals are at
     machine-precision level (<= 1e-8), and
  2. measure ||x_admm - x_ref||_inf, certifying the production solver's
     answers on the full reference-scale problems (N=165 trot).

Method: warm-started primal-dual active-set iteration.  Given a guess of
the active rows, solve the equality-constrained KKT system

    [ P   A_a' ] [x ]   [ -q  ]
    [ A_a  0   ] [nu] = [ b_a ]

via a quasi-definite regularization (P + dI, -dI block; always
factorizable, like OSQP's polish KKT) with iterative refinement against
the *unregularized* system to drive the d-perturbation below 1e-12.
Rows are activated when violated, deactivated on wrong-sign multipliers,
until the active set is stable.  Everything is float64 numpy/scipy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def flatten_block_solution(bsol, N: int, point3: bool = True,
                           lane: int = 0):
    """(x, y) of one lane of a batch-first blockqp.BlockQPSolution in the
    dense reference layout (solver/ocp.py module doc): z = [X | U |
    t_state | t_ctrl(=0, unused)], rows = [init | dyn | final | (cop) |
    fric | trust | slack].  Friction rows are contact-major then knot
    (src/constraints.py:169-217); CoP rows contact-major then axis then
    knot (src/constraints.py:111-145).  The dual is the two-float pair's
    sum y + y_lo, in float64 (y_lo is zero unless the polish was
    accepted)."""
    def a(t):
        return t[lane].detach().cpu().double().numpy()

    x = np.concatenate([a(bsol.X).ravel(), a(bsol.U).ravel(), a(bsol.t),
                        np.zeros(N)])
    y = type(bsol.y)(*(a(hi) + a(lo) for hi, lo in zip(bsol.y, bsol.y_lo)))
    parts = [y.init, y.dyn.ravel(), y.final]
    if not point3:
        parts.append(y.cop.transpose(1, 2, 0).ravel())
    parts += [y.fric.transpose(1, 0, 2).ravel(), y.trust.ravel(), y.slack]
    return x, np.concatenate(parts)


@dataclasses.dataclass
class CertifyResult:
    x: np.ndarray             # reference primal solution
    y: np.ndarray             # reference duals (OSQP sign convention)
    stationarity: float       # ||P x + q + A' y||_inf
    primal_violation: float   # max(0, l - Ax, Ax - u)
    comp_slack: float         # max distance-to-bound over rows carrying a
                              # nonzero multiplier (and max |y| off-support)
    active_set_iters: int
    converged: bool


def _kkt_solve(P, A_a, q, b_a, delta: float, refine: int = 30,
               rtol: float = 1e-13):
    """Solve the equality KKT system by regularized sparse LU + iterative
    refinement against the unregularized operator (until the relative
    residual stalls below rtol or `refine` sweeps)."""
    n = P.shape[0]
    ma = A_a.shape[0]
    K_reg = sp.bmat(
        [[P + delta * sp.eye(n), A_a.T],
         [A_a, -delta * sp.eye(ma)]], format="csc")
    lu = spla.splu(K_reg)
    rhs = np.concatenate([-q, b_a])
    scale = np.abs(rhs).max() + 1.0
    sol = lu.solve(rhs)
    # refinement vs the true (delta=0) KKT matrix
    K0 = sp.bmat([[P, A_a.T], [A_a, None]], format="csr")
    for _ in range(refine):
        r = rhs - K0 @ sol
        if np.abs(r).max() < rtol * scale:
            break
        sol = sol + lu.solve(r)
    return sol[:n], sol[n:]


def certify_qp_solution(P, q, A, l, u, x0=None, y0=None,
                        tol: float = 1e-8, max_iter: int = 50,
                        delta: float = 1e-9,
                        active_tol: float = 1e-6) -> CertifyResult:
    """Independent high-accuracy solve of min 1/2 x'Px + q'x,
    l <= Ax <= u, warm-started from (x0, y0) (e.g. an ADMM solution).

    Equality rows (u - l below ~1e-9, e.g. the reference's +-1e-12
    dynamics slack) are always active at their midpoint.
    """
    P = sp.csc_matrix(np.asarray(P, np.float64))
    A_full = np.asarray(A, np.float64)
    A_sp = sp.csr_matrix(A_full)
    q = np.asarray(q, np.float64)
    l = np.asarray(l, np.float64)
    u = np.asarray(u, np.float64)
    m, n = A_full.shape
    finite_l = l > -1e19
    finite_u = u < 1e19
    is_eq = finite_l & finite_u & (u - l < 1e-9)
    b_eq = 0.5 * (l + u)

    if x0 is None:
        x = np.zeros(n)
    else:
        x = np.asarray(x0, np.float64).copy()
    if y0 is None:
        y = np.zeros(m)
    else:
        y = np.asarray(y0, np.float64).copy()

    z = A_sp @ x
    act_up = is_eq | (finite_u & ((u - z < active_tol) | (y > 1e-10)))
    act_lo = (~act_up) & finite_l & ((z - l < active_tol) | (y < -1e-10))

    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        active = act_up | act_lo
        idx = np.flatnonzero(active)
        b_a = np.where(is_eq, b_eq, np.where(act_up, u, l))[idx]
        x, nu = _kkt_solve(P, A_sp[idx], q, b_a, delta)
        y = np.zeros(m)
        y[idx] = nu
        z = A_sp @ x

        # violations -> activate at the violated bound
        viol_up = finite_u & ~active & (z > u + tol)
        viol_lo = finite_l & ~active & (z < l - tol)
        # wrong-sign multipliers -> deactivate (not equality rows)
        wrong_up = act_up & ~is_eq & (y < -tol)
        wrong_lo = act_lo & ~is_eq & (y > tol)
        changed = viol_up | viol_lo | wrong_up | wrong_lo
        if not changed.any():
            converged = True
            break
        act_up = (act_up & ~wrong_up) | viol_up
        act_lo = (act_lo & ~wrong_lo) | viol_lo

    stat = float(np.abs(P @ x + q + A_sp.T @ y).max())
    pviol = float(np.maximum(np.maximum(l - z, z - u), 0.0).max())
    inactive = ~(act_up | act_lo)
    dist = np.where(
        act_up, np.abs(z - np.where(is_eq, b_eq, u)),
        np.where(act_lo, np.abs(z - l), 0.0))
    y_scale = np.abs(y).max() + 1.0
    support = np.abs(y) > 1e-8 * y_scale
    comp = float(dist[support].max()) if support.any() else 0.0
    comp = max(comp, float(np.abs(y[inactive]).max()) if inactive.any()
               else 0.0)
    return CertifyResult(x=x, y=y, stationarity=stat,
                         primal_violation=pviol, comp_slack=comp,
                         active_set_iters=it, converged=converged)
