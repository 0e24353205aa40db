"""DDP / iLQR trajectory optimizer.

Port of `centroidal_mpc_tpu/solver/ddp.py` (the reference's Crocoddyl
SolverFDDP stages, src/whole_body_control.py + run_motion.py:24-27,
:56-61).  The stage derivatives are `torch.func` transforms vmapped over
all knots at once (`vmap`, `jacfwd`, `grad`, `hessian` where the JAX
package uses them; one `jacfwd` over z = [x, u] a knot in the
Gauss-Newton form), the backward Riccati sweep and the rollouts are
Python loops over the knots, and the line search rolls out all its
candidate step sizes at once, as a leading batch axis of one rollout.
Each iteration reads one flag on the host (whether to stop).

The solver is generic over user-supplied `dynamics(x, u, k)`,
`stage_cost(x, u, k)` and `terminal_cost(x)` on one knot's x (nx,) and u
(nu,).  k is a Python int in the rollouts and a batched 0-d tensor under
the derivatives' vmap; index per-knot data with `take(a, k)`, which
serves both (`a[k]` with a batched tensor index is data-dependent
control flow to `vmap`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from centroidal_mpc_tpu_torch.ops.linalg import spd_inverse


@dataclasses.dataclass(frozen=True)
class DdpSettings:
    iterations: int = 20
    reg_init: float = 1e-6
    reg_increase: float = 10.0
    reg_decrease: float = 0.5
    reg_min: float = 1e-9
    reg_max: float = 1e6
    # candidate step sizes of the line search, rolled out at once
    n_alphas: int = 8
    tol_grad: float = 1e-9
    # Quu solver: the matmul-only Newton-Schulz inverse (False) stalls on
    # ill-conditioned Quu (whole-body torque problems, where tiny distal
    # inertias make Quu anisotropic); True uses an exact inverse.
    exact_quu: bool = False


@dataclasses.dataclass(frozen=True)
class DdpSolution:
    X: torch.Tensor           # (N+1, nx)
    U: torch.Tensor           # (N, nu)
    K: torch.Tensor           # (N, nu, nx) feedback gains of the last backward pass
    cost: torch.Tensor
    iterations: int
    reg: torch.Tensor
    improved: torch.Tensor    # bool: the last iteration reduced the merit


def take(a: torch.Tensor, k) -> torch.Tensor:
    """a[k] for a knot index k that is a Python int or a (batched) 0-d
    tensor."""
    if isinstance(k, int):
        return a[k]
    return a.index_select(0, k.reshape(1)).squeeze(0)


def solve_ilqr(dynamics: Callable, stage_cost: Callable,
               terminal_cost: Callable, x0: torch.Tensor, U0: torch.Tensor,
               settings: DdpSettings = DdpSettings()) -> DdpSolution:
    """iLQR with a regularized Riccati backward pass and a parallel line
    search.  dynamics(x, u, k) -> x_next; stage_cost(x, u, k) -> scalar;
    terminal_cost(x) -> scalar."""

    def derivatives(X, U, ks):
        xs = X[:-1]
        fx = vmap(jacfwd(dynamics, argnums=0))(xs, U, ks)
        fu = vmap(jacfwd(dynamics, argnums=1))(xs, U, ks)
        lx = vmap(grad(stage_cost, argnums=0))(xs, U, ks)
        lu = vmap(grad(stage_cost, argnums=1))(xs, U, ks)
        lxx = vmap(hessian(stage_cost, argnums=0))(xs, U, ks)
        luu = vmap(hessian(stage_cost, argnums=1))(xs, U, ks)
        lux = vmap(jacfwd(grad(stage_cost, argnums=1), argnums=0))(xs, U, ks)
        vx_t = grad(terminal_cost)(X[-1])
        vxx_t = hessian(terminal_cost)(X[-1])
        return fx, fu, lx, lu, lxx, luu, lux, vx_t, vxx_t

    def step_cost(x, u, k):
        return dynamics(x, u, k), stage_cost(x, u, k)

    return _solve_core(dynamics, stage_cost, terminal_cost, derivatives,
                       step_cost, x0, U0, settings)


def solve_ilqr_residual(dynamics: Callable, stage_residual: Callable,
                        terminal_residual: Callable, x0: torch.Tensor,
                        U0: torch.Tensor,
                        settings: DdpSettings = DdpSettings(),
                        X_init: Optional[torch.Tensor] = None,
                        knot: Optional[Callable] = None) -> DdpSolution:
    """Gauss-Newton iLQR over least-squares costs (Crocoddyl's residual
    models, reference src/whole_body_control.py:46-152).

    stage_residual(x, u, k) -> (nr,); terminal_residual(x) -> (nrT,);
    cost = sum_k r_k @ r_k + r_T @ r_T.  The backward pass takes the
    Gauss-Newton Hessian 2 J'J; one jacfwd over z = [x, u] a knot gives
    the dynamics and residual Jacobians together.  knot(x, u, k) ->
    (x_next, r), when given, computes both in one call (the whole-body
    model shares its contact-KKT solve between them); it is used for the
    derivatives and the rollouts, and must agree with the two functions.

    X_init (N+1, nx): a state-trajectory warm start that need not be a
    rollout of U0; it turns on the FDDP multiple-shooting mode (see
    _solve_core), the reference's SolverFDDP.solve(xs, us)."""
    nx = x0.shape[0]
    if knot is None:
        def knot(x, u, k):
            return dynamics(x, u, k), stage_residual(x, u, k)

    def stage_cost(x, u, k):
        r = stage_residual(x, u, k)
        return r @ r

    def terminal_cost(x):
        r = terminal_residual(x)
        return r @ r

    def step_cost(x, u, k):
        xn, r = knot(x, u, k)
        return xn, r @ r

    def derivatives(X, U, ks):
        def one(x, u, k):
            def g(z):
                out = knot(z[:nx], z[nx:], k)
                return out, out[1]
            (jf, jr), r = jacfwd(g, has_aux=True)(torch.cat([x, u]))
            jrx, jru = jr[:, :nx], jr[:, nx:]
            return (jf[:, :nx], jf[:, nx:], 2.0 * jrx.T @ r, 2.0 * jru.T @ r,
                    2.0 * jrx.T @ jrx, 2.0 * jru.T @ jru, 2.0 * jru.T @ jrx)

        fx, fu, lx, lu, lxx, luu, lux = vmap(one)(X[:-1], U, ks)
        r_t = terminal_residual(X[-1])
        j_t = jacfwd(terminal_residual)(X[-1])
        return (fx, fu, lx, lu, lxx, luu, lux, 2.0 * j_t.T @ r_t,
                2.0 * j_t.T @ j_t)

    return _solve_core(dynamics, stage_cost, terminal_cost, derivatives,
                       step_cost, x0, U0, settings, X_init=X_init)


def _solve_core(dynamics: Callable, stage_cost: Callable,
                terminal_cost: Callable, derivatives: Callable,
                step_cost: Callable, x0: torch.Tensor, U0: torch.Tensor,
                settings: DdpSettings,
                X_init: Optional[torch.Tensor] = None) -> DdpSolution:
    """iLQR core; with X_init it becomes FDDP (multiple shooting).

    FDDP mode (Crocoddyl SolverFDDP semantics): the iterate (X, U) may be
    dynamically infeasible with gaps d_k = f(x_k, u_k) - x_{k+1}.  The
    backward pass propagates the value function through the gaps (vx <-
    vx + vxx d_k); the forward pass contracts them, x_{k+1} = f(x_hat_k,
    u_k) - (1-alpha) d_k, so an alpha step leaves gaps scaled by
    (1-alpha).  Acceptance uses the merit cost + mu ||d||_1 (mu fixed from
    the initial iterate).  step_cost(x, u, k) -> (x_next, stage cost)
    gives the line search's rollouts the stage costs of the points they
    visit.
    """
    N, nu = U0.shape
    nx = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    ks = torch.arange(N, device=device)
    alphas = 2.0 ** (-torch.arange(settings.n_alphas, dtype=dtype,
                                   device=device))
    fddp = X_init is not None
    eye_u = torch.eye(nu, dtype=dtype, device=device)

    def rollout(U):
        xs = [x0]
        for k in range(N):
            xs.append(dynamics(xs[-1], U[k], k))
        return torch.stack(xs)

    def total_cost(X, U):
        return (vmap(stage_cost)(X[:-1], U, ks).sum()
                + terminal_cost(X[-1]))

    def gaps_of(X, U):
        return vmap(dynamics)(X[:-1], U, ks) - X[1:]

    def backward(derivs, gaps, reg):
        fx, fu, lx, lu, lxx, luu, lux, vx, vxx = derivs
        k_ff, k_fb, qus = [None] * N, [None] * N, [None] * N
        for k in reversed(range(N)):
            # FDDP gap term: the value gradient seen across transition k
            # is evaluated at f(x_k, u_k) = x_{k+1} + d_k
            vx_g = vx + vxx @ gaps[k]
            fxt, fut = fx[k].T, fu[k].T
            qx = lx[k] + fxt @ vx_g
            qu = lu[k] + fut @ vx_g
            qxx = lxx[k] + fxt @ vxx @ fx[k]
            quu = luu[k] + fut @ vxx @ fu[k] + reg * eye_u
            qux = lux[k] + fut @ vxx @ fx[k]
            # inv_ex: a singular Quu gives inf/NaN, as jnp.linalg.inv
            # does, and no host sync checks it
            quu_inv = (torch.linalg.inv_ex(quu)[0] if settings.exact_quu
                       else spd_inverse(quu))
            kf = -quu_inv @ qu
            kb = -quu_inv @ qux
            vx = qx + kb.T @ quu @ kf + kb.T @ qu + qux.T @ kf
            vxx = qxx + kb.T @ quu @ kb + kb.T @ qux + qux.T @ kb
            vxx = 0.5 * (vxx + vxx.T)
            k_ff[k], k_fb[k], qus[k] = kf, kb, qu
        return (torch.stack(k_ff), torch.stack(k_fb),
                torch.stack(qus).abs().max())

    def forward(X_bar, U_bar, gaps, k_ff, k_fb):
        """Every candidate alpha at once: (Xs (A, N+1, nx), Us (A, N, nu),
        costs (A,))."""
        a = alphas[:, None]
        x = x0.expand(settings.n_alphas, nx)
        xs, us, costs = [x], [], []
        for k in range(N):
            u = (U_bar[k] + a * k_ff[k]
                 + (k_fb[k] @ (x - X_bar[k])[..., None])[..., 0])
            xn, c = vmap(step_cost, in_dims=(0, 0, None))(x, u, k)
            costs.append(c)
            x = xn - (1.0 - a) * gaps[k]
            xs.append(x)
            us.append(u)
        Xs, Us = torch.stack(xs, dim=1), torch.stack(us, dim=1)
        return Xs, Us, (torch.stack(costs, dim=1).sum(1)
                        + vmap(terminal_cost)(Xs[:, -1]))

    if fddp:
        X = torch.cat([x0[None], X_init[1:].to(dtype)])
    else:
        X = rollout(U0)
    U = U0
    cost = total_cost(X, U)
    gapnorm = (gaps_of(X, U).abs().sum() if fddp
               else torch.zeros((), dtype=dtype, device=device))
    # merit weight: gap closure worth ~10x the initial cost per unit gap
    mu = 10.0 * (cost.abs() + 1.0) / (gapnorm + 1e-9) if fddp else 0.0
    K = torch.zeros((N, nu, nx), dtype=dtype, device=device)
    reg = torch.tensor(settings.reg_init, dtype=dtype, device=device)
    improved = torch.tensor(True, device=device)
    zero_gaps = torch.zeros((N, nx), dtype=dtype, device=device)
    it = 0
    while it < settings.iterations:
        derivs = derivatives(X, U, ks)
        gaps = gaps_of(X, U) if fddp else zero_gaps
        k_ff, k_fb, grad_norm = backward(derivs, gaps, reg)
        Xs, Us, costs = forward(X, U, gaps, k_ff, k_fb)
        costs = torch.where(torch.isnan(costs),
                            torch.full_like(costs, float("inf")), costs)
        if fddp:
            gapnorms = (1.0 - alphas) * gapnorm
            merits = costs + mu * gapnorms
            merit_cur = cost + mu * gapnorm
        else:
            gapnorms = torch.zeros_like(costs)
            merits = costs
            merit_cur = cost
        best = torch.argmin(merits)
        improved = merits[best] < merit_cur - 1e-12
        X = torch.where(improved, Xs[best], X)
        U = torch.where(improved, Us[best], U)
        cost = torch.where(improved, costs[best], cost)
        gapnorm = torch.where(improved, gapnorms[best], gapnorm)
        done = (((grad_norm < settings.tol_grad) & (gapnorm < 1e-9))
                | (~improved & (reg >= settings.reg_max)))
        reg = torch.clamp(
            torch.where(improved, reg * settings.reg_decrease,
                        reg * settings.reg_increase),
            settings.reg_min, settings.reg_max)
        K = k_fb
        it += 1
        if bool(done):
            break
    return DdpSolution(X=X, U=U, K=K, cost=cost, iterations=it, reg=reg,
                       improved=improved)
