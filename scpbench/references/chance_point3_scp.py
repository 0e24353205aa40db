"""Plain reference of the chance-constrained centroidal SCP for point-foot
robots.

The deterministic reference (`point3_scp.py`, loaded here by path, not
changed) with the upstream project's individual chance constraints on
the friction pyramid (src/constraints.py:157, 187-214) and the
closed-loop covariance they are built from (src/centroidal_model.py:
217-238, 266), in plain PyTorch.  It imports nothing of the program and
takes nothing the program made: the gains, the covariance and the
back-offs are worked out again from the configuration file and the
benchmark's own inputs.

With the frozen linearization about (Xb, Ub) = (X0, U0), once a solve:
    C_k      = d f / d (contact positions) at knot k, by automatic
               differentiation of the dynamics (not the program's closed
               form)
    K_k      the truncated-DARE gains at `scp.lqr_iters` steps
    Sigma_0  = 0;  Sigma_{k+1} = (A_k + B_k K_k) Sigma_k (A_k + B_k K_k)'
               + C_k cov_w C_k' + dt cov_eta
    xi       = Phi^-1(1 - beta_u / 5 * 3)   (evaluated left to right)
    b_kcr    = xi 2 sum_j G_rj sqrt((K_k Sigma_k K_k')_jj), over the
               force components j of contact c with G_rj > 1e-6 and
               sqrt(.) > 1e-6; b = 0 at knot 0
with G the rotated rows of the inner friction pyramid.  Each back-off
lowers its friction row's upper bound: (G R_c')_r . u_kc <= -b_kcr, in
the QP that is solved and in `primal_ratio`.

Departures from the upstream, each also the program's:
  - the upstream adds dSigma/dz terms to each back-off built from
    gradient tensors that are identically zero; only the constant
    back-off is kept;
  - the covariance is propagated in the closed-loop form above, which
    equals the upstream [A B] Sigma_xu [A B]' with
    Sigma_xu = [[S, S K'], [K S, K S K']];
  - the gains take `scp.lqr_iters` DARE steps (the pipeline's stage 2'
    takes 30; the upstream's compute_lqr_feedback_gains takes 2);
  - cov_eta is the configuration's diagonal times dt, as the program's
    presets scale it.
Every departure of `point3_scp.py` holds here too.
"""
from __future__ import annotations

import importlib.util
import pathlib
import statistics

import torch

_spec = importlib.util.spec_from_file_location(
    "scpbench_ref_point3_scp_base",
    pathlib.Path(__file__).resolve().with_name("point3_scp.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

N_X = base.N_X
contact_plan = base.contact_plan
warm_start = base.warm_start
GATE = 1e-6


def contact_jacobian(cfg: dict, X, U, position, logic):
    """C (L, N, nx, 3C) = d step / d contact positions at every knot of
    X (L, N+1, nx), U (L, N, nu), by forward-mode differentiation of
    `dynamics`."""
    def step(p, x, u, lg):
        return base.dynamics(cfg, x, u, p, lg)

    jac = torch.func.vmap(torch.func.jacfwd(step))
    L, N = U.shape[:2]
    xs, us = X[:, :-1].reshape(L * N, -1), U.reshape(L * N, -1)
    pos = position.expand(L, *position.shape).reshape(L * N, -1, 3)
    lg = logic.expand(L, *logic.shape).reshape(L * N, -1)
    return jac(pos, xs, us, lg).reshape(L, N, N_X, -1)


def covariance(A, B, C, K, cov_w, cov_eta, matmul=torch.matmul):
    """Sigma (L, N+1, nx, nx) of the closed loop x+ = (A + B K) x + C w +
    eta from Sigma_0 = 0; cov_w (3C, 3C), cov_eta (nx, nx) already
    scaled by dt."""
    acl = A + matmul(B, K)
    noise = matmul(matmul(C, cov_w), C.mT) + cov_eta
    sigmas = [torch.zeros(A.shape[0], N_X, N_X, dtype=A.dtype,
                          device=A.device)]
    for k in range(A.shape[1]):
        a = acl[:, k]
        sigmas.append(matmul(matmul(a, sigmas[-1]), a.mT) + noise[:, k])
    return torch.stack(sigmas, 1)


def quantile(beta_u: float) -> float:
    """xi = Phi^-1(1 - beta_u / 5 * 3) (src/constraints.py:157)."""
    return statistics.NormalDist().inv_cdf(1.0 - beta_u / 5.0 * 3.0)


def backoffs(K, Sigma, G, rotation, logic, xi: float,
             matmul=torch.matmul):
    """(L, N, C, 4) back-off of each tangential pyramid row of each
    contact and knot: xi 2 sum_j G_rj sqrt((K Sigma K')_jj) over the
    gated j, 0 at knot 0 and on a contact in swing."""
    L, N = K.shape[:2]
    n_c = logic.shape[1]
    ksk = matmul(matmul(K, Sigma[:, :N]), K.mT)
    sd = ksk.diagonal(dim1=-2, dim2=-1).clamp(min=0.0).sqrt()
    sd = sd.reshape(L, N, n_c, 1, 3)
    g = torch.einsum("rj,kcij->kcri", G, rotation)[None]    # (1, N, C, 4, 3)
    gate = (g > GATE) & (sd > GATE)
    b = xi * 2.0 * torch.where(gate, g * sd, torch.zeros_like(g)).sum(-1)
    b = b * logic[None, :, :, None]
    b[:, 0] = 0.0
    return b


class Problem(base.Problem):
    """`point3_scp.Problem` with each friction row's upper bound lowered
    by its chance back-off; `linearization` holds (f, A, B, b) of the last
    `solve_scp`, b (L, N, C, 4) the back-offs."""

    def __init__(self, cfg: dict, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        t = dict(dtype=self.dtype, device=self.device)
        self.cov_w = torch.diag(torch.tensor(cfg["cov_w_diag"], **t))
        self.cov_eta = cfg["dt"] * torch.diag(
            torch.tensor(cfg["cov_eta_diag"], **t))
        self.xi = quantile(cfg["beta_u"])
        self.fric_ub = None

    def chance(self, X0, U0, matmul=torch.matmul):
        """The back-offs (L, N, C, 4) of the linearization about (X0,
        U0)."""
        _, A, B = base.linearize(self.cfg, X0, U0, self.position,
                                 self.logic)
        K = base.lqr_gains(self.Q, self.R, A, B,
                           self.cfg["scp"].get("lqr_iters", 2), matmul)
        C = contact_jacobian(self.cfg, X0, U0, self.position, self.logic)
        Sigma = covariance(A, B, C, K, self.cov_w, self.cov_eta, matmul)
        return backoffs(K, Sigma, self.G, self.rotation, self.logic,
                        self.xi, matmul)

    def qp(self, *args, **kwargs):
        P, q, E, e, G, h = super().qp(*args, **kwargs)
        # the friction rows come first, knot by knot, each planted
        # contact's 4 rows (point3_scp.Problem.qp)
        rows = self.fric_ub[:, self.logic > 0].reshape(h.shape[0], -1)
        h[:, :rows.shape[1]] = h[:, :rows.shape[1]] + rows
        return P, q, E, e, G, h

    def solve_scp(self, X0, U0, X_track, x_init, x_final,
                  matmul=torch.matmul, ipm_iters: int = 60):
        b = self.chance(X0, U0, matmul)
        self.fric_ub = -b
        out = super().solve_scp(X0, U0, X_track, x_init, x_final, matmul,
                                ipm_iters)
        self.linearization = self.linearization + (b,)
        return out

    def primal_ratio(self, X, U, Xb, Ub, x_init, x_final, eps_abs: float,
                     eps_rel: float):
        """`point3_scp.Problem.primal_ratio` with each friction row's
        upper bound at -b: its violation is how far G u lies above -b,
        and its projection onto the bound is in OSQP's scale."""
        f, A, B, b = self.linearization
        L = X.shape[0]
        dyn = (torch.einsum("lkij,lkj->lki", A, X[:, :-1] - Xb[:, :-1])
               + torch.einsum("lkij,lkj->lki", B, U - Ub) + f - X[:, 1:])
        resid = (torch.einsum("lkij,lkj->lki", A, Xb[:, :-1])
                 + torch.einsum("lkij,lkj->lki", B, Ub) - f)
        g = torch.einsum("rj,kcij->kcri", self.G, self.rotation)
        fric = torch.einsum("kcri,lkci->lkcr", g,
                            U.reshape(L, self.N, self.C, 3))
        fric = fric * self.logic[None, :, :, None]
        ub = -b * self.logic[None, :, :, None]
        trust = X[..., 6:9] @ base.sign_patterns(X.dtype, X.device).T
        viol = [(X[:, 0] - x_init).abs().amax(1), dyn.abs().amax((1, 2)),
                (fric - ub).clamp(min=0.0).amax((1, 2, 3))]
        size = [X[:, 0].abs().amax(1), (dyn + resid).abs().amax((1, 2)),
                resid.abs().amax((1, 2)), fric.abs().amax((1, 2, 3)),
                torch.minimum(fric, ub).abs().amax((1, 2, 3)),
                trust.abs().amax((1, 2))]
        if self.terminal_equality:
            viol.append((X[:, -1] - x_final).abs().amax(1))
        size.append(X[:, -1].abs().amax(1))
        return (torch.stack(viol).amax(0)
                / (eps_abs + eps_rel * torch.stack(size).amax(0)))

