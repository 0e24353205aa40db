"""Plain reference of the centroidal SCP for point-foot robots.

Written from the equations, in plain PyTorch, for the benchmark's check
of the program's answers.  It imports nothing of the program and takes
nothing the program made: from a configuration file (`configs/*.json`)
and the benchmark's own inputs it works out the contact plan, the analytic
warm starts, the explicit-Euler centroidal dynamics and their Jacobians
(by automatic differentiation, not the program's closed form), the
truncated-DARE LQR gains, the trust-region QP of one SCP iteration and
its exact solution by a primal-dual interior-point method, and the SCP
loop's accept/reject rule with a frozen linearization.

Every function takes a leading lane axis L.  `matmul` is the product that
every matrix product goes through, so that a caller can run the whole
reference in a lower precision (the benchmark's control).

Model (the upstream project's src/centroidal_model.py, src/constraints.py,
src/cost.py): state x = (com, linear momentum, angular momentum), control
u = one 3-D force per contact;
    x+ = x + dt (p / m, sum_c l_c f_c + m g e_z, sum_c l_c (r_c - com) x f_c)
with l_c the contact logic.  QP of an SCP iteration about (Xb, Ub):
    min  sum_k 1/2 x_k' Wx x_k - (Wx xt_k)' x_k + sum_k 1/2 u_k' Wu u_k
         + sum_k t_k
    s.t. x_0 = x_init;  A_k x_k + B_k u_k - x_{k+1} = A_k xb_k + B_k ub_k
         - f(xb_k, ub_k);  x_N = x_final (when the terminal state is held;
         else the same rows with infinite bounds);
         (G R_c')_r . u_kc <= 0 for the 4 tangential rows r of the inner
         friction pyramid of each planted contact;
         s . h_k - t_k / omega <= radius + s . hb_k for the 8 sign
         patterns s (h: angular momentum);  t_k >= 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_X = 9
SWING = {"TROT": (("FR", "HL"), ("FL", "HR")),
         "BOUND": (("FR", "FL"), ("HR", "HL"))}


def _pace_swing(biped: bool):
    return ((("RF", "FR"), ("LF", "FL")) if biped
            else (("FR", "HR"), ("FL", "HL")))


def contact_plan(cfg: dict):
    """(logic (N, C), position (N, C, 3), rotation (N, C, 3, 3)) as float64
    numpy arrays: the gait's phases, each nb_steps cycle double support,
    step A, double support, step B (the last cycle closed by one more
    double support); a swung foot lands step_length further along x."""
    robot, gait = cfg["robot"], cfg["gait"]
    names = list(robot["foot_names"])
    n_c = len(names)
    if gait["gait_type"] == "PACE":
        step_a, step_b = _pace_swing(n_c == 2)
    else:
        step_a, step_b = SWING[gait["gait_type"]]
    phases = []
    for i in range(gait["nb_steps"]):
        phases += [(), step_a, (), step_b]
        if i == gait["nb_steps"] - 1:
            phases.append(())
    foot = np.array(robot["stance_foot_positions"], dtype=np.float64)
    logic, position = [], []
    for swing in phases:
        knots = gait["step_knots"] if swing else gait["support_knots"]
        planted = np.array([name not in swing for name in names])
        for _ in range(knots):
            logic.append(planted.astype(np.float64))
            position.append(foot * planted[:, None])
        for c, name in enumerate(names):
            if name in swing:
                foot[c, 0] += gait["step_length"]
    logic = np.array(logic)
    rotation = np.einsum("kc,ij->kcij", logic, np.eye(3))
    return logic, np.array(position), rotation


def warm_start(cfg: dict, logic, position):
    """(X (N+1, nx), U (N, nu)): the CoM over the planted feet's centroid
    at standing height with zero momenta (the last knot repeated), and
    each planted foot bearing an equal share of the weight with 1e-3
    tangential forces (the upstream src/centroidal_model.py:164-183)."""
    robot = cfg["robot"]
    n, n_c = logic.shape
    count = np.maximum(logic.sum(1), 1.0)
    centroid = (position * logic[..., None]).sum(1) / count[:, None]
    X = np.zeros((n + 1, N_X))
    X[:n, :2] = centroid[:, :2]
    X[:n, 2] = robot["com_height"] + centroid[:, 2]
    X[n] = X[n - 1]
    weight = -robot["mass"] * robot["gravity"]
    U = np.zeros((n, n_c, 3))
    U[..., 0] = U[..., 1] = 1e-3 * logic
    U[..., 2] = (weight / count)[:, None] * logic
    return X, U.reshape(n, n_c * 3)


def dynamics(cfg: dict, x, u, position, logic):
    """One explicit-Euler step at every leading index: x (..., nx), u
    (..., nu), position (..., C, 3), logic (..., C)."""
    robot = cfg["robot"]
    m, dt = robot["mass"], cfg["dt"]
    f = u.reshape(u.shape[:-1] + (-1, 3)) * logic[..., None]
    r = position - x[..., None, :3]
    lin = f.sum(-2) + torch.tensor([0.0, 0.0, m * robot["gravity"]],
                                   dtype=x.dtype, device=x.device)
    ang = torch.linalg.cross(r, f, dim=-1).sum(-2)
    return x + dt * torch.cat([x[..., 3:6] / m, lin, ang], -1)


def linearize(cfg: dict, X, U, position, logic):
    """(f (L, N, nx), A (L, N, nx, nx), B (L, N, nx, nu)) of the step at
    every knot of X (L, N+1, nx), U (L, N, nu), by forward-mode
    differentiation of `dynamics`."""
    def step(x, u, p, lg):
        return dynamics(cfg, x, u, p, lg)

    jac = torch.func.vmap(torch.func.jacfwd(step, argnums=(0, 1)),
                          in_dims=(0, 0, 0, 0))
    L, N = U.shape[:2]
    xs, us = X[:, :-1].reshape(L * N, -1), U.reshape(L * N, -1)
    pos = position.expand(L, *position.shape).reshape(L * N, -1, 3)
    lg = logic.expand(L, *logic.shape).reshape(L * N, -1)
    A, B = jac(xs, us, pos, lg)
    f = dynamics(cfg, xs, us, pos, lg)
    return (f.reshape(L, N, N_X), A.reshape(L, N, N_X, N_X),
            B.reshape(L, N, N_X, -1))


def lqr_gains(Q, R, A, B, n_iter: int, matmul=torch.matmul):
    """Truncated DARE: P <- Q; n_iter times P <- Q + A'PA - A'PB H^-1 B'PA
    with H = R + B'PB; then K = -H^-1 B'PA.  A (..., nx, nx), B (..., nx,
    nu) -> K (..., nu, nx)."""
    P = Q.expand(A.shape)
    for _ in range(n_iter):
        BtP = matmul(B.mT, P)
        H = R + matmul(BtP, B)
        BtPA = matmul(BtP, A)
        P = Q + matmul(matmul(A.mT, P), A) - matmul(
            BtPA.mT, torch.linalg.solve(H, BtPA))
    BtP = matmul(B.mT, P)
    return -torch.linalg.solve(R + matmul(BtP, B), matmul(BtP, A))


def pyramid(mu: float, dtype, device):
    """The 4 tangential rows of the inner linear friction pyramid
    (upstream src/utils.py:9-16; the unilateral row is left unfilled,
    src/constraints.py:180)."""
    a = mu / math.sqrt(2.0)
    return torch.tensor([[1.0, 0.0, -a], [-1.0, 0.0, -a], [0.0, 1.0, -a],
                         [0.0, -1.0, -a]], dtype=dtype, device=device)


def sign_patterns(dtype, device):
    """(8, 3) sign patterns of the L1 trust region."""
    s = [[(-1.0) ** (r // 2 ** j) for j in range(3)] for r in range(8)]
    return torch.tensor(s, dtype=dtype, device=device)


class Problem:
    """The reference's problem for a set of lanes that share one contact
    plan: everything but the per-lane boundary states, trajectories and
    trust-region state."""

    def __init__(self, cfg: dict, logic, position, rotation, dtype, device,
                 terminal_equality: bool = True):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.terminal_equality = terminal_equality

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)
        self.logic, self.position, self.rotation = (t(logic), t(position),
                                                    t(rotation))
        self.N, self.C = self.logic.shape
        self.nu = 3 * self.C
        self.Wx = torch.diag(t(cfg["state_cost_diag"]))
        self.Wu = torch.diag(t(cfg["control_cost_diag"]))
        self.Q = torch.diag(t(cfg["lqr_Q_diag"]))
        self.R = torch.diag(t(cfg["lqr_R_diag"]))
        self.G = pyramid(cfg["mu"], dtype, device)

    # -- the QP of one SCP iteration, dense -------------------------------
    def qp(self, X_track, x_init, x_final, Xb, Ub, f, A, B, radius, omega):
        """Dense (P, q, E, e, G, h) of every lane in z = (x_0..x_N,
        u_0..u_{N-1}, t_0..t_N); radius and omega (L,)."""
        L, N, C, nu = X_track.shape[0], self.N, self.C, self.nu
        dt, dev = self.dtype, self.device
        nxs, nus = N_X * (N + 1), nu * N
        n = nxs + nus + N + 1
        P = torch.zeros((L, n, n), dtype=dt, device=dev)
        q = torch.zeros((L, n), dtype=dt, device=dev)
        for k in range(N + 1):
            s = slice(k * N_X, (k + 1) * N_X)
            P[:, s, s] = self.Wx
            q[:, s] = -(X_track[:, k] @ self.Wx.T)
        for k in range(N):
            s = slice(nxs + k * nu, nxs + (k + 1) * nu)
            P[:, s, s] = self.Wu
        q[:, nxs + nus:] = 1.0

        n_eq = N_X * (N + 1 + (1 if self.terminal_equality else 0))
        E = torch.zeros((L, n_eq, n), dtype=dt, device=dev)
        e = torch.zeros((L, n_eq), dtype=dt, device=dev)
        eye = torch.eye(N_X, dtype=dt, device=dev)
        E[:, :N_X, :N_X] = eye
        e[:, :N_X] = x_init
        resid = (torch.einsum("lkij,lkj->lki", A, Xb[:, :-1])
                 + torch.einsum("lkij,lkj->lki", B, Ub) - f)
        for k in range(N):
            r = slice(N_X * (k + 1), N_X * (k + 2))
            E[:, r, k * N_X:(k + 1) * N_X] = A[:, k]
            E[:, r, nxs + k * nu:nxs + (k + 1) * nu] = B[:, k]
            E[:, r, (k + 1) * N_X:(k + 2) * N_X] = -eye
            e[:, r] = resid[:, k]
        if self.terminal_equality:
            E[:, -N_X:, N * N_X:(N + 1) * N_X] = eye
            e[:, -N_X:] = x_final

        rows = []
        h = []
        for k in range(N):
            for c in range(C):
                if self.logic[k, c] <= 0:
                    continue
                g = self.G @ self.rotation[k, c].T           # (4, 3)
                row = torch.zeros((4, n), dtype=dt, device=dev)
                col = nxs + k * nu + 3 * c
                row[:, col:col + 3] = g
                rows.append(row.expand(L, 4, n))
                h.append(torch.zeros((L, 4), dtype=dt, device=dev))
        sp = sign_patterns(dt, dev)
        for k in range(N + 1):
            row = torch.zeros((L, 8, n), dtype=dt, device=dev)
            row[:, :, k * N_X + 6:k * N_X + 9] = sp
            row[:, :, nxs + nus + k] = (-1.0 / omega)[:, None]
            rows.append(row)
            h.append(radius[:, None] + Xb[:, k, 6:9] @ sp.T)
        slack = torch.zeros((L, N + 1, n), dtype=dt, device=dev)
        slack[:, :, nxs + nus:] = -torch.eye(N + 1, dtype=dt, device=dev)
        rows.append(slack)
        h.append(torch.zeros((L, N + 1), dtype=dt, device=dev))
        return P, q, E, e, torch.cat(rows, 1), torch.cat(h, 1)

    def split(self, z):
        L, N, nu = z.shape[0], self.N, self.nu
        nxs = N_X * (N + 1)
        return (z[:, :nxs].reshape(L, N + 1, N_X),
                z[:, nxs:nxs + nu * N].reshape(L, N, nu))

    # -- the SCP loop with a frozen linearization --------------------------
    def solve_scp(self, X0, U0, X_track, x_init, x_final, matmul=torch.matmul,
                  ipm_iters: int = 60):
        """The SCP of every lane from (X0 (L, N+1, nx), U0 (L, N, nu)):
        linearized once at (X0, U0); per iteration the QP at the lane's
        radius and penalty weight, then the upstream accept/reject rule
        (src/scp_solver.py:118-179).  Returns (X, U, K, success,
        iterations)."""
        cfg, scp = self.cfg, self.cfg["scp"]
        if scp.get("update_linearization"):
            raise ValueError("the point3 reference linearizes once; "
                             "update_linearization needs another reference")
        L = X0.shape[0]
        f, A, B = linearize(cfg, X0, U0, self.position, self.logic)
        K = lqr_gains(self.Q, self.R, A, B, scp.get("lqr_iters", 2), matmul)

        def full(v):
            return torch.full((L,), float(v), dtype=self.dtype,
                              device=self.device)
        radius, omega = full(scp["trust_region_radius0"]), full(scp["omega0"])
        X_acc, U_acc = X0.clone(), U0.clone()
        success = torch.zeros(L, dtype=torch.bool, device=self.device)
        active = torch.ones(L, dtype=torch.bool, device=self.device)
        it = torch.zeros(L, dtype=torch.int64, device=self.device)
        while bool(active.any()):
            P, q, E, e, G, h = self.qp(X_track, x_init, x_final, X0, U0, f,
                                       A, B, radius, omega)
            z, _ = solve_qp(P, q, E, e, G, h, ipm_iters, matmul)
            ok = torch.isfinite(z).all(1)
            X, U = self.split(z)
            inside = torch.linalg.matrix_norm(X - X0, ord=2) < radius
            rho = self.model_accuracy(X, U, X0, U0, f, A, B)
            accurate = rho <= scp["rho1"]
            accept = inside & accurate & ok
            grow = accept & (rho < scp["rho0"])
            radius_new = torch.where(
                inside & ~accurate, radius * scp["beta_fail"],
                torch.where(grow, (scp["beta_succ"] * radius).clamp(
                    max=scp["trust_region_radius0"]), radius))
            omega_new = torch.where(inside, omega, omega * scp["gamma_fail"])
            take = active & accept
            X_acc = torch.where(take[:, None, None], X, X_acc)
            U_acc = torch.where(take[:, None, None], U, U_acc)
            success = torch.where(active, accept, success)
            radius = torch.where(active, radius_new, radius)
            omega = torch.where(active, omega_new, omega)
            it = it + active.long()
            # frozen linearization: the convergence metric is 0, so an
            # accepted iterate ends the lane's loop; a failed QP ends it too
            active = (active & ~accept & ok & (it < scp["max_iterations"])
                      & (omega < scp["omega_max"]))
        self.linearization = (f, A, B)
        return X_acc, U_acc, K, success, it

    def primal_ratio(self, X, U, Xb, Ub, x_init, x_final, eps_abs: float,
                     eps_rel: float):
        """Per lane, the QP's primal residual at (X, U) (the trust slacks
        at their optimum, 0) over OSQP's primal tolerance: max over the
        rows of the distance of A z to [l, u], over eps_abs + eps_rel
        max(|A z|, |proj A z|) over every row, the unbounded final-state
        rows of a free terminal state too, with the linearization of the
        last `solve_scp` (about Xb, Ub)."""
        f, A, B = self.linearization
        L = X.shape[0]
        dyn = (torch.einsum("lkij,lkj->lki", A, X[:, :-1] - Xb[:, :-1])
               + torch.einsum("lkij,lkj->lki", B, U - Ub) + f - X[:, 1:])
        resid = (torch.einsum("lkij,lkj->lki", A, Xb[:, :-1])
                 + torch.einsum("lkij,lkj->lki", B, Ub) - f)
        g = torch.einsum("rj,kcij->kcri", self.G, self.rotation)
        fric = torch.einsum("kcri,lkci->lkcr", g,
                            U.reshape(L, self.N, self.C, 3))
        fric = fric * self.logic[None, :, :, None]
        trust = X[..., 6:9] @ sign_patterns(X.dtype, X.device).T
        viol = [(X[:, 0] - x_init).abs().amax(1), dyn.abs().amax((1, 2)),
                fric.clamp(min=0.0).amax((1, 2, 3))]
        size = [X[:, 0].abs().amax(1), (dyn + resid).abs().amax((1, 2)),
                resid.abs().amax((1, 2)), fric.abs().amax((1, 2, 3)),
                trust.abs().amax((1, 2))]
        if self.terminal_equality:
            viol.append((X[:, -1] - x_final).abs().amax(1))
        # a free terminal state keeps its rows in the QP, unbounded (as the
        # system poses its MPC's QP): no violation, but their |A z| is in
        # OSQP's scale
        size.append(X[:, -1].abs().amax(1))
        return (torch.stack(viol).amax(0)
                / (eps_abs + eps_rel * torch.stack(size).amax(0)))

    def model_accuracy(self, X, U, Xb, Ub, f, A, B):
        """Sum of squares of the angular-momentum rows of the nonlinear
        step's departure from the linear prediction, over the sum of
        squares of the whole linear prediction (upstream
        src/scp_solver.py:71-87)."""
        f_nl = dynamics(self.cfg, X[:, :-1], U, self.position, self.logic)
        lin = (f + torch.einsum("lkij,lkj->lki", A, X[:, :-1] - Xb[:, :-1])
               + torch.einsum("lkij,lkj->lki", B, U - Ub))
        err = f_nl[..., 6:] - lin[..., 6:]
        return (err * err).sum((1, 2)) / (lin * lin).sum((1, 2))


def cholesky(M):
    """Cholesky factor of each matrix of M.  Where rounding leaves one
    not numerically positive definite (never seen in float64; a lower
    precision's products can), its diagonal is raised by a few hundred
    units of roundoff of its largest entry, then by 100x that, until it
    factors."""
    L, info = torch.linalg.cholesky_ex(M)
    if not bool((info > 0).any()):
        return L
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    shift = (M.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
             * 256 * torch.finfo(M.dtype).eps)[:, None, None]
    for _ in range(6):
        L, info = torch.linalg.cholesky_ex(M + shift * eye)
        if not bool((info > 0).any()):
            return L
        shift = shift * 100
    raise ValueError("cholesky: not positive definite after shifts")


def solve_qp(P, q, E, e, G, h, iters: int = 60, matmul=torch.matmul,
             tol: float = 1e-9):
    """min 1/2 z'Pz + q'z s.t. Ez = e, Gz <= h, for every lane, by
    Mehrotra's predictor-corrector interior-point method, each Newton
    system solved densely through its Schur complement.  Returns
    (z (L, n), converged (L,))."""
    L, n = q.shape
    me, mi = E.shape[1], G.shape[1]
    dt, dev = q.dtype, q.device

    def mv(M, v):
        return matmul(M, v[..., None])[..., 0]

    def mtv(M, v):
        return matmul(M.mT, v[..., None])[..., 0]

    def kkt(d):
        """Cholesky factors of H = P + G' diag(d) G and of the Schur
        complement E H^-1 E' (H is positive definite: the costs weigh
        every state and control, the slack rows every trust slack)."""
        H = P + matmul(G.mT * d[:, None, :], G)
        LH = cholesky(H)
        HiEt = torch.cholesky_solve(E.mT, LH)
        return LH, HiEt, cholesky(matmul(E, HiEt))

    def newton(fac, r1, r2):
        """(dz, dnu) of [H E'; E 0] (dz, dnu) = (r1, r2)."""
        LH, HiEt, LS = fac
        Hir1 = torch.cholesky_solve(r1[..., None], LH)[..., 0]
        dnu = torch.cholesky_solve((mv(E, Hir1) - r2)[..., None], LS)[..., 0]
        return Hir1 - mv(HiEt, dnu), dnu

    fac = kkt(torch.ones((L, mi), dtype=dt, device=dev))
    z, nu = newton(fac, -q + mtv(G, h), e)
    s = h - mv(G, z)
    lam = torch.ones_like(s)
    s = s + (1.0 - s.min(1, keepdim=True).values).clamp(min=0.0)
    scale = 1.0 + torch.maximum(q.abs().amax(1), h.abs().amax(1))
    done = torch.zeros(L, dtype=torch.bool, device=dev)

    def step_to_boundary(v, dv):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, math.inf))
        return ratio.amin(1).clamp(max=1.0)

    for _ in range(iters):
        rd = mv(P, z) + q + mtv(G, lam) + mtv(E, nu)
        rp = mv(G, z) + s - h
        re = mv(E, z) - e
        mu = (s * lam).sum(1) / mi
        res = torch.maximum(torch.maximum(rd.abs().amax(1), rp.abs().amax(1)),
                            re.abs().amax(1))
        done = done | ((res < tol * scale) & (mu < tol * scale))
        if bool(done.all()):
            break
        try:
            fac = kkt(lam / s)
        except ValueError:
            # a lower precision can run out of room to factor as the
            # barrier closes: its answer is the last iterate
            break

        def direction(rc):
            dz, dnu = newton(fac, -rd - mtv(G, (lam * rp - rc) / s), -re)
            ds = -rp - mv(G, dz)
            dlam = (-rc - lam * ds) / s
            return dz, dnu, ds, dlam

        dz, dnu, ds, dlam = direction(s * lam)
        a = torch.minimum(step_to_boundary(s, ds), step_to_boundary(lam, dlam))
        mu_aff = ((s + a[:, None] * ds)
                  * (lam + a[:, None] * dlam)).sum(1) / mi
        sigma = (mu_aff / mu).clamp(0.0, 1.0) ** 3
        dz, dnu, ds, dlam = direction(s * lam + ds * dlam
                                      - (sigma * mu)[:, None])
        a = 0.99 * torch.minimum(step_to_boundary(s, ds),
                                 step_to_boundary(lam, dlam))
        new = [v + a[:, None] * dv for v, dv in
               ((z, dz), (nu, dnu), (s, ds), (lam, dlam))]
        finite = torch.stack([torch.isfinite(v).all(1) for v in new]).all(0)
        done = done | ~finite
        keep = done[:, None]
        z, nu, s, lam = (torch.where(keep, v, n)
                         for v, n in zip((z, nu, s, lam), new))
    return z, done & (res < tol * scale) & (mu < tol * scale)
