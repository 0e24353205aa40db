"""Plain reference of the centroidal SCP for flat-foot (wrench6) robots.

Written from the equations, in plain PyTorch, for the benchmark's check
of the program's answers.  It imports nothing of the program and takes
nothing the program made.  What it shares with the point-foot reference
(`point3_scp.py`, loaded here by path, not changed) is the contact plan,
the truncated-DARE gains, the sign patterns of the L1 trust region and
the interior-point QP solve; the rest is worked out here from a
configuration file (`configs/*.json`) and the benchmark's own inputs:
the warm start, the wrench6 dynamics and their Jacobians (by automatic
differentiation, not the program's closed form), the QP of one SCP
iteration with its CoP box, and the SCP loop.

Model (the upstream project's src/centroidal_model.py:104-119, 189-212,
its TALOS branches): state x = (com, linear momentum p, angular momentum
h); control u = per contact c the wrench (cop_x, cop_y, fx, fy, fz,
tau_z) in the contact frame R_c;
    x+ = x + dt (p / m, sum_c l_c f_c + m g e_z,
                 sum_c l_c [(r_c - com) x f_c + (R_c[:, :2] cop_c) x f_c
                            + R_c e_z tau_z])
with l_c the contact logic, r_c the contact position, f_c = (fx, fy, fz)
(bilinear in (cop, f)).  QP of an SCP iteration about (Xb, Ub), the
lane's linearization point:
    min  sum_k 1/2 x_k' Wx x_k - (Wx xt_k)' x_k + sum_k 1/2 u_k' Wu u_k
         + sum_k t_k
    s.t. x_0 = x_init;  A_k x_k + B_k u_k - x_{k+1} = A_k xb_k + B_k ub_k
         - f(xb_k, ub_k);  x_N = x_final;
         (G R_c')_r . f_kc <= 0 for the 4 tangential rows r of the inner
         friction pyramid of each planted contact (on its force);
         -lxn <= cop_x <= lxp, -lyn <= cop_y <= lyp of each planted
         contact (src/constraints.py:111-145; foot_half_dims = (lxp, lxn,
         lyp, lyn));
         s . h_k - t_k / omega <= radius + s . hb_k for the 8 sign
         patterns s;  t_k >= 0.
A swung contact's wrench enters no row and is held at zero by its cost.

The SCP loop (src/scp_solver.py:118-179, GuSTO) with
`scp.update_linearization`: every iteration linearizes each lane at its
own point (X_lin, U_lin), runs the DARE there and solves the QP about it;
the answer is accepted when it lies inside the trust region about the
comparison trajectory X_cmp (the configuration's norm: 'power' is the
10-step power iteration from the normalized ones vector, 'svd' the exact
spectral norm) and the model-accuracy ratio is at most rho1.  An accepted
answer becomes the next X_lin and the old X_lin the next X_cmp (the
upstream's prev_traj_dict); the radius and the penalty weight move by
the upstream's rule.  A lane stops after max_iterations, when omega
passes omega_max, when its QP fails, or when its last iteration was
accepted with a convergence metric (the relative spectral-norm change of
U and of X between X_lin and X_cmp, exact) under the threshold.  The
answer is the last accepted iterate; its gains K are those of the DARE
of the same iteration, at that iteration's linearization point (the
iterate accepted before it, or the warm start), not at the answer: as
the program keeps them.  Without `update_linearization` the loop
linearizes once, at the warm start.

Departures from the upstream, each also the program's:
  - the linearization moves with the accepted iterates (the upstream
    freezes it at the warm start, and its convergence metric is then 0);
  - the robot (mass, CoM height, stance feet, foot half-dims) is the
    configuration's, in place of example_robot_data's talos;
  - the warm start is the upstream's weight share (src/centroidal_model.py:
    164-183) with the CoP and tau_z at zero and 1e-3 tangential forces;
  - the unilateral pyramid row is left unfilled, as the upstream leaves it
    (src/constraints.py:180).

`primal_ratio` measures a program answer in the QP whose exact solution
the reference kept for the lane: that of the last accepted iteration,
about its own linearization point (held in `linearization`, not the warm
start the caller passes).  It counts the CoP rows and the friction rows
of the wrench, where an error in a CoP shows: `u_gap` divides by the
largest |U|, a force in N.

Every function takes a leading lane axis L.  `matmul` is the product that
every matrix product of the loop goes through, so that a caller can run
the whole reference in a lower precision (the benchmark's control).
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "scpbench_ref_point3_scp_base",
    pathlib.Path(__file__).resolve().with_name("point3_scp.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

N_X = base.N_X
N_UC = 6            # (cop_x, cop_y, fx, fy, fz, tau_z) a contact
contact_plan = base.contact_plan
lqr_gains = base.lqr_gains


def warm_start(cfg: dict, logic, position):
    """(X (N+1, nx), U (N, 6C)): the CoM over the planted feet's centroid
    at standing height with zero momenta (the last knot repeated), and
    each planted foot bearing an equal share of the weight with 1e-3
    tangential forces, its CoP and yaw torque at zero."""
    X, _ = base.warm_start(cfg, logic, position)
    robot = cfg["robot"]
    n, n_c = logic.shape
    count = np.maximum(logic.sum(1), 1.0)
    weight = -robot["mass"] * robot["gravity"]
    U = np.zeros((n, n_c, N_UC))
    U[..., 2] = U[..., 3] = 1e-3 * logic
    U[..., 4] = (weight / count)[:, None] * logic
    return X, U.reshape(n, n_c * N_UC)


def dynamics(cfg: dict, x, u, position, logic, rotation):
    """One explicit-Euler step at every leading index: x (..., nx), u
    (..., 6C), position (..., C, 3), logic (..., C), rotation (..., C, 3,
    3)."""
    robot = cfg["robot"]
    m, dt = robot["mass"], cfg["dt"]
    uc = u.reshape(u.shape[:-1] + (-1, N_UC))
    lg = logic[..., None]
    f = uc[..., 2:5]
    cop = torch.einsum("...ij,...j->...i", rotation[..., :, :2], uc[..., :2])
    torque = rotation[..., :, 2] * uc[..., 5:6]
    r = position - x[..., None, :3]
    ang = lg * (torch.linalg.cross(r, f, dim=-1)
                + torch.linalg.cross(cop, f, dim=-1) + torque)
    lin = (lg * f).sum(-2) + torch.tensor(
        [0.0, 0.0, m * robot["gravity"]], dtype=x.dtype, device=x.device)
    return x + dt * torch.cat([x[..., 3:6] / m, lin, ang.sum(-2)], -1)


def linearize(cfg: dict, X, U, position, logic, rotation):
    """(f (L, N, nx), A (L, N, nx, nx), B (L, N, nx, 6C)) of the step at
    every knot of X (L, N+1, nx), U (L, N, 6C), by forward-mode
    differentiation of `dynamics`."""
    def step(x, u, p, lg, rot):
        return dynamics(cfg, x, u, p, lg, rot)

    jac = torch.func.vmap(torch.func.jacfwd(step, argnums=(0, 1)))
    L, N = U.shape[:2]

    def lanes(a):
        return a.expand(L, *a.shape).reshape((L * N,) + a.shape[1:])
    xs, us = X[:, :-1].reshape(L * N, -1), U.reshape(L * N, -1)
    pos, lg, rot = lanes(position), lanes(logic), lanes(rotation)
    A, B = jac(xs, us, pos, lg, rot)
    f = dynamics(cfg, xs, us, pos, lg, rot)
    return (f.reshape(L, N, N_X), A.reshape(L, N, N_X, N_X),
            B.reshape(L, N, N_X, -1))


def norm2(M, method: str = "svd"):
    """Largest singular value of each matrix of M (L, r, c): exact
    ('svd'), or the 10-step power iteration on M'M from the normalized
    ones vector ('power')."""
    if method == "svd":
        return torch.linalg.matrix_norm(M, ord=2)
    if method != "power":
        raise ValueError(f"unknown norm_method {method!r}")
    v = torch.ones(M.shape[:-2] + (M.shape[-1],), dtype=M.dtype,
                   device=M.device) / M.shape[-1] ** 0.5
    for _ in range(10):
        w = (M.mT @ (M @ v[..., None]))[..., 0]
        v = w / torch.linalg.vector_norm(w, dim=-1,
                                         keepdim=True).clamp(min=1e-30)
    return torch.linalg.vector_norm((M @ v[..., None])[..., 0], dim=-1)


def convergence(X, U, X_prev, U_prev):
    """The upstream's convergence metric (src/scp_solver.py:51-56): the
    relative spectral-norm change of U and of X, exact."""
    return (norm2(U - U_prev) / norm2(U) + norm2(X - X_prev) / norm2(X))


class Problem(base.Problem):
    """The reference's problem for a set of lanes that share one contact
    plan; `linearization` holds (f, A, B, Xb, Ub) of each lane's kept
    iteration after `solve_scp`."""

    def __init__(self, cfg: dict, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.nu = N_UC * self.C
        lxp, lxn, lyp, lyn = cfg["robot"]["foot_half_dims"]
        self.cop_ub = torch.tensor([lxp, lxn, lyp, lyn], dtype=self.dtype,
                                   device=self.device)
        self.planted = [(k, c) for k in range(self.N) for c in range(self.C)
                        if float(self.logic[k, c]) > 0]

    def dynamics(self, X, U):
        return dynamics(self.cfg, X[:, :-1], U, self.position, self.logic,
                        self.rotation)

    # -- the QP of one SCP iteration, dense -------------------------------
    def qp(self, X_track, x_init, x_final, Xb, Ub, f, A, B, radius, omega):
        """Dense (P, q, E, e, G, h) of every lane in z = (x_0..x_N,
        u_0..u_{N-1}, t_0..t_N); radius and omega (L,).  The cost, the
        equality rows and the trust rows are `point3_scp.Problem.qp`'s at
        6C controls a knot; its friction rows (first, knot by knot, each
        planted contact's 4) are moved onto the wrench's force, and the
        CoP rows of each planted contact (cop_x <= lxp, -cop_x <= lxn,
        cop_y <= lyp, -cop_y <= lyn) follow the rest."""
        P, q, E, e, G, h = super().qp(X_track, x_init, x_final, Xb, Ub, f,
                                      A, B, radius, omega)
        L, n = q.shape
        nxs = N_X * (self.N + 1)
        n_p = len(self.planted)
        G[:, :4 * n_p] = 0.0
        G_cop = torch.zeros((L, 4 * n_p, n), dtype=self.dtype,
                            device=self.device)
        box = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0],
                            [0.0, -1.0]], dtype=self.dtype,
                           device=self.device)
        for j, (k, c) in enumerate(self.planted):
            col = nxs + k * self.nu + N_UC * c
            G[:, 4 * j:4 * j + 4, col + 2:col + 5] = (
                self.G @ self.rotation[k, c].T)
            G_cop[:, 4 * j:4 * j + 4, col:col + 2] = box
        h_cop = self.cop_ub.repeat(n_p).expand(L, 4 * n_p)
        return P, q, E, e, torch.cat([G, G_cop], 1), torch.cat([h, h_cop], 1)

    # -- the SCP loop -------------------------------------------------------
    def solve_scp(self, X0, U0, X_track, x_init, x_final, matmul=torch.matmul,
                  ipm_iters: int = 60):
        """The SCP of every lane from (X0 (L, N+1, nx), U0 (L, N, 6C)).
        Returns (X, U, K, success, iterations)."""
        # every product but `matmul`'s in true float32 (no TF32) when the
        # reference runs in float32; float64 has no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, scp = self.cfg, self.cfg["scp"]
        relin = bool(scp.get("update_linearization", False))
        L = X0.shape[0]
        dt, dev = self.dtype, self.device

        def lin(X, U):
            f, A, B = linearize(cfg, X, U, self.position, self.logic,
                                self.rotation)
            K = lqr_gains(self.Q, self.R, A, B, scp.get("lqr_iters", 2),
                          matmul)
            return f, A, B, K

        def full(v, dtype=dt):
            return torch.full((L,), v, dtype=dtype, device=dev)

        def pick(mask, a, b):
            return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                               a, b)

        frozen = None if relin else lin(X0, U0)
        X_lin, U_lin, X_cmp, U_cmp = X0, U0, X0, U0
        X_acc, U_acc = X0.clone(), U0.clone()
        K_acc = torch.zeros((L, self.N, self.nu, N_X), dtype=dt, device=dev)
        kept = None
        radius = full(float(scp["trust_region_radius0"]))
        omega = full(float(scp["omega0"]))
        it = full(0, torch.int64)
        success = full(False, torch.bool)
        ok = full(True, torch.bool)
        conv = full(0.0)
        while True:
            not_converged = ~((it != 0) & success
                              & (conv < scp["convergence_threshold"]))
            active = ((it < scp["max_iterations"])
                      & (omega < scp["omega_max"]) & not_converged & ok)
            if not bool(active.any()):
                break
            f, A, B, K = lin(X_lin, U_lin) if relin else frozen
            P, q, E, e, G, h = self.qp(X_track, x_init, x_final, X_lin,
                                       U_lin, f, A, B, radius, omega)
            z, _ = base.solve_qp(P, q, E, e, G, h, ipm_iters, matmul)
            qp_ok = torch.isfinite(z).all(1)
            X, U = self.split(z)
            inside = norm2(X - X_cmp, scp.get("norm_method", "svd")) < radius
            rho = self.model_accuracy(X, U, X_lin, U_lin, f, A, B)
            accurate = rho <= scp["rho1"]
            accept = inside & accurate & qp_ok
            radius_new = torch.where(
                inside & ~accurate, radius * scp["beta_fail"],
                torch.where(accept & (rho < scp["rho0"]),
                            (scp["beta_succ"] * radius).clamp(
                                max=scp["trust_region_radius0"]), radius))
            omega_new = torch.where(inside, omega, omega * scp["gamma_fail"])
            take = active & accept
            this = (f, A, B, X_lin, U_lin)
            kept = this if kept is None else tuple(
                pick(take, a, b) for a, b in zip(this, kept))
            X_acc, U_acc, K_acc = [pick(take, a, b) for a, b in
                                   ((X, X_acc), (U, U_acc), (K, K_acc))]
            if relin:
                X_cmp, U_cmp, X_lin, U_lin = [pick(take, a, b) for a, b in (
                    (X_lin, X_cmp), (U_lin, U_cmp), (X, X_lin), (U, U_lin))]
                conv = torch.where(active, convergence(X_lin, U_lin, X_cmp,
                                                       U_cmp), conv)
            success = torch.where(active, accept, success)
            radius = torch.where(active, radius_new, radius)
            omega = torch.where(active, omega_new, omega)
            ok = ok & (qp_ok | ~active)
            it = it + active.long()
        self.linearization = kept
        return X_acc, U_acc, K_acc, success, it

    def primal_ratio(self, X, U, Xb, Ub, x_init, x_final, eps_abs: float,
                     eps_rel: float):
        """Per lane, the residual of (X, U) in the QP of the lane's kept
        iteration (the trust slacks at their optimum, 0) over OSQP's
        primal tolerance: max over the rows of the distance of A z to
        [l, u], over eps_abs + eps_rel max(|A z|, |proj A z|) over every
        row.  The linearization point is the kept iteration's (Xb, Ub
        passed in, the warm start, are not it)."""
        f, A, B, Xb, Ub = self.linearization
        L = X.shape[0]
        dyn = (torch.einsum("lkij,lkj->lki", A, X[:, :-1] - Xb[:, :-1])
               + torch.einsum("lkij,lkj->lki", B, U - Ub) + f - X[:, 1:])
        resid = (torch.einsum("lkij,lkj->lki", A, Xb[:, :-1])
                 + torch.einsum("lkij,lkj->lki", B, Ub) - f)
        uc = U.reshape(L, self.N, self.C, N_UC)
        planted = self.logic[None, :, :, None]
        g = torch.einsum("rj,kcij->kcri", self.G, self.rotation)
        fric = torch.einsum("kcri,lkci->lkcr", g, uc[..., 2:5]) * planted
        cop = torch.cat([uc[..., :1], -uc[..., :1], uc[..., 1:2],
                         -uc[..., 1:2]], -1) * planted
        cop_viol = (cop - self.cop_ub).clamp(min=0.0)
        trust = X[..., 6:9] @ base.sign_patterns(X.dtype, X.device).T
        viol = [(X[:, 0] - x_init).abs().amax(1), dyn.abs().amax((1, 2)),
                fric.clamp(min=0.0).amax((1, 2, 3)),
                cop_viol.amax((1, 2, 3))]
        size = [X[:, 0].abs().amax(1), (dyn + resid).abs().amax((1, 2)),
                resid.abs().amax((1, 2)), fric.abs().amax((1, 2, 3)),
                cop.abs().amax((1, 2, 3)), trust.abs().amax((1, 2))]
        if self.terminal_equality:
            viol.append((X[:, -1] - x_final).abs().amax(1))
        size.append(X[:, -1].abs().amax(1))
        return (torch.stack(viol).amax(0)
                / (eps_abs + eps_rel * torch.stack(size).amax(0)))

    def model_accuracy(self, X, U, Xb, Ub, f, A, B):
        """Sum of squares of the angular-momentum rows of the nonlinear
        step's departure from the linear prediction about (Xb, Ub), over
        the sum of squares of the whole linear prediction (upstream
        src/scp_solver.py:71-87)."""
        f_nl = self.dynamics(X, U)
        lin = (f + torch.einsum("lkij,lkj->lki", A, X[:, :-1] - Xb[:, :-1])
               + torch.einsum("lkij,lkj->lki", B, U - Ub))
        err = f_nl[..., 6:] - lin[..., 6:]
        return (err * err).sum((1, 2)) / (lin * lin).sum((1, 2))
