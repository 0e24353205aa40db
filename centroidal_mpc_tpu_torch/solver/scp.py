"""GuSTO-style SCP loop, batch-first.

Port of `centroidal_mpc_tpu/solver/scp.py` (reference solve_scp,
src/scp_solver.py:118-179).  Per iteration: assemble the QP, solve it,
then the trust-region accept/reject with the model-accuracy ratio rho:
the radius shrinks by beta_fail on inaccuracy, grows by beta_succ (capped
at the initial radius) on high accuracy, and the L1 penalty weight grows
by gamma_fail when the solution leaves the trust region.  Stop on
max_iterations, omega > omega_max, convergence, or a failed QP.

The port solves a batch of B scenarios at once (every input but the
model and the schedule has a leading B axis).  Like the vmapped JAX
program, every iteration runs on all lanes and lanes whose loop condition
is false keep their state; the loop ends when no lane is active.

Both QP backends run in both of the JAX package's modes: 'dense' (the
preset default; `solver/ocp.build_qp` and `ops/admm.solve_qp` in the
reference layout, warm-started from zeros and then from each lane's last
(x, y)) and 'block' (`ops/blockqp`, warm-started from the linearization
trajectory).  With the reference's frozen linearization
(`update_linearization=False`) the linearization and the LQR gains are
computed once, outside the loop (and the block backend's QP blocks too;
the dense QP is rebuilt each iteration from each lane's radius and
weight, as the JAX package does).  With `update_linearization=True` (the
proper GuSTO loop, which talos needs) every iteration linearizes, runs
the DARE and builds the QP at each lane's current linearization
trajectory X_lin, which moves to an accepted solution; the comparison
trajectory X_cmp (the reference's prev_traj_dict) takes the old X_lin.

`counts` counts the loop's passes, its linearizations (each one DARE)
and its blocking host reads; the loop's spans (`utils.profiling.span`)
are `scp.solve`, `scp.linearize`, `qp.build`, `scp.accept` and
`sync.scp`, around the QP solvers' own.
"""
from __future__ import annotations

import dataclasses

import torch

from centroidal_mpc_tpu_torch import _tree
from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import (CentroidalModel,
                                                        compute_trajectory_data,
                                                        model_accuracy)
from centroidal_mpc_tpu_torch.ops import blockqp
from centroidal_mpc_tpu_torch.ops.admm import QPSettings, solve_qp
from centroidal_mpc_tpu_torch.solver.ocp import (N_X, OcpConfig, build_qp,
                                                 qp_dims)
from centroidal_mpc_tpu_torch.utils.profiling import span

# The SCP loop's counters (read through `utils.profiling.counters`):
# passes of the loop (each solves one QP on every lane of the batch), the
# linearizations of the batch (each with its DARE: one a solve when it is
# frozen, one a pass when it moves) and the loop test's blocking host
# reads (one a pass and one at the end).
counts = {"scp.iterations": 0, "scp.linearizations": 0, "sync.scp": 0}


@dataclasses.dataclass(frozen=True)
class ScpSettings:
    """SCP parameters (reference conf_solo12_trot.py:93-94); the same
    fields and defaults as the JAX package's ScpSettings."""

    trust_region_radius0: float = 100.0
    omega0: float = 100.0
    omega_max: float = 1e10
    rho0: float = 0.4
    rho1: float = 1.5
    beta_succ: float = 2.0
    beta_fail: float = 0.5
    gamma_fail: float = 5.0
    convergence_threshold: float = 1e-3
    max_iterations: int = 10
    update_linearization: bool = False  # reference-compat default
    # 'dense' = ops.admm on the assembled matrices (reference-layout
    # path); 'block' = ops.blockqp structure-exploiting solver
    qp_backend: str = "dense"
    # spectral norm for the trust-region test: 'svd' (exact, the
    # reference's np.linalg.norm(A, 2)) or 'power' (10-step power iteration)
    norm_method: str = "svd"
    # DARE fixed-point iterations for the LQR gains (reference uses 2)
    lqr_iters: int = 2
    qp: QPSettings = QPSettings()


@dataclasses.dataclass(frozen=True)
class ScpSolution:
    """Result of a batch of SCP solves (the last accepted iterates)."""

    X: torch.Tensor             # (B, N+1, nx)
    U: torch.Tensor             # (B, N, nu)
    K: torch.Tensor             # (B, N, nu, nx) LQR gains of the accepted iterate
    Sigma: torch.Tensor         # (B, N+1, nx, nx)
    success: torch.Tensor       # (B,) bool: last iteration accepted
    accepted: torch.Tensor      # (B,) int32: number of accepted iterates
    iterations: torch.Tensor    # (B,) int32: SCP iterations executed
    qp_iterations: torch.Tensor  # (B,) int32: cumulative ADMM iterations
    qp_converged: torch.Tensor  # (B,) bool: all QP subproblems converged
    qp_status: torch.Tensor     # (B,) int32 STATUS_* of the last QP
    radius: torch.Tensor        # (B,)
    weight: torch.Tensor        # (B,)
    rho: torch.Tensor           # (B,) model-accuracy ratio of the last iteration
    # the port's additions (the JAX ScpSolution has neither):
    conv: torch.Tensor          # (B,) convergence metric of the last iteration
    qp_refactors: torch.Tensor  # (B,) int32: adaptive-rho refactorizations


def set_fp32_exact() -> None:
    """Float32 products in true fp32 (no TF32): reduced-precision products
    make the block ADMM diverge."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _matrix_norm2(M: torch.Tensor, method: str = "svd") -> torch.Tensor:
    """Largest singular value of each matrix of M (B, r, c): (B,)."""
    if method == "power":
        c = M.shape[-1]
        v = torch.ones(M.shape[:-2] + (c,), dtype=M.dtype,
                       device=M.device) / (c ** 0.5)
        for _ in range(10):
            w = (M.mT @ (M @ v[..., None]))[..., 0]
            v = w / torch.linalg.vector_norm(w, dim=-1,
                                             keepdim=True).clamp(min=1e-30)
        return torch.linalg.vector_norm((M @ v[..., None])[..., 0], dim=-1)
    if method == "svd":
        return torch.linalg.svdvals(M)[..., 0]
    raise ValueError(f"unknown norm_method {method!r}")


def _convergence_metric(X_curr, U_curr, X_prev, U_prev) -> torch.Tensor:
    """Reference `convergence` (src/scp_solver.py:51-56): relative spectral
    norm change of the control and state matrices, per lane.  The exact
    SVD norm whatever `norm_method` says, as the JAX package has it."""
    return (_matrix_norm2(U_curr - U_prev) / _matrix_norm2(U_curr)
            + _matrix_norm2(X_curr - X_prev) / _matrix_norm2(X_curr))


def solve_scp(model: CentroidalModel, schedule: ContactSchedule,
              cfg: OcpConfig, X0: torch.Tensor, U0: torch.Tensor,
              settings: ScpSettings = ScpSettings()) -> ScpSolution:
    """Solve B SCP problems from initial trajectories X0 (B, N+1, nx),
    U0 (B, N, nu); cfg carries the leading B axis (`parallel.batch.
    tile_ocp_config`)."""
    with span("scp.solve"):
        return _solve_scp(model, schedule, cfg, X0, U0, settings)


def _solve_scp(model: CentroidalModel, schedule: ContactSchedule,
               cfg: OcpConfig, X0: torch.Tensor, U0: torch.Tensor,
               settings: ScpSettings) -> ScpSolution:
    if settings.qp_backend not in ("dense", "block"):
        raise ValueError(f"unknown qp_backend {settings.qp_backend!r}")
    dense = settings.qp_backend == "dense"
    blockqp.check_settings(settings.qp)
    # before any product: the covariance is a chain of N products
    set_fp32_exact()
    nb, N = U0.shape[0], U0.shape[1]
    dtype, dev = X0.dtype, X0.device
    relin = settings.update_linearization
    n_xu = N_X * (N + 1) + model.n_u * N

    def trajectory_data(X, U):
        with span("scp.linearize"):
            counts["scp.linearizations"] += 1
            return compute_trajectory_data(model, schedule, X, U,
                                           lqr_iters=settings.lqr_iters,
                                           with_covariance=cfg.stochastic)

    def linearize(X, U, radius, weight):
        data = trajectory_data(X, U)
        build = build_qp if dense else blockqp.build_block_qp
        with span("qp.build"):
            return data, build(model, schedule, cfg, X, U, data, radius,
                               weight)

    if not relin:
        # frozen linearization: computed once, outside the loop (the
        # reference linearizes the initial trajectory every iteration)
        if dense:
            data = trajectory_data(X0, U0)
        else:
            data, qp_const = linearize(X0, U0,
                                       settings.trust_region_radius0,
                                       settings.omega0)

    def full(v, dt=dtype):
        return torch.full((nb,), v, dtype=dt, device=dev)

    c = dict(
        X_lin=X0, U_lin=U0, X_cmp=X0, U_cmp=U0,
        X_acc=X0, U_acc=U0,
        K_acc=torch.zeros((nb, N, model.n_u, N_X), dtype=dtype, device=dev),
        Sigma_acc=torch.zeros((nb, N + 1, N_X, N_X), dtype=dtype, device=dev),
        radius=full(settings.trust_region_radius0),
        weight=full(settings.omega0),
        it=full(0, torch.int32), success=full(False, torch.bool),
        accepted=full(0, torch.int32), qp_iters=full(0, torch.int32),
        qp_refactors=full(0, torch.int32),
        qp_ok=full(True, torch.bool), qp_status=full(0, torch.int32),
        rho=full(0.0), conv=full(0.0),
    )
    if dense:
        # the flat reference layout, from zeros
        n, segs = qp_dims(model, N)
        c["warm_x"] = torch.zeros((nb, n), dtype=dtype, device=dev)
        c["warm_y"] = torch.zeros((nb, sum(segs.values())), dtype=dtype,
                                  device=dev)
    else:
        # primal warm start from the linearization trajectory, duals
        # threaded across SCP iterations (OSQP warm_start=True)
        c["warm_x"] = blockqp.WVars(x=X0, u=U0,
                                    t=torch.zeros((nb, N + 1), dtype=dtype,
                                                  device=dev))
        c["warm_y"] = blockqp.zero_zgroups(nb, N, schedule.n_contacts,
                                           dtype, dev)

    while True:
        # reference while condition (src/scp_solver.py:133-134) plus the
        # QP-failure break (:146-148)
        not_converged = ~((c["it"] != 0) & c["success"]
                          & (c["conv"] < settings.convergence_threshold))
        active = ((c["it"] < settings.max_iterations)
                  & (c["weight"] < settings.omega_max)
                  & not_converged & c["qp_ok"])
        counts["sync.scp"] += 1
        with span("sync.scp"):
            go_on = bool(active.any())   # one host sync per SCP iteration
        if not go_on:
            break
        counts["scp.iterations"] += 1
        radius, weight = c["radius"], c["weight"]
        X_lin, U_lin = c["X_lin"], c["U_lin"]
        if relin:
            data, qp = linearize(X_lin, U_lin, radius, weight)
        else:
            with span("qp.build"):
                if dense:
                    qp = build_qp(model, schedule, cfg, X_lin, U_lin, data,
                                  radius, weight)
                else:
                    qp = dataclasses.replace(
                        qp_const, inv_omega=1.0 / weight,
                        trust_ub=(radius[:, None, None]
                                  + X0[..., 6:9] @ qp_const.penum.T))
        if dense:
            sol = solve_qp(qp, settings.qp, x0=c["warm_x"], y0=c["warm_y"])
            X_sol = sol.x[:, :N_X * (N + 1)].reshape(nb, N + 1, N_X)
            U_sol = sol.x[:, N_X * (N + 1):n_xu].reshape(nb, N, model.n_u)
            warm_x, warm_y = sol.x, sol.y
        else:
            sol = blockqp.solve_block_qp(qp, settings.qp, w0=c["warm_x"],
                                         y0=c["warm_y"])
            X_sol, U_sol = sol.X, sol.U
            warm_x, warm_y = blockqp.WVars(x=X_sol, u=U_sol, t=sol.t), sol.y

        with span("scp.accept"):
            inside = (_matrix_norm2(X_sol - c["X_cmp"], settings.norm_method)
                      < radius)
            rho = model_accuracy(model, schedule, X_sol, U_sol, X_lin, U_lin,
                                 data)
            accurate = rho <= settings.rho1
            # a non-converged QP is never accepted; the loop also aborts
            accept = inside & accurate & sol.converged
            radius_new = torch.where(
                inside & ~accurate, radius * settings.beta_fail,
                torch.where(accept & (rho < settings.rho0),
                            (settings.beta_succ * radius).clamp(
                                max=settings.trust_region_radius0),
                            radius))
            weight_new = torch.where(inside, weight,
                                     weight * settings.gamma_fail)
            X_acc, U_acc, K_acc, Sigma_acc = _tree.select(
                accept, (X_sol, U_sol, data.K, data.Sigma),
                (c["X_acc"], c["U_acc"], c["K_acc"], c["Sigma_acc"]))
            if relin:
                # lane by lane: an accepted solution becomes the next
                # linearization point, the old one the comparison trajectory
                X_lin_new, U_lin_new, X_cmp, U_cmp = _tree.select(
                    accept, (X_sol, U_sol, X_lin, U_lin),
                    (X_lin, U_lin, c["X_cmp"], c["U_cmp"]))
                conv = _convergence_metric(X_lin_new, U_lin_new, X_cmp, U_cmp)
            else:
                X_lin_new, U_lin_new = X_lin, U_lin
                X_cmp, U_cmp = c["X_cmp"], c["U_cmp"]
                conv = torch.zeros_like(rho)  # reference: always 0
            new = dict(
                X_lin=X_lin_new, U_lin=U_lin_new, X_cmp=X_cmp, U_cmp=U_cmp,
                X_acc=X_acc, U_acc=U_acc, K_acc=K_acc, Sigma_acc=Sigma_acc,
                radius=radius_new, weight=weight_new, it=c["it"] + 1,
                success=accept,
                accepted=c["accepted"] + accept.to(torch.int32),
                qp_iters=c["qp_iters"] + sol.iterations,
                qp_refactors=c["qp_refactors"] + sol.refactors,
                qp_ok=c["qp_ok"] & sol.converged, qp_status=sol.status,
                rho=rho, conv=conv, warm_x=warm_x, warm_y=warm_y)
            # lanes whose loop condition is false keep their state
            c = {k: _tree.select(active, new[k], c[k]) for k in c}

    return ScpSolution(
        X=c["X_acc"], U=c["U_acc"], K=c["K_acc"], Sigma=c["Sigma_acc"],
        success=c["success"], accepted=c["accepted"], iterations=c["it"],
        qp_iterations=c["qp_iters"], qp_converged=c["qp_ok"],
        qp_status=c["qp_status"], radius=c["radius"], weight=c["weight"],
        rho=c["rho"], conv=c["conv"], qp_refactors=c["qp_refactors"])
