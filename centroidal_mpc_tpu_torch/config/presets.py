"""Problem presets mirroring the reference config modules.

Port of `centroidal_mpc_tpu/config/presets.py`: the same `ProblemPreset`
table and a `build_problem` that expands a preset into tensors.  The
problem is built in numpy on the host and moved to `device` once, at the
end.  Stochastic problems and terrain are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.stats import norm as _scipy_norm

from centroidal_mpc_tpu_torch import _tree
from centroidal_mpc_tpu_torch.config import gaits
from centroidal_mpc_tpu_torch.config.robots import (BOLT, SOLO12, TALOS,
                                                    RobotSpec)
from centroidal_mpc_tpu_torch.contact.plan import (ContactPlan,
                                                   build_contact_plan)
from centroidal_mpc_tpu_torch.models.centroidal import CentroidalModel
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.solver.ocp import (OcpConfig,
                                                 friction_pyramid_matrix)
from centroidal_mpc_tpu_torch.solver.scp import ScpSettings
from centroidal_mpc_tpu_torch.solver.warm_start import (
    centroid_state_warm_start, weight_distribution_control_warm_start)


@dataclasses.dataclass(frozen=True)
class ProblemPreset:
    name: str
    robot: RobotSpec
    gait: gaits.GaitSpec
    dt: float
    dt_ctrl: float
    mu: float
    beta_u: float
    lqr_Q_diag: Tuple[float, ...]
    lqr_R_diag: Tuple[float, ...]
    cov_w_diag: Tuple[float, ...]
    cov_eta_diag: Tuple[float, ...]     # multiplied by dt at build time
    state_cost_diag: Tuple[float, ...]
    control_cost_diag: Tuple[float, ...]
    scp: ScpSettings = ScpSettings()

    @property
    def horizon(self) -> int:
        return self.gait.horizon(self.robot.n_contacts == 2)

    def chance_quantile(self) -> float:
        """xi = Phi^-1(1 - beta_u/5*3), the reference expression evaluated
        left-to-right (src/constraints.py:157)."""
        return float(_scipy_norm.ppf(1.0 - (self.beta_u / 5.0 * 3.0)))


@dataclasses.dataclass(frozen=True)
class Problem:
    """Built problem: everything `solve_scp` needs, on one device."""

    preset: ProblemPreset
    plan: ContactPlan
    model: CentroidalModel
    ocp: OcpConfig
    scp: ScpSettings
    X0: torch.Tensor
    U0: torch.Tensor


def build_problem(preset: ProblemPreset, stochastic: bool = False,
                  X_warm: Optional[torch.Tensor] = None,
                  U_warm: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32,
                  qp: Optional[QPSettings] = None,
                  terrain=None, device="cuda") -> Problem:
    """Expand a preset into a ready-to-solve Problem on `device`.

    X_warm (N+1, nx) is the tracking target and boundary states (default:
    the analytic centroid warm start); U_warm (N, nu) the control warm
    start (default: the weight-distribution heuristic).  The problem goes
    to the card unless the caller passes device="cpu"; without a card
    that default raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_problem: no CUDA device; pass device='cpu' "
                           "to build the problem on the CPU")
    if stochastic:
        raise NotImplementedError(
            "stochastic problems are not ported yet")
    plan = build_contact_plan(preset.robot, preset.gait, preset.dt,
                              dtype=dtype, device="cpu", terrain=terrain)
    model = CentroidalModel.from_spec(
        preset.robot, preset.dt,
        Q=np.diag(preset.lqr_Q_diag),
        R=np.diag(preset.lqr_R_diag),
        cov_w=np.diag(preset.cov_w_diag),
        cov_eta=preset.dt * np.diag(preset.cov_eta_diag),
        dtype=dtype, device="cpu")
    if X_warm is None:
        X_warm = centroid_state_warm_start(preset.robot, plan.schedule, dtype)
    if U_warm is None:
        U_warm = weight_distribution_control_warm_start(
            preset.robot, plan.schedule, dtype)
    X_warm, U_warm = X_warm.to("cpu", dtype), U_warm.to("cpu", dtype)
    fhd = preset.robot.foot_half_dims

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype)

    ocp = OcpConfig(
        x_init=X_warm[0],
        x_final=X_warm[-1],
        X_track=X_warm,
        Wx=t(np.diag(preset.state_cost_diag)),
        Wu=t(np.diag(preset.control_cost_diag)),
        pyramid=friction_pyramid_matrix(preset.mu, dtype, device="cpu"),
        xi=t(preset.chance_quantile()),
        cop_range=t([[fhd[0], fhd[1]], [fhd[2], fhd[3]]]),
        track_state=True,
        stochastic=stochastic,
    )
    scp = preset.scp if qp is None else dataclasses.replace(preset.scp, qp=qp)
    prob = Problem(preset=preset, plan=plan, model=model, ocp=ocp, scp=scp,
                   X0=X_warm, U0=U_warm)
    return _tree.to_device(prob, device)


# ---------------------------------------------------------------------------
# Presets (values transcribed from the reference config modules)
# ---------------------------------------------------------------------------

_SOLO12_LQR_Q = (1e4, 1e4, 1e4, 1e3, 1e3, 1e3, 1e3, 1e3, 1e3)

SOLO12_TROT = ProblemPreset(
    name="solo12_trot",                      # conf_solo12_trot.py
    robot=SOLO12, gait=gaits.SOLO12_TROT, dt=0.01, dt_ctrl=0.001,
    mu=0.5, beta_u=0.01,
    lqr_Q_diag=_SOLO12_LQR_Q,
    lqr_R_diag=(1e2, 1e3, 1e1) * 4,
    cov_w_diag=(0.4**2, 0.4**2, 0.1**2) * 4,
    cov_eta_diag=(0.85**2, 0.4**2, 0.01**2, 0.75**2, 0.4**2, 0.01**2,
                  0.85**2, 0.4**2, 0.01**2),
    state_cost_diag=(1e4, 1e4, 1e4, 1e3, 1e3, 1e3, 1e5, 1e5, 1e5),
    control_cost_diag=(1e0, 1e2, 1e1) * 4,
    scp=ScpSettings(trust_region_radius0=100.0, omega0=100.0,
                    omega_max=1e10, rho0=0.4, rho1=1.5, beta_succ=2.0,
                    beta_fail=0.5, gamma_fail=5.0,
                    convergence_threshold=1e-3, max_iterations=10),
)

SOLO12_PACE = ProblemPreset(
    name="solo12_pace",                      # conf_solo12_pace.py
    robot=SOLO12, gait=gaits.SOLO12_PACE, dt=0.01, dt_ctrl=0.001,
    mu=0.5, beta_u=0.01,
    lqr_Q_diag=_SOLO12_LQR_Q,
    lqr_R_diag=(1e2, 5e2, 1e1) * 4,
    cov_w_diag=(0.4**2, 0.4**2, 0.3**2) * 4,
    cov_eta_diag=(0.7**2, 0.5**2, 0.01**2, 0.8**2, 0.6**2, 0.01**2,
                  0.7**2, 0.5**2, 0.01**2),
    state_cost_diag=(1e4, 1e4, 1e4, 1e3, 1e3, 1e3, 1e5, 1e5, 1e5),
    control_cost_diag=(1e2, 1e2, 1e1) * 4,
    scp=ScpSettings(trust_region_radius0=50.0, omega0=100.0,
                    omega_max=1e10, rho0=0.4, rho1=1.5, beta_succ=2.0,
                    beta_fail=0.5, gamma_fail=5.0,
                    convergence_threshold=1e-3, max_iterations=20),
)

SOLO12_BOUND = ProblemPreset(
    name="solo12_bound",                     # conf_solo12_bound.py
    robot=SOLO12, gait=gaits.SOLO12_BOUND, dt=0.01, dt_ctrl=0.001,
    mu=0.5, beta_u=0.01,
    lqr_Q_diag=_SOLO12_LQR_Q,
    lqr_R_diag=(1e2, 5e2, 1e1) * 4,
    cov_w_diag=(0.4**2, 0.4**2, 0.01**2) * 4,
    cov_eta_diag=(0.75**2, 0.4**2, 0.01**2, 0.85**2, 0.4**2, 0.01**2,
                  0.75**2, 0.4**2, 0.01**2),
    state_cost_diag=(1e4, 1e4, 1e4, 1e3, 1e3, 1e3, 1e5, 1e5, 1e5),
    control_cost_diag=(1e2, 1e2, 1e1) * 4,
    scp=ScpSettings(trust_region_radius0=50.0, omega0=100.0,
                    omega_max=1e10, rho0=0.4, rho1=1.5, beta_succ=2.0,
                    beta_fail=0.5, gamma_fail=5.0,
                    convergence_threshold=1e-3, max_iterations=20),
)

BOLT_PACE = ProblemPreset(
    name="bolt_pace",                        # conf_bolt.py (completed)
    robot=BOLT, gait=gaits.BOLT_PACE, dt=0.01, dt_ctrl=0.001,
    mu=0.5, beta_u=0.01,
    lqr_Q_diag=_SOLO12_LQR_Q,
    lqr_R_diag=(1e2, 5e2, 1e1) * 2,
    cov_w_diag=(0.4**2, 0.4**2, 0.1**2) * 2,
    cov_eta_diag=(0.75**2, 0.4**2, 0.01**2, 0.85**2, 0.4**2, 0.01**2,
                  0.75**2, 0.4**2, 0.01**2),
    state_cost_diag=(1e4, 1e4, 1e4, 1e3, 1e3, 1e3, 1e5, 1e5, 1e5),
    control_cost_diag=(1e2, 1e2, 1e1) * 2,
    scp=ScpSettings(trust_region_radius0=50.0, omega0=100.0,
                    omega_max=1e10, rho0=0.4, rho1=1.5, beta_succ=2.0,
                    beta_fail=0.5, gamma_fail=5.0,
                    convergence_threshold=1e-3, max_iterations=20),
)

# Talos momentum weights are mass-normalized: its momenta run ~18x larger
# than solo12's (45 kg vs 2.5 kg), and reusing the solo12 weights puts the
# binding CoP-bound duals at ~1e5-1e6, which stalls the first-order QP
# solver (dual residual plateau; measured 2026-08).  Dividing the linear
# weights by m and the angular by m^2 keeps the cost gradients at solo12
# scale: the QP converges in ~4k iterations and the solution tracks the
# warm start to mm level.
_TALOS_M = TALOS.mass
TALOS_PACE = ProblemPreset(
    name="talos_pace",                       # conf_talos.py (completed)
    robot=TALOS, gait=gaits.TALOS_PACE, dt=0.03, dt_ctrl=0.001,
    mu=0.5, beta_u=0.01,
    lqr_Q_diag=_SOLO12_LQR_Q,
    lqr_R_diag=(1e3, 1e3, 1e1, 1e1, 1e0, 1e3) * 2,
    cov_w_diag=(0.1**2, 0.1**2, 0.05**2) * 2,
    cov_eta_diag=(0.5**2, 0.5**2, 0.01**2, 0.5**2, 0.5**2, 0.01**2,
                  0.5**2, 0.5**2, 0.01**2),
    state_cost_diag=(1e4, 1e4, 1e4) + (1e3 / _TALOS_M,) * 3
                    + (1e5 / _TALOS_M**2,) * 3,
    control_cost_diag=(1e1, 1e1, 1e0, 1e0, 1e-1, 1e1) * 2,
    # update_linearization: the wrench6 dynamics are bilinear in (cop, fz),
    # so the reference's frozen linearization leaves a ~0.2 nonlinear gap
    # when the CoP saturates; proper GuSTO re-linearization closes it in
    # ~3 SCP iterations (measured 2026-08)
    scp=ScpSettings(trust_region_radius0=100.0, omega0=100.0,
                    omega_max=1e10, rho0=0.4, rho1=1.5, beta_succ=2.0,
                    beta_fail=0.5, gamma_fail=5.0,
                    convergence_threshold=1e-3, max_iterations=10,
                    update_linearization=True),
)

# Benchmark preset: the BASELINE.md N=50 horizon.
SOLO12_TROT_N50 = dataclasses.replace(
    SOLO12_TROT, name="solo12_trot_n50", gait=gaits.SOLO12_TROT_N50)

# Reduced-scale demo/CI preset (N=18 step-in-place trot): the demo
# notebooks execute end-to-end under this in a slow-marked test
# (tests/test_notebook.py), standing in for the reference's
# notebook-as-integration-test role (SURVEY section 4) at CI cost.
SOLO12_TROT_MINI = dataclasses.replace(
    SOLO12_TROT, name="solo12_trot_mini", gait=gaits.SOLO12_TROT_MINI)

PRESETS = {p.name: p for p in
           [SOLO12_TROT, SOLO12_PACE, SOLO12_BOUND, BOLT_PACE, TALOS_PACE,
            SOLO12_TROT_N50, SOLO12_TROT_MINI]}
