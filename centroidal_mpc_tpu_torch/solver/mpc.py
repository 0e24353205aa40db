"""Receding-horizon MPC over a long contact plan, batch-first.

Port of `centroidal_mpc_tpu/solver/mpc.py`.  A tick slices an N_window
problem out of the full contact plan at the current tick, warm-starts it
from the previous solution shifted by one knot, and re-solves it with
`solver/scp.solve_scp`.  The window's final-state equality targets the
tracking reference at the window end; the deployment setting relaxes it
(`OcpConfig.terminal_equality=False`) and runs 'cond' adaptive rho.

The state carries a leading scenario axis B (B=1 for a single robot).
The tick is one Python int shared by the batch, because `solve_scp`
shares one contact schedule across lanes.  The window's slices are
copies (as the JAX package's `lax.dynamic_slice` gives them), so no view
with a storage offset reaches a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import CentroidalModel
from centroidal_mpc_tpu_torch.solver.ocp import OcpConfig
from centroidal_mpc_tpu_torch.solver.scp import (ScpSettings, ScpSolution,
                                                 solve_scp)


@dataclasses.dataclass(frozen=True)
class MpcState:
    """Carry between MPC ticks: warm start in window coordinates."""

    X_warm: torch.Tensor   # (B, N_w+1, nx)
    U_warm: torch.Tensor   # (B, N_w, nu)
    tick: int              # window start knot in the full plan


@dataclasses.dataclass(frozen=True)
class MpcController:
    """Static problem data for receding-horizon solving.  cfg is the
    full-plan config tiled over the batch (`parallel.batch.
    tile_ocp_config`: X_track (B, N+1, nx))."""

    model: CentroidalModel
    schedule: ContactSchedule     # full-plan schedule
    cfg: OcpConfig                # full-plan config, leading B axis
    settings: ScpSettings
    window: int

    def init_state(self, X0_full: torch.Tensor,
                   U0_full: torch.Tensor) -> MpcState:
        """Warm start from the head of full-plan trajectories X0_full
        (B, N+1, nx), U0_full (B, N, nu)."""
        n_w = self.window
        return MpcState(X_warm=X0_full[:, :n_w + 1].clone(),
                        U_warm=U0_full[:, :n_w].clone(), tick=0)

    @property
    def max_tick(self) -> int:
        return self.schedule.horizon - self.window

    def _window_problem(self, tick: int):
        """The window's schedule (N_w knots) and tracking reference
        (B, N_w+1, nx) at `tick`, clamped so the window fits the plan
        (the clamp of `lax.dynamic_slice_in_dim`)."""
        n_w = self.window
        k = min(max(int(tick), 0), self.max_tick)
        sched = ContactSchedule(
            logic=self.schedule.logic[k:k + n_w].clone(),
            position=self.schedule.position[k:k + n_w].clone(),
            orientation=self.schedule.orientation[k:k + n_w].clone())
        x_track = self.cfg.X_track[:, k:k + n_w + 1].clone()
        return sched, x_track

    def step(self, state: MpcState,
             x_meas: torch.Tensor) -> Tuple[MpcState, ScpSolution]:
        """One MPC tick: re-solve the window from the measured states
        x_meas (B, nx)."""
        sched, x_track = self._window_problem(state.tick)
        cfg = dataclasses.replace(self.cfg, x_init=x_meas,
                                  x_final=x_track[:, -1], X_track=x_track)
        X0 = state.X_warm.clone()
        X0[:, 0] = x_meas
        sol = solve_scp(self.model, sched, cfg, X0, state.U_warm,
                        self.settings)
        # shift the solution one knot forward as the next warm start
        X_next = torch.cat([sol.X[:, 1:], sol.X[:, -1:]], dim=1)
        U_next = torch.cat([sol.U[:, 1:], sol.U[:, -1:]], dim=1)
        new_tick = min(state.tick + 1, self.max_tick)
        return MpcState(X_warm=X_next, U_warm=U_next, tick=new_tick), sol
