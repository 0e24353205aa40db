"""Scenario-batch SCP solving.

Port of `tile_ocp_config` and `batched_solve` from
`centroidal_mpc_tpu/parallel/batch.py`.  The port's solver is
batch-first, so `batched_solve` is a direct call; the model and the
contact schedule are shared by every scenario.  Mesh sharding and
multi-host solving are not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import CentroidalModel
from centroidal_mpc_tpu_torch.solver.ocp import OcpConfig
from centroidal_mpc_tpu_torch.solver.scp import (ScpSettings, ScpSolution,
                                                 solve_scp)


def tile_ocp_config(cfg: OcpConfig, x_inits: torch.Tensor,
                    x_finals: torch.Tensor,
                    X_tracks: torch.Tensor) -> OcpConfig:
    """Broadcast an OcpConfig over a batch of boundary conditions."""
    batch = x_inits.shape[0]

    def tile(a):
        return a.expand((batch,) + a.shape)
    return dataclasses.replace(
        cfg, x_init=x_inits, x_final=x_finals, X_track=X_tracks,
        Wx=tile(cfg.Wx), Wu=tile(cfg.Wu), pyramid=tile(cfg.pyramid),
        xi=tile(cfg.xi), cop_range=tile(cfg.cop_range))


def batched_solve(model: CentroidalModel, schedule: ContactSchedule,
                  cfg_batch: OcpConfig, X0: torch.Tensor, U0: torch.Tensor,
                  settings: ScpSettings) -> ScpSolution:
    """Solve the SCP over the leading scenario axis of (cfg_batch, X0,
    U0); model and schedule are shared."""
    return solve_scp(model, schedule, cfg_batch, X0, U0, settings)
