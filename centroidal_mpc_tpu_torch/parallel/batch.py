"""Scenario-batch and mesh-sharded SCP solving.

Port of `centroidal_mpc_tpu/parallel/batch.py`.  The port's solver is
batch-first, so `batched_solve` is a direct call; the model and the
contact schedule are shared by every scenario.

Sharding follows PyTorch's own idiom: one process per device in a
`torch.distributed` process group, a one-axis `DeviceMesh` over its
ranks in place of JAX's `Mesh`, and `DTensor`s placed `Shard(0)` in
place of global arrays sharded over the scenario axis.
`make_sharded_solver` runs `batched_solve` on each rank's own rows and
reduces the fleet statistics with collectives over the mesh's group (the
counterpart of `psum`/`pmax` under `shard_map`).  There is no `jit` or
`shard_map` counterpart: the batch-first solver is already the local
program.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from centroidal_mpc_tpu_torch import _tree
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


def scenario_mesh(n_devices: Optional[int] = None, axis: str = "scenarios",
                  device: str = "cuda") -> DeviceMesh:
    """One-axis mesh over the first `n_devices` ranks of the default
    process group (all of them when None), one device a rank.  device:
    the device type the ranks run on, the card unless the caller asks for
    "cpu".  Every rank of the group calls it."""
    if not dist.is_initialized():
        raise ValueError("scenario_mesh: no process group is initialized; "
                         "call parallel.multihost.initialize() first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"scenario_mesh: {n} devices asked for, the process "
                         f"group has {world}")
    return DeviceMesh(torch.device(device).type, list(range(n)),
                      mesh_dim_names=(axis,))


def rows_per_rank(batch: int, mesh: DeviceMesh) -> int:
    """Scenarios a rank holds of a global batch; the batch must divide
    evenly over the mesh, as under JAX's shard_map."""
    n = mesh.size()
    if batch % n:
        raise ValueError(f"a global batch of {batch} scenarios does not "
                         f"divide over a mesh of {n} ranks")
    return batch // n


def make_sharded_solver(mesh: DeviceMesh, model: CentroidalModel,
                        schedule: ContactSchedule, settings: ScpSettings,
                        axis: str = "scenarios"):
    """Build a mesh-sharded batch solver.

    Returns solve(cfg_batch, X0, U0) -> (ScpSolution, stats).  The tensor
    leaves of the inputs are DTensors placed Shard(0) on `mesh` (as
    `multihost.shard_global_batch` and `shard_local_rows` give them);
    each rank solves its own rows with `batched_solve`.  The solution's
    tensors come back as Shard(0) DTensors, and `stats` holds the fleet's
    `n_success` and `qp_iterations` (summed) and `max_rho` (the largest),
    reduced over the mesh's group: the same values on every rank.
    """
    group = mesh.get_group(axis)

    def local(t):
        if not isinstance(t, DTensor) or tuple(t.placements) != (Shard(0),):
            raise ValueError("make_sharded_solver: inputs must be DTensors "
                             "placed Shard(0) on the mesh (use multihost."
                             "shard_global_batch or shard_local_rows)")
        rows_per_rank(t.shape[0], mesh)
        return t.to_local()

    def solve(cfg_batch: OcpConfig, X0, U0):
        cfg_l, X0_l, U0_l = _tree.map_tensors(local, (cfg_batch, X0, U0))
        sol = batched_solve(model, schedule, cfg_l, X0_l, U0_l, settings)
        stats = {"n_success": sol.success.sum(),
                 "qp_iterations": sol.qp_iterations.sum(),
                 "max_rho": sol.rho.max()}
        dist.all_reduce(stats["n_success"], dist.ReduceOp.SUM, group=group)
        dist.all_reduce(stats["qp_iterations"], dist.ReduceOp.SUM,
                        group=group)
        dist.all_reduce(stats["max_rho"], dist.ReduceOp.MAX, group=group)
        sharded = _tree.map_tensors(
            lambda t: DTensor.from_local(t, mesh, [Shard(0)],
                                         run_check=False), sol)
        return sharded, stats

    return solve
