"""Multi-process fleet solving over `torch.distributed`.

Port of `centroidal_mpc_tpu/parallel/multihost.py`.  One process drives
one device; the processes form a `torch.distributed` process group, the
scenario batch shards over its ranks (a one-axis `DeviceMesh`), each rank
solves its own rows, and the fleet statistics reduce with collectives
(`parallel/batch.make_sharded_solver`).

One process per card on one node, started by torchrun::

    torchrun --nproc-per-node 4 my_fleet.py

    # my_fleet.py
    from centroidal_mpc_tpu_torch.parallel import multihost
    multihost.initialize()          # reads torchrun's environment
    solver, mesh = multihost.fleet_solver(model, schedule, settings)
    sol, stats = solver(*multihost.shard_local_rows(mesh, (cfg, X0, U0)))

`initialize()` in a process that no launcher started makes a group of one
process, so the same code runs alone.  Inputs are the rank's own rows
(`shard_local_rows`) or the same global rows on every rank
(`shard_global_batch`); either way they become `Shard(0)` DTensors.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from centroidal_mpc_tpu_torch import _tree
from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import CentroidalModel
from centroidal_mpc_tpu_torch.parallel.batch import (make_sharded_solver,
                                                     rows_per_rank,
                                                     scenario_mesh)
from centroidal_mpc_tpu_torch.solver.scp import ScpSettings

AXIS = "scenarios"
# every collective of the group raises after this long instead of waiting
# for a lost peer (torch's default is 30 minutes)
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[str] = None,
               backend: Optional[str] = None) -> None:
    """Join (or make) the default process group; a no-op when it exists.

    With `coordinator_address` ("host:port") the group is
    `num_processes` processes and this one is `process_id`; without it,
    torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK, LOCAL_RANK)
    when it is set, else a group of this process alone.  device: "cuda"
    (the default; raises without a card) or "cpu"; on the card the
    process takes card LOCAL_RANK (or process_id) modulo the cards it
    sees.  backend: "nccl" on the card and "gloo" on the CPU by default;
    "gloo" on the card lets several ranks share one card, which NCCL
    refuses.
    """
    if dist.is_initialized():
        return
    device = torch.device(device or "cuda").type
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA device; pass device='cpu' to "
                           "run the group on the CPU")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    launched = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    if coordinator_address is not None:
        local_rank = process_id
    elif launched:
        local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    else:
        local_rank = 0
    if device == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if coordinator_address is not None:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=GROUP_TIMEOUT)
    elif launched:
        dist.init_process_group(backend, init_method="env://",
                                timeout=GROUP_TIMEOUT)
    else:   # single-process environment: run local
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=GROUP_TIMEOUT)


def global_mesh(axis: str = AXIS, device: str = "cuda") -> DeviceMesh:
    """One-axis mesh over every rank of the job."""
    return scenario_mesh(None, axis, device)


def fleet_solver(model: CentroidalModel, schedule: ContactSchedule,
                 settings: ScpSettings, axis: str = AXIS):
    """(solver, mesh): the sharded batch solver over the global mesh, on
    the device type the model lives on.  The batch axis of (cfg, X0, U0)
    shards across every rank; fleet statistics reduce over the group."""
    mesh = global_mesh(axis, model.mass.device.type)
    return make_sharded_solver(mesh, model, schedule, settings, axis), mesh


def _device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh's type (the current card)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _shard(mesh: DeviceMesh, local: torch.Tensor) -> DTensor:
    return DTensor.from_local(local.to(_device(mesh)), mesh, [Shard(0)],
                              run_check=False)


def shard_global_batch(mesh: DeviceMesh, tree, axis: str = AXIS):
    """Place a batch container that every rank holds whole as Shard(0)
    DTensors: each rank keeps its slice of the rows, on its device.  (On
    several hosts, prefer building only the local rows and
    `shard_local_rows`.)"""
    rank = mesh.get_local_rank(axis)

    def place(t):
        n = rows_per_rank(t.shape[0], mesh)
        return _shard(mesh, t[rank * n:(rank + 1) * n])

    return _tree.map_tensors(place, tree)


def shard_local_rows(mesh: DeviceMesh, tree, axis: str = AXIS):
    """Assemble Shard(0) DTensors from process-local batch rows.

    Each rank passes only its own rows (batch_local = batch_global /
    ranks); no rank ever holds another's.  One all_gather of the row
    counts first checks that every rank brought the same number."""
    rows = set()
    _tree.map_tensors(lambda t: rows.add(t.shape[0]), tree)
    if len(rows) != 1:
        raise ValueError(f"shard_local_rows: leaves of {sorted(rows)} rows; "
                         "every tensor leaf needs the same batch rows")
    mine = torch.tensor([rows.pop()], device=_device(mesh))
    counts = [torch.empty_like(mine) for _ in range(mesh.size())]
    dist.all_gather(counts, mine, group=mesh.get_group(axis))
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(f"shard_local_rows: the ranks hold {counts} rows; "
                         "every rank must bring the same number")
    return _tree.map_tensors(lambda t: _shard(mesh, t), tree)


def scaling_report(solve_fn, args, batch: int, repeats: int = 3) -> dict:
    """Solves/s of the current world (run at 1 and at N processes to
    compute a scaling efficiency): one warm-up call, then the best of
    `repeats` host-clock times, each ended by a device synchronize."""
    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    solve_fn(*args)
    sync()
    dist.barrier()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        solve_fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    best = min(times)
    world = dist.get_world_size()
    return {
        "devices": world,
        "processes": world,
        "batch": batch,
        "solves_per_s": batch / best,
        "solves_per_s_per_device": batch / best / world,
    }
