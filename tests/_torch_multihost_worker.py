"""One rank of a multi-process fleet solve of the PyTorch port.

    python tests/_torch_multihost_worker.py <coordinator host:port> \
        <world> <rank> <problem.pt> <out.npz> [--device cpu|cuda] \
        [--backend gloo|nccl] [--mode local|global] [--repeats N] \
        [--refusals]

<coordinator> "env" joins the group from a launcher's environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, as torchrun sets
them) instead.  problem.pt holds a dict of the port's containers on the
CPU (torch.save): `model`, `schedule`, `settings` (ScpSettings) and the
global batch `cfg`, `X0`, `U0`.  The rank joins the group through `multihost.initialize`,
moves model and schedule to its device, and hands the batch to
`multihost.fleet_solver`: with --mode local it passes only its own rows
through `shard_local_rows`, with --mode global every row through
`shard_global_batch`.  It prints one line `RESULT {json}` with the
reduced fleet statistics (equal on every rank when the collectives
really ran), the solution's global and local shapes, the launches of the
port's kernels in the solve, and with --repeats N > 0 the
`scaling_report`; its own lanes go to out.npz.  --refusals also checks
that the sharding helpers refuse a batch that does not divide the mesh,
ranks that bring unequal rows, and a mesh larger than the group.

This file imports no JAX: the parity tests (tests/test_torch_parallel.py)
and chip_smoke.py's `sharded` phase spawn it.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from centroidal_mpc_tpu_torch import _tree  # noqa: E402
from centroidal_mpc_tpu_torch.ops import block_tridiag as bt  # noqa: E402
from centroidal_mpc_tpu_torch.ops import lqr_kernel  # noqa: E402
from centroidal_mpc_tpu_torch.parallel import multihost  # noqa: E402
from centroidal_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    scenario_mesh)

LANE_FIELDS = ("X", "U", "success", "iterations", "qp_iterations")


def refusals(mesh, batch, rank, world):
    """Names of the refusals that raised ValueError as they must."""
    refused = []
    try:    # a global batch one row short of dividing the mesh
        multihost.shard_global_batch(
            mesh, _tree.map_tensors(lambda t: t[:-1], batch))
    except ValueError:
        refused.append("uneven_batch")
    try:    # rank r brings r + 1 rows: every rank sees the counts differ
        multihost.shard_local_rows(
            mesh, _tree.map_tensors(lambda t: t[:rank + 1], batch))
    except ValueError:
        refused.append("unequal_rows")
    try:
        scenario_mesh(world + 1, device=mesh.device_type)
    except ValueError:
        refused.append("mesh_too_large")
    return refused


def run(args):
    device = args.device
    problem = torch.load(args.problem, weights_only=False)
    model, schedule = _tree.to_device((problem["model"],
                                       problem["schedule"]), device)
    solver, mesh = multihost.fleet_solver(model, schedule,
                                          problem["settings"])
    batch = (problem["cfg"], problem["X0"], problem["U0"])
    n_batch = problem["X0"].shape[0]
    if args.mode == "local":
        rows = n_batch // args.world
        mine = _tree.map_tensors(
            lambda t: t[args.rank * rows:(args.rank + 1) * rows], batch)
        sharded = multihost.shard_local_rows(mesh, mine)
    else:
        sharded = multihost.shard_global_batch(mesh, batch)

    for counts in (bt.launches, lqr_kernel.launches):
        for k in counts:
            counts[k] = 0
    sol, stats = solver(*sharded)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {**bt.launches, **lqr_kernel.launches}
    result = dict(
        rank=args.rank, world=dist.get_world_size(),
        n_success=int(stats["n_success"]),
        qp_iterations=int(stats["qp_iterations"]),
        max_rho=float(stats["max_rho"]),
        global_shape=list(sol.X.shape),
        local_shape=list(sol.X.to_local().shape),
        device=str(sol.X.to_local().device), launches=launches)
    if args.repeats > 0:
        result["report"] = multihost.scaling_report(
            solver, sharded, n_batch, repeats=args.repeats)
    if args.refusals:
        result["refusals"] = refusals(mesh, batch, args.rank, args.world)
    np.savez(args.out, **{k: getattr(sol, k).to_local().cpu().numpy()
                          for k in LANE_FIELDS})
    print("RESULT " + json.dumps(result), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("problem")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--mode", default="local", choices=("local", "global"))
    ap.add_argument("--repeats", type=int, default=0)
    ap.add_argument("--refusals", action="store_true")
    args = ap.parse_args(argv)
    # one intra-op thread: several ranks share the host's cores
    torch.set_num_threads(1)
    if args.coordinator == "env":    # a launcher's environment
        multihost.initialize(device=args.device, backend=args.backend)
    else:
        multihost.initialize(args.coordinator, args.world, args.rank,
                             device=args.device, backend=args.backend)
    try:
        run(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
