"""Device time by kernel in one batch of a benchmark cell, on the card.

    python3 scripts/profile_cell.py --workload <batch cell> [--seed N]
                                    [--top K]

Builds the cell's program as `scpbench/run.py` does, warms it up as the
cell says, then runs one batch of the cell's perturbed inputs under
torch.profiler (device activity only) and prints, for the K kernels with
the most device time, their ms in the batch, their launches and ms a
launch; then the busy share of the batch's CUDA-event time and the
growth of the port's launch counters and ADMM counters in that batch.
"""
import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scpbench.harness import BatchLoop, Cell, build_program  # noqa: E402
from scpbench.traffic import Scenarios  # noqa: E402
from centroidal_mpc_tpu_torch.utils.profiling import counters  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cell.py needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from centroidal_mpc_tpu_torch.solver.scp import set_fp32_exact
    set_fp32_exact()
    device = torch.device("cuda")
    cell = Cell.find(args.workload)
    loop = BatchLoop(cell, build_program(cell, device), device)
    loop.warm_up(cell.workload["warmup"])
    dx = Scenarios(args.seed, cell.workload["perturb_std"]).draw(
        loop.B, zero_first=True)
    torch.cuda.synchronize()
    before = counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        loop.unit(dx)
        end.record()
        torch.cuda.synchronize()
    grown = {k: v - before[k] for k, v in counters().items()
             if v != before[k]}
    per_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = per_name.get(ev.name, (0.0, 0))
            per_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    wall = start.elapsed_time(end)
    busy = sum(us for us, _ in per_name.values()) / 1e3
    print(f"# {args.workload} seed {args.seed}: "
          f"{torch.cuda.get_device_name(0)}; one batch {wall:.2f} ms under the profiler, device busy "
          f"{busy:.2f} ms ({busy / wall:.1%}), "
          f"{sum(n for _, n in per_name.values())} device ops")
    for name, (us, n) in sorted(per_name.items(),
                                key=lambda kv: -kv[1][0])[:args.top]:
        print(f"#   {us / 1e3:9.3f} ms {n:7d}x {us / 1e3 / n:.4f} ms each  "
              f"{name[:100]}")
    print(f"# counters grown: {grown}")


if __name__ == "__main__":
    main()
