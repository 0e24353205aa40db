"""Readings of a cell's check numbers, for setting its limits.

    python3 scpbench/readings.py --workload <cell> --seeds 1,2,... \
        --seconds <s> [--control-seeds 7,8,9]
        [--fault eps10|eps1000|nodual|nobackoff|dare2] [--out <file>]

In one process (set-up once): for each seed a window of the program at
the cell's load, then the check's numbers of its answers, as a run
computes them; then, for each control seed, the control: the
configuration's reference computed in float32 with TF32 products
(`check.tf32_matmul`) put in the program's place, on the same sampled
inputs, compared with the float64 reference by the same numbers.  For an
MPC cell the control runs its own chain of ticks, each from its own last
plan, over `--control-ticks` ticks.  With `--fault`, the program's
windows run with a fault planted in its ADMM's stopping test (`FAULTS`)
or in its chance constraints (`CHANCE_FAULTS`), for the readings that a
number's upper end is set from.  One JSON line per reading.
"""
import importlib
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scpbench import check, harness  # noqa: E402
from scpbench.traffic import Scenarios  # noqa: E402


# faults of the ADMM's stopping test: (factor on the primal tolerance,
# factor on the dual tolerance).  eps10 and eps1000 stop early on both
# residuals; nodual drops the dual test and keeps the primal one, so its
# answers stay primal-feasible
FAULTS = {"eps10": (10.0, 10.0), "eps1000": (1000.0, 1000.0),
          "nodual": (1.0, float("inf"))}


def loosened(real, prim_factor: float, dual_factor: float):
    """The program's `ops.blockqp._residuals` with its tolerances
    loosened by the given factors."""
    def residuals(*args, **kwargs):
        prim, dual, eps_prim, eps_dual, ps, ds = real(*args, **kwargs)
        return (prim, dual, eps_prim * prim_factor, eps_dual * dual_factor,
                ps, ds)
    return residuals


def zero_backoffs(real):
    """The program's `_chance_backoffs` giving zeros: the chance
    constraints dropped, the deterministic QP's answer."""
    def backoffs(*args, **kwargs):
        return torch.zeros_like(real(*args, **kwargs))
    return backoffs


def two_step_gains(real):
    """The program's `models.centroidal.lqr_gain` at 2 DARE steps
    whatever the settings ask: the gains, and the covariance and the
    back-offs built from them, of the upstream's 2-step DARE."""
    def lqr_gain(model, A, B, n_iter: int = 2):
        return real(model, A, B, 2)
    return lqr_gain


# faults of the chance constraints: (module of the program, function,
# its replacement's maker)
CHANCE_FAULTS = {
    "nobackoff": ("centroidal_mpc_tpu_torch.ops.blockqp",
                  "_chance_backoffs", zero_backoffs),
    "dare2": ("centroidal_mpc_tpu_torch.models.centroidal", "lqr_gain",
              two_step_gains)}


def chance_fault(fault: str):
    """(module, name, replacement) that plants a fault of CHANCE_FAULTS."""
    name, attr, make = CHANCE_FAULTS[fault]
    mod = importlib.import_module(name)
    return mod, attr, make(getattr(mod, attr))


def plant(fault: str):
    """Plants a fault of FAULTS or CHANCE_FAULTS in the program (for this
    process)."""
    if fault in CHANCE_FAULTS:
        setattr(*chance_fault(fault))
        return
    from centroidal_mpc_tpu_torch.ops import blockqp
    blockqp._residuals = loosened(blockqp._residuals, *FAULTS[fault])


def control_batch(cell, seed: int, device):
    """The control's numbers: sampled scenarios of the seed's first
    batches, answered by the reference in float32 with TF32 products."""
    wl = cell.workload
    gen = Scenarios(seed, wl["perturb_std"])
    B, n = wl["batch"], wl["sample"]
    dxs = np.concatenate([gen.draw(B, zero_first=True)
                          for _ in range(max(1, -(-n * 4 // B)))])
    picked = check.sample(len(dxs), 0, 0, seed, n)
    low = check.Reference(cell.config, wl, device, torch.float32,
                          check.tf32_matmul, cell.root)
    ref = check.Reference(cell.config, wl, device, torch.float64,
                          torch.matmul, cell.root)
    answers = low.batch_lanes(dxs[picked])
    exact = ref.batch_lanes(dxs[picked])
    per = [check.gaps(a, r) for a, r in zip(answers, exact)]
    return check.summary(per), per


def control_mpc(cell, seed: int, ticks: int, device):
    """The control's numbers: the reference in float32 with TF32 products
    runs the cell's chain of ticks in the program's place."""
    wl = cell.workload
    w, per_episode = wl["window"], wl["episode_ticks"]
    gen = Scenarios(seed, wl["perturb_std"])
    low = check.Reference(cell.config, wl, device, torch.float32,
                          check.tf32_matmul, cell.root)
    episodes, done = [], 0
    while done < ticks:
        dx = gen.draw(1, zero_first=False)[0]
        X_full, U_full = low.mpc_start(dx)
        Xw = X_full[:w + 1].cpu().numpy()
        Uw = U_full[:w].cpu().numpy()
        x = Xw[0]
        answers = []
        for i in range(min(per_episode, ticks - done)):
            a = low.mpc_tick(w, X_full, i, Xw, Uw, x)
            a["qp"] = 0
            answers.append(a)
            Xw, Uw, x = check.shift(a["X"]), check.shift(a["U"]), a["X"][1]
        episodes.append((dx, answers))
        done += len(answers)
    ref = check.Reference(cell.config, wl, device, torch.float64,
                          torch.matmul, cell.root)
    per = check.check_mpc(ref, w, episodes, seed, wl["sample"])
    return check.summary(per), per


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-ticks", type=int, default=62)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", choices=sorted({*FAULTS, *CHANCE_FAULTS}),
                    default=None)
    args = ap.parse_args()
    cell = harness.Cell.find(args.workload)
    dev = args.device
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({"workload": cell.name, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    if dev == "cuda":
        emit({"kind": torch.cuda.get_device_name(0)})
    seeds = [int(s) for s in args.seeds.split(",") if s]
    side = "program" if args.fault is None else "fault:" + args.fault
    if seeds:
        if args.fault is not None:
            plant(args.fault)
        prob = harness.build_program(cell, dev)
        loop = harness.LOOPS[cell.mode](cell, prob, dev)
        loop.warm_up(cell.workload["warmup"])
        tracer = harness.tracing.Tracer(False, 0, False)
        for seed in seeds:
            items, _, window_s = loop.window(
                Scenarios(seed, cell.workload["perturb_std"]), args.seconds,
                tracer)
            t0 = time.perf_counter()
            numbers, per = harness.compare(cell, items, seed, dev)
            if cell.mode == "batch":
                succ = np.concatenate([np.asarray(a["success"])
                                       for _, a in items])
            else:
                succ = np.array([bool(t["success"]) for _, ts in items
                                 for t in ts])
            emit({"side": side, "seed": seed, "window_s": window_s,
                  "answers": int(succ.size),
                  "failed": int((~succ.astype(bool)).sum()),
                  "check_s": time.perf_counter() - t0, **numbers,
                  "per": per})
        del loop, prob
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        try:
            if cell.mode == "batch":
                numbers, per = control_batch(cell, seed, dev)
            else:
                numbers, per = control_mpc(cell, seed, args.control_ticks,
                                           dev)
        except (RuntimeError, ValueError) as e:   # a control that crashes
            emit({"side": "control", "seed": seed, "error": repr(e)})
            continue
        emit({"side": "control", "seed": seed,
              "seconds": time.perf_counter() - t0, **numbers, "per": per})
    if harness.forbidden_modules():
        raise SystemExit(f"forbidden modules: {harness.forbidden_modules()}")


if __name__ == "__main__":
    main()
