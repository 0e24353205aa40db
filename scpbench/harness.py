"""The benchmark's core: finds a cell's files by name, sets the program
up, drives its window, reads the trace and prints the result line.

A cell (`workloads/<name>.json`) names its configuration
(`configs/<config>.json`), its traffic shape (`mode`: "batch" or "mpc")
and the shape's parameters; a per-layer metric is a reader in
`metrics/<metric>.py`; a configuration names its plain reference in
`references/`.  Nothing here is particular to one of them.

The two traffic shapes, each a closed loop of one client:
  batch  B scenarios a call of `parallel.batch.batched_solve`; the next
         batch is submitted once the last one's answers (X, U, K, the
         lanes' success and QP iterations) are on the host.
  mpc    one robot re-planning with `solver.mpc.MpcController.step`, its
         measured state the last plan's second knot; a tick ends when its
         first control is on the host; an episode, perturbed, runs
         `episode_ticks` ticks, then the next perturbed episode starts.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

from scpbench import arith, check, tracing
from scpbench.traffic import Scenarios

HERE = pathlib.Path(__file__).resolve().parent
# whole top-level module names the port must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "centroidal_mpc_tpu")


def forbidden_modules():
    """Top-level names in sys.modules that are in FORBIDDEN, compared
    whole (centroidal_mpc_tpu_torch is not centroidal_mpc_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(kind: str, name: str, root: pathlib.Path = HERE) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_metric(name: str, root: pathlib.Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "scpbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    root: pathlib.Path

    @classmethod
    def find(cls, name: str, root: pathlib.Path = HERE) -> "Cell":
        wl = load_json("workloads", name, root)
        return cls(name, wl, load_json("configs", wl["config"], root), root)

    @property
    def mode(self) -> str:
        return self.workload["mode"]


def benchmark_entries(cell: Cell):
    """(end-to-end names, per-layer names) that BENCHMARK.json, beside the
    cell's folder, gives this cell: a metric without a `workloads` list
    belongs to every cell."""
    path = cell.root.parent / "BENCHMARK.json"
    if not path.exists():
        return None, None
    bench = json.loads(path.read_text())

    def mine(m):
        return "workloads" not in m or cell.name in m["workloads"]
    return ([m["name"] for m in bench["end_to_end"] if mine(m)],
            [m["name"] for m in bench["per_layer"] if mine(m)])


# ---------------------------------------------------------------------------
# the program's side
# ---------------------------------------------------------------------------

def build_program(cell: Cell, device):
    """The program's problem, from the configuration file and the cell's
    overrides, through the program's own `presets.build_problem`; a
    configuration that states `"stochastic": true` builds the
    chance-constrained problem."""
    from centroidal_mpc_tpu_torch.config import gaits, presets, robots
    from centroidal_mpc_tpu_torch.ops.admm import QPSettings
    from centroidal_mpc_tpu_torch.solver.scp import ScpSettings
    cfg, over = cell.config, cell.workload.get("overrides", {})
    r = cfg["robot"]
    robot = robots.RobotSpec(
        name=r["name"], contact_model=r["contact_model"],
        foot_names=tuple(r["foot_names"]), mass=r["mass"],
        com_height=r["com_height"], max_leg_length=r["max_leg_length"],
        stance_foot_positions=tuple(map(tuple, r["stance_foot_positions"])),
        foot_half_dims=tuple(r["foot_half_dims"]), gravity=r["gravity"])
    qp = QPSettings(**{**cfg["qp"], **over.get("qp", {})})
    scp = ScpSettings(**{**cfg["scp"], **over.get("scp", {})}, qp=qp)
    preset = presets.ProblemPreset(
        name=cfg["name"], robot=robot, gait=gaits.GaitSpec(**cfg["gait"]),
        dt=cfg["dt"], dt_ctrl=cfg["dt_ctrl"], mu=cfg["mu"],
        beta_u=cfg["beta_u"],
        **{k: tuple(cfg[k]) for k in (
            "lqr_Q_diag", "lqr_R_diag", "cov_w_diag", "cov_eta_diag",
            "state_cost_diag", "control_cost_diag")},
        scp=scp)
    dtype = getattr(torch, cfg["dtype"])
    return presets.build_problem(preset, dtype=dtype, device=device,
                                 stochastic=bool(cfg.get("stochastic", False)))


def launch_counts():
    from centroidal_mpc_tpu_torch.ops import block_tridiag, lqr_kernel
    return {**block_tridiag.launches, **lqr_kernel.launches}


class BatchLoop:
    """Closed loop of B-scenario batches."""

    def __init__(self, cell: Cell, prob, device):
        from centroidal_mpc_tpu_torch.parallel.batch import (
            batched_solve, tile_ocp_config)
        self.B = cell.workload["batch"]
        self.prob, self.device = prob, device
        self._solve, self._tile = batched_solve, tile_ocp_config

    def unit(self, dx):
        p = self.prob
        d = torch.as_tensor(dx, dtype=p.X0.dtype, device=self.device)
        X0 = p.X0[None] + d[:, None, :]
        U0 = p.U0.expand((self.B,) + p.U0.shape)
        cfg = self._tile(p.ocp, X0[:, 0], X0[:, -1], X0)
        sol = self._solve(p.model, p.plan.schedule, cfg, X0, U0, p.scp)
        return dict(X=sol.X.cpu(), U=sol.U.cpu(), K=sol.K.cpu(),
                    success=sol.success.cpu(), qp=sol.qp_iterations.cpu())

    def warm_up(self, n: int):
        for _ in range(n):
            self.unit(np.zeros((self.B, 9)))

    def window(self, gen: Scenarios, seconds: float, tracer):
        units, spans = [], []
        t0 = time.perf_counter()
        while True:
            dx = gen.draw(self.B, zero_first=True)
            with tracer.span("scpbench.batch"):
                s = time.perf_counter()
                units.append((dx, self.unit(dx)))
                spans.append((s, time.perf_counter()))
            if spans[-1][1] - t0 >= seconds:
                break
        return units, spans, spans[-1][1] - t0


class MpcLoop:
    """Closed loop of MPC ticks, episodes of `episode_ticks`."""

    def __init__(self, cell: Cell, prob, device):
        from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
        from centroidal_mpc_tpu_torch.solver.mpc import MpcController
        wl = cell.workload
        self.prob, self.device = prob, device
        self.window_knots, self.ticks = wl["window"], wl["episode_ticks"]
        self.terminal = wl.get("overrides", {}).get("terminal_equality",
                                                    True)
        self._tile, self._ctrl = tile_ocp_config, MpcController

    def controller(self, dx):
        p = self.prob
        d = torch.as_tensor(dx, dtype=p.X0.dtype, device=self.device)
        X0 = p.X0[None] + d[None, None, :]
        U0 = p.U0[None]
        cfg = dataclasses.replace(
            self._tile(p.ocp, X0[:, 0], X0[:, -1], X0),
            terminal_equality=self.terminal)
        ctrl = self._ctrl(model=p.model, schedule=p.plan.schedule, cfg=cfg,
                          settings=p.scp, window=self.window_knots)
        return ctrl, ctrl.init_state(X0, U0), X0[:, 0]

    def warm_up(self, n: int):
        ctrl, state, x = self.controller(np.zeros(9))
        for _ in range(n):
            state, sol = ctrl.step(state, x)
            sol.U[:, 0].cpu()
            x = sol.X[:, 1]

    def window(self, gen: Scenarios, seconds: float, tracer):
        episodes, spans = [], []
        t0 = time.perf_counter()
        n = 0
        while True:
            dx = gen.draw(1, zero_first=False)[0]
            ctrl, state, x = self.controller(dx)
            ticks = []
            episodes.append((dx, ticks))
            for _ in range(self.ticks):
                with tracer.span("scpbench.tick"):
                    s = time.perf_counter()
                    state, sol = ctrl.step(state, x)
                    sol.U[:, 0].cpu()
                    spans.append((s, time.perf_counter()))
                ticks.append(dict(X=sol.X[0], U=sol.U[0], K=sol.K[0],
                                  success=sol.success[0],
                                  qp=sol.qp_iterations[0]))
                x = sol.X[:, 1]
                n += 1
                if spans[-1][1] - t0 >= seconds:
                    break
            if spans[-1][1] - t0 >= seconds:
                break
        for _, ticks in episodes:
            for t in ticks:
                for k in t:
                    t[k] = t[k].cpu().numpy()
        return episodes, spans, spans[-1][1] - t0


LOOPS = {"batch": BatchLoop, "mpc": MpcLoop}


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print):
    """Set up, warm up, measure, check.  Returns the result dict (the
    contract's keys, `checks` last)."""
    wl = cell.workload
    cuda = torch.device(device).type == "cuda"
    build_s = 0.0
    if cuda:
        from centroidal_mpc_tpu_torch.ops import cuda_lib
        _, build_s = cuda_lib.build()
        cuda_lib.library()
    prob = build_program(cell, device)
    loop = LOOPS[cell.mode](cell, prob, device)
    loop.warm_up(wl["warmup"])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = tracing.Tracer(trace, wl["trace_units"], cuda)
    setup_s = time.perf_counter() - t_start
    log(f"# set-up {setup_s:.3f} s (kernel library build {build_s:.3f} s)")

    counts0 = launch_counts()
    gen = Scenarios(seed, wl["perturb_std"])
    tracer.start(launch_counts)
    items, spans, window_s = loop.window(gen, seconds, tracer)
    tracer.stop()
    counts = {k: v - counts0[k] for k, v in launch_counts().items()}
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError(f"forbidden modules loaded: {leaked}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # answers, success and QP iterations of the whole window
    if cell.mode == "batch":
        succ = np.concatenate([np.asarray(a["success"]) for _, a in items])
        qp = np.concatenate([np.asarray(a["qp"]) for _, a in items])
        units = len(items)
    else:
        ticks = [t for _, ts in items for t in ts]
        succ = np.array([bool(t["success"]) for t in ticks])
        qp = np.array([float(t["qp"]) for t in ticks])
        units = len(ticks)
    attempted, failed = int(succ.size), int((~succ.astype(bool)).sum())
    tick_ms = [(b - a) * 1e3 for a, b in spans]

    metrics = {}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        if cell.mode == "batch":
            metrics["solves_per_s"] = {
                "value": arith.rate(attempted - failed, window_s),
                "unit": "solves/s"}
        else:
            metrics["tick_ms_p50"] = {
                "value": arith.percentile(tick_ms, 50), "unit": "ms"}
            metrics["tick_ms_p90"] = {
                "value": arith.percentile(tick_ms, 90), "unit": "ms"}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": wl["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        rec = tracer.record(cell, prob, units_total=units, qp=qp)
        _, names = benchmark_entries(cell)
        for name in names if names is not None else []:
            reader = load_metric(name, cell.root)
            value = reader.read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        if rec.get("device_ops"):
            device_info["busy_s"] = rec["busy_s"]
            device_info["window_s"] = rec["window_s"]
        breakdown = rec.get("breakdown")
    q = np.percentile(tick_ms, [10, 50, 90]) if tick_ms else [0, 0, 0]
    half = len(tick_ms) // 2
    log(f"# {cell.mode} ms p10 {q[0]:.2f} p50 {q[1]:.2f} p90 {q[2]:.2f}; "
        f"mean of the first half {np.mean(tick_ms[:half] or [0]):.2f}, "
        f"of the second {np.mean(tick_ms[half:] or [0]):.2f}")
    log(f"# window {window_s:.3f} s, {units} {cell.mode} units, "
        f"{attempted} answers, {failed} failed, mean QP iterations "
        f"{float(qp.mean()):.2f}, launches {counts}")

    # the check, after the window, with the program's state freed
    del loop, prob
    if cuda:
        torch.cuda.empty_cache()
    numbers, _ = compare(cell, items, seed, device)
    correct, rows, data = check.verdict(numbers, wl.get("limits", {}))
    log(f"# not compared (data): {data}")
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = rows
    return out


def compare(cell: Cell, items, seed: int, device):
    """The check's numbers for a window's answers (`items` as the loop
    returns them), against the reference in float64."""
    ref = check.Reference(cell.config, cell.workload, device,
                          root=cell.root)
    n = cell.workload["sample"]
    if cell.mode == "batch":
        per = check.check_batch(ref, items, seed, n)
    else:
        per = check.check_mpc(ref, cell.workload["window"], items, seed, n)
    return check.summary(per), per


def device_ok(chips: int, log) -> bool:
    if not torch.cuda.is_available():
        log("error: torch.cuda.is_available() is false")
        return False
    if torch.cuda.device_count() < chips:
        log(f"error: {torch.cuda.device_count()} CUDA devices, the cell "
            f"asks for {chips}")
        return False
    return True


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="scpbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = Cell.find(args.workload)
    if not device_ok(cell.workload["chips"], log):
        return 2
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start, log)
    leaked = forbidden_modules()
    if leaked:
        log(f"error: forbidden modules loaded: {', '.join(leaked)}")
        return 3
    for name, row in out["checks"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    log(f"correct {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
