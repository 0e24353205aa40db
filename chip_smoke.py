"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [phase ...] [--deadline SECONDS]

With no phase named every phase runs (as the chip check runs it); named
phases run after the build, the kernel checks and the main path, which
always run.  When the deadline (1,080 s by default) passes, the script
prints `# DEADLINE` with the phase it was in and the phases it did not
reach, and exits 4 with no result line.

Phases (the first four raise on failure, so the script exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit;
     fails when no CUDA device is present (there is no CPU fallback);
  2. build: compiles the hand-written kernels (centroidal_mpc_tpu_torch/
     csrc/*.cu) with nvcc for sm_90a;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the small bench shape, the main path's shapes, a horizon that
     wraps the sweeps' ring (N=165), a batch of more than one wave
     (B=300) and the other paths' shapes (bolt_pace's V=16, solo12_pace's
     N=107, N=165 at B=32); the factor's two launches (chain, couplings)
     also each alone; the DARE gains on the real linearizations of
     solo12_trot_n50 (nu 12) and bolt_pace (nu 6) over 128 scenarios at 2
     steps (the main path's) and 30 (the stochastic stage's), of
     talos_pace (wrench6) over 32 at 2 and of solo12_trot over 8 at 30;
     CUDA-event times of kernel and plain version, warm and with L2
     flushed, beside the bound computed from the bytes and operations of
     the launch;
  4. the main path: 128 solo12_trot_n50 SCP problems in float32 through
     parallel.batch.batched_solve (block backend, frozen linearization,
     power-iteration trust norm, fixed-rho block ADMM with its refinement
     polish), checked for success on every lane, for launches of every
     kernel, and against the committed float64 reference solution; then
     one more batch under torch.profiler: device time per kernel name and
     the device's busy share;
  5. the other paths, each through batched_solve with the launch counts
     zeroed just before it and read just after (every kernel must have
     launched), at its preset's full widths and horizon:
       stochastic        the bench's chance-constrained row, B=64;
       stochastic_stage  the pipeline's stage 2' (N=165, 30 DARE steps), B=8;
       presets/*         the bench's preset matrix (solo12 pace and bound,
                         bolt pace, talos pace re-linearizing), B=32 each;
       cond              'cond' adaptive rho, B=32;
       terrain           solo12_trot on the trot debris, B=8;
       mpc               30 receding-horizon ticks of solver/mpc.py on
                         solo12_trot_n50 (window 20, B=1, the bench's tick
                         settings), then one at the clamp: per tick its
                         status, QP iterations and launches, host time
                         p50/p99, one profiled tick's busy share, tick 0
                         against an f64 CPU solve of the same window;
       dense/solo12_trot_n50
                         the preset's own settings (dense reference-layout
                         backend, 'cond' rho, eps 1e-7, SVD trust norm) in
                         f64, B=8, against the f64 cache and the CPU;
       dense/solo12_trot the README's quick-start problem (N=165) in f64,
                         B=1, against the JAX package's f64 dense solve,
                         and its first QP certified on the host;
       assoc             the main path's point with the log-depth 'assoc'
                         sweep, B=32: the factor kernel, no sweep kernel;
       thomas/f64, /f32  the block-Thomas factor ('always' rho, eps
                         1e-5), B=8, f64 against 'cholesky', f32 as data;
       exact_backoffs    solver/stochastic's jacobians through the DARE
                         kernel's autograd.Function, card against CPU;
       server            cli.mpc_server_main: 3 published solves and the
                         1 kHz control loop over the native runtime;
       pipeline/f64      pipeline.run_pipeline on solo12_trot_n50 in
                         f64 with the whole-body DDP stage 3 (nq 18, nv
                         18), 64 sims, held to the JAX package's run of
                         the same call (tests/data/jax_pipeline_solo12_
                         trot_n50.npz) at equal iteration counts, with
                         each stage's host time and one DDP iteration's
                         device launches and busy share;
       pipeline/f32      the user default: f32, kinematic stage 3, 1024
                         sims; both SCP stages solved, every artifact
                         written, the warm start a rollout of itself;
       whole_body_ddp/bolt  the 1-step bolt pace's whole-body DDP (V=12,
                         a biped's KKT) with its JAX test's gates;
       physics/solo12_trot_n50
                         sim/physics.simulate_episode, 4 episodes x 500
                         steps in f64, held step by step to the JAX
                         package's plant on the same references and pushes
                         (tests/data/jax_physics_solo12_trot_n50.npz);
       run_motion/solo12_trot
                         run-motion at the CLI's defaults with 64 physics
                         episodes on the trot debris (N=165, f32, 1,650
                         steps): all four kernels, the JAX stage-4b
                         shapes, the JAX CLI's files; then, last,
                         `# run_motion <stage> profile`: each kernel's
                         device ms a call on its shapes (N=165, B=1), and
                         `# physics step window`: 50 profiled plant steps
                         of 64 episodes (launches a step, busy share);
       monte_carlo       sim/monte_carlo.run_monte_carlo on the main
                         path's scenario-0 plan, 1024 sims, against the
                         same draws on the CPU, and the sim metrics;
       sharded           the main batch through parallel/multihost's
                         fleet_solver: at world 1 (NCCL) in this process,
                         held to the main path's solution, then on two
                         worker processes sharing the card (gloo; NCCL
                         refuses two ranks on one card), 64 rows each
                         through shard_local_rows, each rank's lanes
                         within 1e-3 of the main path's and every kernel
                         launched in each worker.
     Each prints its launches, CUDA-event wall time, n_success and status
     counts; each requires the kernels its path runs to launch and the
     others not to (the dense path and 'thomas' launch only dare_lqr; the
     pipeline's SCP stages all four, the DARE at 2 and 30 steps, stage
     4b's gains one DARE, its other stages, the plant and the bolt DDP
     none);
     every path runs even when an earlier one fails its gate, and the
     script then exits non-zero without a result.  The pipeline, bolt,
     physics and run-motion paths run first, right after the kernel
     checks and before any torch.profiler session (they are host-bound);
     one DDP iteration, run-motion's SCP stages and the plant's window
     are profiled last (`# pipeline/f64 DDP iteration`,
     `# run_motion <stage> profile`, `# physics step window`).

Output: a JSON line of per-kernel results, the nvidia-smi name/power-limit
line, and as the last line {"ok": true, "device": {...}}.
"""
import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from centroidal_mpc_tpu_torch import _tree, cli, convert, pipeline
from centroidal_mpc_tpu_torch.config import gaits, presets
from centroidal_mpc_tpu_torch.config.robots import BOLT
from centroidal_mpc_tpu_torch.contact.plan import build_contact_plan
from centroidal_mpc_tpu_torch.contact.swing import compute_swing_trajectories
from centroidal_mpc_tpu_torch.contact.terrain import DEBRIS_BY_GAIT
from centroidal_mpc_tpu_torch.models import rigid_body as rb
from centroidal_mpc_tpu_torch.models import whole_body_ddp as wbd
from centroidal_mpc_tpu_torch.models.centroidal import (
    compute_trajectory_data, linearize_step, rollout)
from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import cuda_lib
from centroidal_mpc_tpu_torch.ops import lqr_kernel
from centroidal_mpc_tpu_torch.ops.admm import QPSettings, solve_qp
from centroidal_mpc_tpu_torch.ops.certify import certify_qp_solution
from centroidal_mpc_tpu_torch.parallel import multihost
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)
from centroidal_mpc_tpu_torch.runtime import native
from centroidal_mpc_tpu_torch.sim import metrics
from centroidal_mpc_tpu_torch.sim import physics as phys
from centroidal_mpc_tpu_torch.sim.monte_carlo import run_monte_carlo
from centroidal_mpc_tpu_torch.sim.preview import write_motion_preview
from centroidal_mpc_tpu_torch.solver.ddp import DdpSettings
from centroidal_mpc_tpu_torch.solver.mpc import MpcController
from centroidal_mpc_tpu_torch.solver.ocp import build_qp
from centroidal_mpc_tpu_torch.solver.scp import set_fp32_exact
from centroidal_mpc_tpu_torch.solver.stochastic import (apply_exact_backoffs,
                                                        backoff_jacobians)
from centroidal_mpc_tpu_torch.utils.artifacts import ArtifactStore
from centroidal_mpc_tpu_torch.utils.profiling import StageTimer

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_CACHE = os.path.join(ROOT, "benchmarks", "ref_cache",
                         "solo12_trot_n50_1dbb8aa1aab5.npz")
STOCH_REF = "solo12_trot_n50_stoch_2300b6ec2317.npz"
BATCH = 128
SEED = 0
KERNEL_RTOL = 1e-4      # f32 kernel vs plain, relative to the plain max
PARITY_BAR = 1e-4       # u_err_inf / x_err_inf vs the f64 reference
# the MPC tick (bench.py:437-496): solo12_trot_n50's plan, a 20-knot
# window, B=1; 30 ticks from tick 0, then one at the clamp (max_tick 30)
MPC_WINDOW = 20
MPC_TICKS = 30
MPC_SHAPE = (1, MPC_WINDOW, 22)
MC_SIMS = 1024          # Monte-Carlo sims on the main path's plan
MC_RTOL = 1e-4          # card vs CPU X_sim, relative to max|X_sim|
# ranks of the `sharded` phase's two-process run, each on the one card
SHARD_RANKS = 2
# kernel-vs-plain shapes (B, N, V): the bench's kernel_exact shape, the
# main path's, a horizon that wraps the sweeps' ring, more than one wave,
# then the other paths' shapes: bolt_pace (V=16, the generic width-32
# build with pad lanes), solo12_pace, N=165 at the preset batch, the MPC
# tick's window, one full-plan scenario and a rank's shard of the main
# batch
KERNEL_SHAPES = [(32, 8, 22), (BATCH, 50, 22), (4, 165, 22), (300, 50, 22),
                 (32, 122, 16), (32, 107, 22), (32, 165, 22), MPC_SHAPE,
                 (1, 50, 22), (BATCH // SHARD_RANKS, 50, 22)]
# DARE steps: the main path's, then the stochastic stage's
# (centroidal_mpc_tpu/pipeline.py:55, stochastic_lqr_iters)
DARE_ITERS = (2, 30)
# the DARE against its plain version on real linearizations, (preset
# name, scenarios, knots (None: the whole plan), step counts): the main
# path's and bolt's (nu 6) over BATCH scenarios at both step counts,
# talos's (wrench6 B) as its preset row runs it (S = 32 x 165, 2 steps,
# once an SCP iteration), the stochastic stage's (S = 8 x 165, 30 steps),
# a rank's shard of the main batch (S = 64 x 50) and the MPC tick's
# window (S = 1 x 20, 2 steps, once a tick)
DARE_CASES = (("solo12_trot_n50", BATCH, None, DARE_ITERS),
              ("bolt_pace", BATCH, None, DARE_ITERS),
              ("talos_pace", 32, None, (2,)),
              ("solo12_trot", 8, None, (30,)),
              ("solo12_trot_n50", BATCH // SHARD_RANKS, None, (2,)),
              ("solo12_trot_n50", 1, MPC_WINDOW, (2,)))
# published H100 SXM peaks at 700 W (NVIDIA's data sheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
FLUSH_BYTES = 64 << 20  # flushes the 50 MB L2 between cold launches

# the bench headline operating point (bench.py defaults)
QP = QPSettings(eps_abs=5e-4, eps_rel=5e-4, polish=True, polish_iters=12,
                polish_rounds=2, polish_cg_iters=8, polish_cg_restarts=1,
                check_interval=10, alpha=1.7, adaptive_rho=False,
                max_iter=4000, stall_segments=30, factor_method="pallas")

REPLACES = {
    "tridiag_factor": "centroidal_mpc_tpu/ops/pallas_blockqp.py:203",
    "tridiag_fwd": "centroidal_mpc_tpu/ops/pallas_blockqp.py:280",
    "tridiag_bwd": "centroidal_mpc_tpu/ops/pallas_blockqp.py:299",
    "dare_lqr": "centroidal_mpc_tpu/ops/pallas_lqr.py:114",
}
LIBRARY_NOTE = {
    "tridiag_factor": "none: no single PyTorch call writes C^-1, Pfwd and "
                      "Pbwd; a dense torch.linalg.cholesky of M writes none "
                      "of them",
    "tridiag_fwd": "none: no single PyTorch call runs a block-tridiagonal "
                   "sweep over a pre-inverted factor",
    "tridiag_bwd": "none: no single PyTorch call runs a block-tridiagonal "
                   "sweep over a pre-inverted factor",
    "dare_lqr": "none: no single PyTorch call computes truncated-DARE LQR "
                "gains",
}
SOURCES = {
    "tridiag_factor": "centroidal_mpc_tpu_torch/csrc/block_tridiag.cu",
    "tridiag_fwd": "centroidal_mpc_tpu_torch/csrc/block_tridiag.cu",
    "tridiag_bwd": "centroidal_mpc_tpu_torch/csrc/block_tridiag.cu",
    "dare_lqr": "centroidal_mpc_tpu_torch/csrc/dare_lqr.cu",
}
# device kernel names of each row: the factor is two launches a call
DEVICE_KERNELS = {
    "tridiag_factor": ("tridiag_factor_chain_kernel",
                       "tridiag_factor_couple_kernel"),
    "tridiag_fwd": ("tridiag_fwd_kernel",),
    "tridiag_bwd": ("tridiag_bwd_kernel",),
    "dare_lqr": ("dare_lqr_kernel",),
}


def launch_counts():
    return {**bt.launches, **lqr_kernel.launches}


def reset_counts():
    for d in (bt.launches, lqr_kernel.launches):
        for k in d:
            d[k] = 0


def host_seconds(fn):
    """Host time of one fn() call (its launch cost), after a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds


def queue_behind_sleep(seconds):
    """Hold the stream for longer than `seconds` (a spin of 4e9 cycles a
    second: over 2x at the H100's clocks), so that launches queued
    meanwhile run back to back and events time the device alone."""
    torch.cuda._sleep(int(4e9 * seconds) + 10_000)


def cuda_ms(fn, reps=20, warmup=3, queued=True):
    """Mean CUDA-event time of fn() in ms over `reps` back-to-back
    launches.  queued: first queue them behind a device sleep, so that
    the time is the device's and not the host's launch rate (a kernel of
    a few us launches slower than it runs)."""
    for _ in range(warmup):
        fn()
    host = host_seconds(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        queue_behind_sleep(host * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps=10):
    """Mean over `reps` launches of one event pair each, with L2 flushed
    before each launch so that its inputs come from HBM: FLUSH_BYTES are
    written, then FLUSH_BYTES of another buffer read, so that the dirty
    lines of the write go back to HBM before the launch and not during
    it.  Each launch is queued behind a device sleep."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    clean = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    host = host_seconds(fn)
    pairs = []
    for _ in range(reps):
        flush.fill_(1)
        clean.sum()
        queue_behind_sleep(host)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.fmean(a.elapsed_time(b) for a, b in pairs)


def bound(cost):
    """(bound_ms, bound_by) from a launch's cuda_lib.Cost: the larger of
    the bytes it must move over the HBM rate and its flops over the f32
    rate."""
    t_bytes = cost.bytes / PEAK_BYTES * 1e3
    t_ops = cost.flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timings(fn, plain, cost):
    """The kernel's numbers for the kernels line.  layout_bound_ms: the
    byte bound of its tensors whole, as the kernel reads them."""
    bound_ms, bound_by = bound(cost)
    return dict(ms=cuda_ms(fn), cold_ms=cold_ms(fn),
                plain_ms=cuda_ms(plain, 3, 1, queued=False),
                bound_ms=bound_ms, bound_by=bound_by,
                layout_bound_ms=cost.layout_bytes / PEAK_BYTES * 1e3,
                library_ms=None)


def phase_environment():
    print(f"# python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU "
                           "only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"# card: {card}  ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)")
    set_fp32_exact()
    return card


def phase_build():
    path, seconds = cuda_lib.build()
    cuda_lib.library()
    print(f"# build: {seconds:.1f} s -> {os.path.relpath(path, ROOT)}")
    log = (path.parent / "build.log").read_text()
    for line in log.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            print("#   " + line.strip())


def random_system(b, n, v, seed):
    """SPD block-tridiagonal system of the bench's kernel_exact shape
    (bench.py:402-434): off 0.2 N(0,1), diag R R'/v + 3 I."""
    g = torch.Generator().manual_seed(seed)
    off = 0.2 * torch.randn(b, n, v, v, generator=g)
    r = torch.randn(b, n + 1, v, v, generator=g)
    diag = r @ r.mT / v + 3.0 * torch.eye(v)
    rhs = torch.randn(b, n + 1, v, generator=g)
    return [t.cuda() for t in (diag, off, rhs)]


def apply_m(diag, off, w):
    out = (diag @ w[..., None])[..., 0]
    out[:, 1:] += (off @ w[:, :-1, :, None])[..., 0]
    out[:, :-1] += (off.mT @ w[:, 1:, :, None])[..., 0]
    return out


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def phase_kernels():
    """Every kernel against its plain version at every shape.  Returns the
    main path's numbers per kernel, each with its numbers at the MPC
    tick's shape (B=1) under the keys with an `_mpc` suffix."""
    results, mpc_times = {}, {}
    for (b, n, v) in KERNEL_SHAPES:
        diag, off, rhs = random_system(b, n, v, seed=7)
        fk = bt.factor_batched(diag, off)
        fp = bt.factor_plain(diag, off)
        f_err = max(rel_err(x, y) for x, y in zip(fk, fp))
        f_abs = max(float((x - y).abs().max()) for x, y in zip(fk, fp))
        vk = bt.forward_sweep(fk, rhs)
        vp = bt.forward_sweep_plain(fk, rhs)
        wk = bt.backward_sweep(fk, vk)
        wp = bt.backward_sweep_plain(fk, vk)
        w_full = bt.solve_batched(fk, rhs)
        w_plain = bt.backward_sweep_plain(fp, bt.forward_sweep_plain(fp, rhs))
        solve_err = rel_err(w_full, w_plain)
        resid = rel_err(apply_m(diag, off, w_full), rhs)
        torch.cuda.synchronize()
        print(f"# factor/solve B={b} N={n} V={v}: factor rel {f_err:.2e}, "
              f"fwd rel {rel_err(vk, vp):.2e}, bwd rel {rel_err(wk, wp):.2e},"
              f" solve rel {solve_err:.2e}, |Mw-b|/|b| {resid:.2e}")
        check(f_err < KERNEL_RTOL, f"factor rel err {f_err}")
        check(rel_err(vk, vp) < KERNEL_RTOL, "forward sweep disagrees")
        check(rel_err(wk, wp) < KERNEL_RTOL, "backward sweep disagrees")
        check(solve_err < KERNEL_RTOL, f"solve rel err {solve_err}")
        check(resid < KERNEL_RTOL, f"residual {resid}")
        # each half of the factor alone, against its plain version on the
        # same inputs; the couplings write Pfwd over W, so they get a copy
        ck, cw = bt.factor_chain(diag, off)
        chain_err = max(rel_err(x, y) for x, y in
                        zip((ck, cw), bt.factor_chain_plain(diag, off)))
        w_in = cw.clone()
        couple_err = max(rel_err(x, y) for x, y in
                         zip(bt.factor_couple(ck, w_in),
                             bt.factor_couple_plain(ck, cw)))
        torch.cuda.synchronize()
        print(f"# factor halves B={b} N={n} V={v}: chain rel "
              f"{chain_err:.2e}, couple rel {couple_err:.2e}")
        check(chain_err < KERNEL_RTOL, f"factor chain rel err {chain_err}")
        check(couple_err < KERNEL_RTOL, f"factor couple rel err {couple_err}")
        if (b, n, v) == MPC_SHAPE:   # the MPC tick's: times at B=1
            mpc_times["tridiag_factor"] = timings(
                lambda: bt.factor_batched(diag, off),
                lambda: bt.factor_plain(diag, off),
                bt.factor_cost(b, n + 1, v))
            mpc_times["tridiag_fwd"] = timings(
                lambda: bt.forward_sweep(fk, rhs),
                lambda: bt.forward_sweep_plain(fk, rhs),
                bt.sweep_cost(b, n + 1, v))
            mpc_times["tridiag_bwd"] = timings(
                lambda: bt.backward_sweep(fk, vk),
                lambda: bt.backward_sweep_plain(fk, vk),
                bt.sweep_cost(b, n + 1, v))
        if b == BATCH:   # main-path shape: record errors and times
            results["tridiag_factor"] = dict(
                max_abs_err=f_abs,
                **timings(lambda: bt.factor_batched(diag, off),
                          lambda: bt.factor_plain(diag, off),
                          bt.factor_cost(b, n + 1, v)))
            # the couplings' repeats run in place over w_in: their time
            # does not depend on the values there
            for half, fn, plain, cost in (
                    ("chain", lambda: bt.factor_chain(diag, off),
                     lambda: bt.factor_chain_plain(diag, off),
                     bt.factor_chain_cost(b, n + 1, v)),
                    ("couple", lambda: bt.factor_couple(ck, w_in),
                     lambda: bt.factor_couple_plain(ck, cw),
                     bt.factor_couple_cost(b, n + 1, v))):
                r = timings(fn, plain, cost)
                print(f"# time tridiag_factor {half}: kernel {r['ms']:.4f} "
                      f"ms warm, {r['cold_ms']:.4f} ms cold, plain "
                      f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}; {r['layout_bound_ms']:.4f} ms for "
                      f"the bytes of the whole tensors)")
            results["tridiag_fwd"] = dict(
                max_abs_err=float((vk - vp).abs().max()),
                **timings(lambda: bt.forward_sweep(fk, rhs),
                          lambda: bt.forward_sweep_plain(fk, rhs),
                          bt.sweep_cost(b, n + 1, v)))
            results["tridiag_bwd"] = dict(
                max_abs_err=float((wk - wp).abs().max()),
                **timings(lambda: bt.backward_sweep(fk, vk),
                          lambda: bt.backward_sweep_plain(fk, vk),
                          bt.sweep_cost(b, n + 1, v)))

    results["dare_lqr"], mpc_times["dare_lqr"] = phase_dare()
    for name, r in results.items():
        print(f"# time {name}: kernel {r['ms']:.4f} ms warm, "
              f"{r['cold_ms']:.4f} ms cold, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['layout_bound_ms']:.4f} ms for the bytes of the whole "
              f"tensors)")
    for name, r in mpc_times.items():
        print(f"# time {name} mpc B=1: kernel {r['ms']:.4f} ms warm, "
              f"{r['cold_ms']:.4f} ms cold, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.3e} ms ({r['bound_by']})")
        results[name].update({k + "_mpc": r[k] for k in (
            "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by")})
    return results


def dare_inputs(preset, batch=BATCH, knots=None):
    """Q, R and the (A, B) pairs of a preset's real linearization at the
    `batch` scenarios' warm starts over the first `knots` knots (None:
    all N), f32 on the card: S = batch * knots."""
    prob = presets.build_problem(preset, dtype=torch.float32, device="cuda")
    X0, U0, _ = scenarios(prob, batch)
    sched = prob.plan.schedule
    n = sched.horizon if knots is None else knots
    _, A, Bm, _ = linearize_step(prob.model, X0[:, :n], U0[:, :n],
                                 sched.position[:n], sched.logic[:n],
                                 sched.orientation[:n])
    nu = prob.model.n_u
    return (prob.model.Q, prob.model.R, A.reshape(-1, 9, 9).contiguous(),
            Bm.reshape(-1, 9, nu).contiguous())


def phase_dare():
    """dare_lqr against its plain version on the real linearizations of
    DARE_CASES; timed on solo12_trot_n50 at DARE_ITERS steps and on the
    MPC window at 2.  Returns (the main path's numbers, the window's)."""
    inputs = {case[:3]: dare_inputs(presets.PRESETS[case[0]], *case[1:3])
              for case in DARE_CASES}
    max_abs = None
    for case in DARE_CASES:
        name, step_counts, args = case[0], case[3], inputs[case[:3]]
        for n_iter in step_counts:
            Kk = lqr_kernel.lqr_gain_batched(*args, n_iter)
            Kp = lqr_kernel.lqr_gain_plain(*args, n_iter)
            torch.cuda.synchronize()
            k_err = rel_err(Kk, Kp)
            print(f"# dare_lqr {name} S={args[2].shape[0]} nu="
                  f"{args[3].shape[-1]} n_iter={n_iter}: |K - K_plain|inf "
                  f"/ |K_plain|inf {k_err:.2e}")
            check(k_err < KERNEL_RTOL, f"dare_lqr {name} n_iter={n_iter} "
                                       f"rel err {k_err}")
            if max_abs is None:   # the main path's: solo12, 2 steps
                max_abs = float((Kk - Kp).abs().max())
    Q, R, A, Bm = inputs[DARE_CASES[0][:3]]
    S, nu = A.shape[0], Bm.shape[-1]
    runs = {n_iter: timings(
        lambda: lqr_kernel.lqr_gain_batched(Q, R, A, Bm, n_iter),
        lambda: lqr_kernel.lqr_gain_plain(Q, R, A, Bm, n_iter),
        lqr_kernel.lqr_cost(S, 9, nu, n_iter)) for n_iter in DARE_ITERS}
    r = runs[DARE_ITERS[-1]]
    print(f"# time dare_lqr n_iter={DARE_ITERS[-1]}: kernel {r['ms']:.4f} ms "
          f"warm, {r['cold_ms']:.4f} ms cold, plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); share of bound "
          f"{r['bound_ms'] / r['cold_ms']:.1%} cold, "
          f"{r['bound_ms'] / r['ms']:.1%} warm")
    tag = f"_n_iter{DARE_ITERS[-1]}"
    Qw, Rw, Aw, Bw = inputs[DARE_CASES[-1][:3]]
    window = timings(lambda: lqr_kernel.lqr_gain_batched(Qw, Rw, Aw, Bw, 2),
                     lambda: lqr_kernel.lqr_gain_plain(Qw, Rw, Aw, Bw, 2),
                     lqr_kernel.lqr_cost(Aw.shape[0], 9, Bw.shape[-1], 2))
    return dict(max_abs_err=max_abs, **runs[DARE_ITERS[0]],
                **{k + tag: r[k] for k in ("ms", "cold_ms", "plain_ms",
                                           "bound_ms")}), window


def scenarios(prob, batch=BATCH):
    """Scenario 0 unperturbed; the others get 0.005 N(0,1) on CoM x, y
    over the whole warm-start trajectory (bench.py:239-257)."""
    rng = np.random.default_rng(SEED)
    dx = np.zeros((batch, 9))
    dx[1:, :2] = 0.005 * rng.standard_normal((batch - 1, 2))
    dx = torch.as_tensor(dx, dtype=prob.X0.dtype, device=prob.X0.device)
    X0 = prob.X0[None] + dx[:, None, :]
    U0 = prob.U0.expand((batch,) + prob.U0.shape)
    cfg = tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0)
    return X0, U0, cfg


def phase_slice(card):
    prob = presets.build_problem(presets.SOLO12_TROT_N50,
                                 dtype=torch.float32, qp=QP, device="cuda")
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    X0, U0, cfg = scenarios(prob)

    def solve():
        return batched_solve(prob.model, prob.plan.schedule, cfg, X0, U0,
                             scp)

    reset_counts()
    sol = solve()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"# main-path launches: {counts}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    for f in dataclasses.fields(sol):
        check(getattr(sol, f.name).device.type == "cuda",
              f"output {f.name} is not on the card")
    check(sol.X.shape == (BATCH, 51, 9) and sol.U.shape == (BATCH, 50, 12),
          "output shapes")
    check(bool(torch.isfinite(sol.X).all() and torch.isfinite(sol.U).all()
               and torch.isfinite(sol.K).all()), "non-finite outputs")
    n_success = int(sol.success.sum())
    ref = np.load(REF_CACHE)
    x_err = float(np.abs(sol.X[0].double().cpu().numpy() - ref["X"]).max())
    u_err = float(np.abs(sol.U[0].double().cpu().numpy() - ref["U"]).max())
    mean_qp = float(sol.qp_iterations.float().mean())

    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solve()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    batch_ms = statistics.median(times)
    print(f"# slice: solo12_trot_n50 B={BATCH} f32: n_success {n_success}/"
          f"{BATCH}, mean qp iters {mean_qp:.1f}, x_err_inf {x_err:.3e}, "
          f"u_err_inf {u_err:.3e}; batch {batch_ms:.2f} ms (median of 5), "
          f"{BATCH / batch_ms * 1e3:.1f} solves/s [{card}]")
    check(n_success == BATCH, f"only {n_success}/{BATCH} lanes succeeded")
    check(x_err <= PARITY_BAR and u_err <= PARITY_BAR,
          f"parity: x_err {x_err}, u_err {u_err} > {PARITY_BAR}")
    return counts, solve, batch_ms, (prob, scp, sol)


def profile_batch(solve):
    """One batch under torch.profiler, tracing the device only (host ops
    would double the events to process after a long batch): (CUDA-event
    ms of the batch, device ms by kernel name with launch counts, the
    wrappers' calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        solve()
        end.record()
        torch.cuda.synchronize()
    calls = launch_counts()
    per_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = per_name.get(ev.name, (0.0, 0))
            per_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    return start.elapsed_time(end), per_name, calls


def kernel_device_ms(per_name, name):
    """(device ms, device launches) of one of the port's kernels (the
    factor's two launches summed) in a profiled batch."""
    total, launches = 0.0, 0
    for kernel in DEVICE_KERNELS[name]:
        hits = [v for k, v in per_name.items() if kernel in k]
        total += sum(h[0] for h in hits) / 1e3
        launches += sum(h[1] for h in hits)
    return total, launches


def phase_profile(solve, batch_ms):
    """One more main-path batch under torch.profiler: device time by
    kernel name, and the device's busy share: that device time over
    batch_ms, the unprofiled batch's CUDA-event time (the profiler slows
    the host).  Returns each of the port's kernels' mean device ms per
    wrapper call in the path (the factor's two launches summed)."""
    profiled_ms, per_name, calls = profile_batch(solve)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    print(f"# profile: device busy {busy_ms:.2f} ms, busy share "
          f"{busy_ms / batch_ms:.1%} of the unprofiled batch's "
          f"{batch_ms:.2f} ms ({profiled_ms:.2f} ms under the profiler), "
          f"{sum(n for _, n in per_name.values())} device events")
    check(busy_ms > 0, "the profiler saw no device time")
    in_path = {}
    for name in REPLACES:
        for kernel in DEVICE_KERNELS[name]:
            hits = [v for k, v in per_name.items() if kernel in k]
            k_us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
            check(n > 0, f"the profiler saw no {kernel} in the batch")
            print(f"#   {kernel}: {n} launches, {k_us / 1e3:.3f} ms in the "
                  f"batch ({k_us / 1e3 / n:.4f} ms per launch)")
        ms, _ = kernel_device_ms(per_name, name)
        in_path[name] = ms / max(calls[name], 1)
        print(f"#   {name}: {calls[name]} calls, {ms:.3f} ms in the "
              f"batch ({in_path[name]:.4f} ms per call, "
              f"{ms / busy_ms:.1%} of busy time)")
    for k, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"#   top: {us / 1e3:8.3f} ms {n:6d}x {k[:90]}")
    return in_path


# ---------------------------------------------------------------------------
# the other paths: each driven once through batched_solve with every
# launch count set to 0 just before it and read just after
# ---------------------------------------------------------------------------


def ref_errors(sol, name):
    """(x_err_inf, u_err_inf) of scenario 0 against a committed float64
    reference solution, loaded by its exact file name."""
    ref = np.load(os.path.join(ROOT, "benchmarks", "ref_cache", name))
    return (float(np.abs(sol.X[0].double().cpu().numpy() - ref["X"]).max()),
            float(np.abs(sol.U[0].double().cpu().numpy() - ref["U"]).max()))


def drive(path, prob, scp, batch, card, profile=False, kernels=None):
    """Solve `batch` scenarios of prob through parallel.batch.batched_solve
    once, timed by CUDA events, with the launch counts zeroed just before
    and read just after; every kernel named in `kernels` (all when None)
    must have launched, and no other.  profile: one
    more batch under torch.profiler for each kernel's device time and the
    device's busy share: all device time of that batch over the
    unprofiled batch's CUDA-event time (the profiler slows the host).
    Returns (solution, the path's record)."""
    X0, U0, cfg = scenarios(prob, batch)

    def solve():
        return batched_solve(prob.model, prob.plan.schedule, cfg, X0, U0,
                             scp)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_counts()
    start.record()
    sol = solve()
    end.record()
    torch.cuda.synchronize()
    counts = launch_counts()
    wall_ms = start.elapsed_time(end)
    statuses = {int(k): int(n) for k, n in zip(
        *torch.unique(sol.qp_status, return_counts=True))}
    n_success = int(sol.success.sum())
    rec = dict(path=path, batch=batch, horizon=prob.plan.horizon,
               launches=counts, wall_ms=wall_ms, n_success=n_success,
               qp_status=statuses,
               scp_iterations_max=int(sol.iterations.max()),
               mean_qp_iters=float(sol.qp_iterations.float().mean()))
    print(f"# {path}: {prob.preset.name} N={prob.plan.horizon} B={batch}: "
          f"launches {counts}; wall {wall_ms:.2f} ms (CUDA events, one "
          f"batch); n_success {n_success}/{batch}; qp_status counts "
          f"{statuses}; SCP iterations max {rec['scp_iterations_max']}, "
          f"mean QP iterations {rec['mean_qp_iters']:.1f} [{card}]")
    for lane in (~sol.success).nonzero()[:, 0].tolist():
        print(f"#   {path}: lane {lane} failed: qp_status "
              f"{int(sol.qp_status[lane])}, SCP iterations "
              f"{int(sol.iterations[lane])}, qp_converged "
              f"{bool(sol.qp_converged[lane])}")
    for name, n in counts.items():
        if kernels is None or name in kernels:
            check(n > 0, f"{path}: kernel {name} was not launched")
        else:
            check(n == 0, f"{path}: kernel {name} launched {n} times")
    check(bool(torch.isfinite(sol.X).all() and torch.isfinite(sol.U).all()
               and torch.isfinite(sol.K).all()
               and torch.isfinite(sol.Sigma).all()),
          f"{path}: non-finite outputs")
    if profile:
        t0 = time.perf_counter()
        batch_ms, per_name, calls = profile_batch(solve)
        rec["profile_s"] = time.perf_counter() - t0
        busy = sum(us for us, _ in per_name.values()) / 1e3
        rec.update(profiled_ms=batch_ms, busy_ms=busy,
                   busy_share=busy / wall_ms)
        print(f"#   {path} profile: device busy {busy:.2f} ms, busy share "
              f"{busy / wall_ms:.1%} of the unprofiled batch's "
              f"{wall_ms:.2f} ms ({batch_ms:.2f} ms under the profiler), "
              f"{sum(n for _, n in per_name.values())} device events; "
              f"{rec['profile_s']:.1f} s with the trace's processing")
        for name in REPLACES:
            ms, n = kernel_device_ms(per_name, name)
            rec[f"{name}_ms_in_batch"] = ms / max(calls[name], 1)
            print(f"#   {path} profile: {name}: {calls[name]} calls, "
                  f"{n} device launches, {ms:.3f} ms in the batch "
                  f"({ms / max(calls[name], 1):.4f} ms per call)")
        for k, (us, n) in sorted(per_name.items(),
                                 key=lambda kv: -kv[1][0])[:4]:
            print(f"#   {path} profile top: {us / 1e3:8.3f} ms {n:6d}x "
                  f"{k[:80]}")
    return sol, rec


def problem(preset, qp=QP, norm_method="power", dtype=torch.float32,
            **kw):
    prob = presets.build_problem(preset, dtype=dtype, qp=qp,
                                 device="cuda", **kw)
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method=norm_method)
    return prob, scp


def phase_stochastic(card):
    """The bench's stochastic row (bench.py:499-521): solo12_trot_n50,
    chance-constrained, B=64, the bench operating point, 2 DARE steps."""
    prob, scp = problem(presets.SOLO12_TROT_N50, stochastic=True)
    sol, rec = drive("stochastic", prob, scp, 64, card)
    rec["x_err_inf"], rec["u_err_inf"] = ref_errors(sol, STOCH_REF)
    print(f"# stochastic: scenario 0 x_err_inf {rec['x_err_inf']:.3e}, "
          f"u_err_inf {rec['u_err_inf']:.3e} against {STOCH_REF}; trace "
          f"Sigma_N {float(sol.Sigma[0, -1].diagonal().sum()):.3f}")
    check(rec["n_success"] == 64, f"stochastic: {rec['n_success']}/64")
    check(rec["x_err_inf"] <= PARITY_BAR and rec["u_err_inf"] <= PARITY_BAR,
          f"stochastic parity: {rec['x_err_inf']}, {rec['u_err_inf']}")
    return rec


def phase_stochastic_stage(card):
    """Pipeline stage 2' as the f32 pipeline runs it
    (centroidal_mpc_tpu/pipeline.py:102-104, 167-190): solo12_trot
    (N=165), chance-constrained, 30 DARE steps, QP eps 1e-4, 'always'
    rho, polish; B=8.  The warm start is the preset's analytic one, so
    that the phase stays as it was measured before the iLQR warm start
    was ported; `# pipeline/*` runs the stage from the iLQR warm start."""
    prob, scp = problem(presets.SOLO12_TROT, qp=pipeline.F32_QP,
                        norm_method="svd", stochastic=True)
    scp = dataclasses.replace(scp, lqr_iters=30)
    sol, rec = drive("stochastic_stage", prob, scp, 8, card, profile=True)
    print(f"# stochastic_stage: the DARE at 30 steps: "
          f"{rec['launches']['dare_lqr']} launches, "
          f"{rec['dare_lqr_ms_in_batch']:.4f} ms a call in the batch (S = "
          f"8 x 165); trace Sigma_N of scenario 0 "
          f"{float(sol.Sigma[0, -1].diagonal().sum()):.3f}")
    check(bool(sol.success[0]), "stochastic_stage: scenario 0 failed")
    return rec


# the bench's preset matrix (bench.py:550-600) and each row's reference
PRESET_ROWS = (("solo12_pace", "solo12_pace_d89ac1ddf233.npz"),
               ("solo12_bound", "solo12_bound_70d700d765f5.npz"),
               ("bolt_pace", "bolt_pace_db3f1193029a.npz"),
               ("talos_pace", "talos_pace_3a1d4d3d1382.npz"))


def phase_presets(card):
    """Each row of the bench's preset matrix at B=32, eps 5e-4 + polish;
    talos (wrench6, re-linearizing) with 'always' rho as the bench runs
    it (bench.py:564-571).  Scenario 0 must succeed; bolt must also meet
    the parity bar; u_err of pace, bound and talos is data (pace and
    bound miss it in the JAX package too, ROADMAP Queue C)."""
    recs = []
    for name, ref in PRESET_ROWS:
        preset = presets.PRESETS[name]
        qp = QP
        if preset.robot.n_u_per_contact == 6:
            qp = dataclasses.replace(QP, adaptive_rho=True,
                                     adaptive_rho_mode="always")
        prob, scp = problem(preset, qp=qp)
        talos = scp.update_linearization
        sol, rec = drive(f"presets/{name}", prob, scp, 32, card)
        rec["x_err_inf"], rec["u_err_inf"] = ref_errors(sol, ref)
        print(f"# presets/{name}: scenario 0 x_err_inf "
              f"{rec['x_err_inf']:.3e}, u_err_inf {rec['u_err_inf']:.3e} "
              f"against {ref}" + ("" if name == "bolt_pace" else " (data)"))
        check(bool(sol.success[0]), f"presets/{name}: scenario 0 failed")
        if name == "bolt_pace":
            check(rec["x_err_inf"] <= PARITY_BAR
                  and rec["u_err_inf"] <= PARITY_BAR,
                  f"bolt_pace parity: {rec['x_err_inf']}, "
                  f"{rec['u_err_inf']}")
        if talos:
            # one linearization, DARE and QP build per SCP iteration
            check(rec["launches"]["dare_lqr"] == rec["scp_iterations_max"],
                  f"talos: {rec['launches']['dare_lqr']} DARE launches for "
                  f"{rec['scp_iterations_max']} SCP iterations")
        recs.append(rec)
    return recs


def phase_cond(card):
    """'cond' adaptive rho (the JAX default): solo12_trot_n50, B=32, the
    bench point with adaptive_rho_mode='cond'.  Each lane carries its rho
    and factor; only the lanes whose ratio leaves the deadband are
    refactored.  u_err against the nominal reference is data (the JAX
    package reads 2.43 here on the CPU in f32)."""
    qp = dataclasses.replace(QP, adaptive_rho=True, adaptive_rho_mode="cond")
    prob, scp = problem(presets.SOLO12_TROT_N50, qp=qp)
    sol, rec = drive("cond", prob, scp, 32, card)
    rec["x_err_inf"], rec["u_err_inf"] = ref_errors(
        sol, os.path.basename(REF_CACHE))
    r = sol.qp_refactors.float()
    rec["refactors"] = (int(r.min()), float(r.mean()), int(r.max()))
    print(f"# cond: factor launches {rec['launches']['tridiag_factor']}; "
          f"refactors a lane min {rec['refactors'][0]}, mean "
          f"{rec['refactors'][1]:.2f}, max {rec['refactors'][2]}; scenario "
          f"0 x_err_inf {rec['x_err_inf']:.3e}, u_err_inf "
          f"{rec['u_err_inf']:.3e} (data)")
    check(rec["n_success"] == 32, f"cond: {rec['n_success']}/32")
    return rec


def phase_terrain(card):
    """solo12_trot on the reference's trot debris (DEBRIS_BY_GAIT['TROT']),
    B=8, the bench point: footholds snapped onto tilted stones."""
    prob, scp = problem(presets.SOLO12_TROT,
                        terrain=DEBRIS_BY_GAIT["TROT"])
    sched = prob.plan.schedule
    planted = sched.logic > 0
    eye = torch.eye(3, device=sched.orientation.device)
    raised = planted & (sched.position[..., 2].abs() > 0)
    tilted = (sched.orientation - eye).abs().amax((-2, -1)) > 1e-6
    n_off = int((raised & tilted).sum())
    sol, rec = drive("terrain", prob, scp, 8, card)
    rec["footholds_off_ground"] = n_off
    print(f"# terrain: {n_off} planted (knot, foot) pairs off z=0 with a "
          f"rotated frame, highest {float(sched.position[..., 2].max()):.4f}"
          f" m")
    check(n_off > 0, "terrain: no foothold off z=0 with a rotated frame")
    check(bool(sol.success[0]), "terrain: scenario 0 failed")
    return rec


def mpc_controller(dtype, device):
    """The bench's MPC tick (bench.py:437-496) on solo12_trot_n50: the
    bench point at eps 5e-4 without the polish, 'cond' rho, one SCP
    iteration, free terminal state, block backend, power trust norm;
    window MPC_WINDOW, B=1.  Returns (controller, X0 (1, N+1, nx),
    U0 (1, N, nu))."""
    qp = dataclasses.replace(QP, polish=False, adaptive_rho=True,
                             adaptive_rho_mode="cond")
    prob = presets.build_problem(presets.SOLO12_TROT_N50, dtype=dtype,
                                 qp=qp, device=device)
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power", max_iterations=1)
    X0, U0 = prob.X0[None], prob.U0[None]
    cfg = dataclasses.replace(tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1],
                                              X0), terminal_equality=False)
    return (MpcController(model=prob.model, schedule=prob.plan.schedule,
                          cfg=cfg, settings=scp, window=MPC_WINDOW), X0, U0)


def phase_mpc(card):
    """MPC_TICKS receding-horizon ticks from tick 0 in f32, each measuring
    the last tick's sol.X[1] (the bench's perfect-tracking chain,
    bench.py:477-481), then one more tick at the clamp; the launch counts
    zeroed just before the ticks and read just after.  Per tick: solved,
    under the iteration cap, every kernel launched.  Host time of a tick
    with a device sync inside the timed window, p50/p99 over ticks 2-29;
    one tick again unprofiled (CUDA events) and profiled for the busy
    share; tick 0 against the port's f64 CPU solve of the same window."""
    ctrl, X0, U0 = mpc_controller(torch.float32, "cuda")
    state = ctrl.init_state(X0, U0)
    x = X0[:, 0]
    ticks, replay = [], None
    torch.cuda.synchronize()
    reset_counts()
    for i in range(MPC_TICKS + 1):
        before = launch_counts()
        if i == MPC_TICKS // 3:
            replay = (state, x)
        t0 = time.perf_counter()
        state, sol = ctrl.step(state, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        ticks.append(dict(
            success=bool(sol.success[0]), status=int(sol.qp_status[0]),
            qp_iters=int(sol.qp_iterations[0]),
            refactors=int(sol.qp_refactors[0]), launches=launched, ms=ms,
            tick=state.tick))
        print(f"# mpc tick {i}{' (clamp)' if i == MPC_TICKS else ''}: "
              f"success {ticks[-1]['success']}, status "
              f"{ticks[-1]['status']}, qp iters {ticks[-1]['qp_iters']}, "
              f"refactors {ticks[-1]['refactors']}, factor calls "
              f"{launched['tridiag_factor']}, launches {launched}, "
              f"{ms:.2f} ms, next tick {state.tick}")
        if i == 0:
            sol0 = sol
        x = sol.X[:, 1]
    counts = launch_counts()
    ms = np.array([t["ms"] for t in ticks[2:MPC_TICKS]])
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    n_solved = sum(t["success"] for t in ticks[:MPC_TICKS])
    rec = dict(path="mpc", batch=1, horizon=MPC_WINDOW, launches=counts,
               n_success=n_solved, ticks=len(ticks), tick_p50_ms=p50,
               tick_p99_ms=p99,
               qp_iters=[t["qp_iters"] for t in ticks],
               factor_calls=[t["launches"]["tridiag_factor"] for t in ticks])
    print(f"# mpc: solo12_trot_n50 window {MPC_WINDOW} B=1 f32: "
          f"{n_solved}/{MPC_TICKS} ticks solved (+ the clamp tick: "
          f"{ticks[-1]['success']}); launches {counts}; QP iterations a "
          f"tick min {min(rec['qp_iters'])} mean "
          f"{statistics.fmean(rec['qp_iters']):.1f} max "
          f"{max(rec['qp_iters'])}; factor calls a tick min "
          f"{min(rec['factor_calls'])} max {max(rec['factor_calls'])}; "
          f"tick time (host, synced) p50 {p50:.2f} ms, p99 {p99:.2f} ms "
          f"over ticks 2-{MPC_TICKS - 1} [{card}]")

    # one tick again, unprofiled then profiled: the device's busy share
    st, xm = replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    ctrl.step(st, xm)
    end.record()
    torch.cuda.synchronize()
    tick_ms = start.elapsed_time(end)
    profiled_ms, per_name, calls = profile_batch(lambda: ctrl.step(st, xm))
    busy = sum(us for us, _ in per_name.values()) / 1e3
    rec.update(profiled_tick=MPC_TICKS // 3, tick_ms=tick_ms, busy_ms=busy,
               busy_share=busy / tick_ms)
    print(f"# mpc profile (tick {MPC_TICKS // 3}): device busy {busy:.3f} "
          f"ms, busy share {busy / tick_ms:.1%} of the unprofiled tick's "
          f"{tick_ms:.2f} ms ({profiled_ms:.2f} ms under the profiler), "
          f"{sum(n for _, n in per_name.values())} device events")
    for name in REPLACES:
        k_ms, n = kernel_device_ms(per_name, name)
        rec[f"{name}_ms_in_tick"] = k_ms / max(calls[name], 1)
        print(f"#   mpc profile: {name}: {calls[name]} calls, {n} device "
              f"launches, {k_ms:.3f} ms in the tick "
              f"({rec[f'{name}_ms_in_tick']:.4f} ms per call)")

    # tick 0 against the port's own f64 solve of the same window (data)
    ref_ctrl, rX0, rU0 = mpc_controller(torch.float64, "cpu")
    _, ref = ref_ctrl.step(ref_ctrl.init_state(rX0, rU0), rX0[:, 0])
    rec["tick0_u_err"] = float((sol0.U[0].double().cpu() - ref.U[0]).abs()
                               .max())
    rec["tick0_x_err"] = float((sol0.X[0].double().cpu() - ref.X[0]).abs()
                               .max())
    print(f"# mpc: tick 0 against the f64 CPU solve of its window: u_err "
          f"{rec['tick0_u_err']:.3e}, x_err {rec['tick0_x_err']:.3e} (data; "
          f"f64 {int(ref.qp_iterations[0])} QP iterations, f32 "
          f"{ticks[0]['qp_iters']})")

    check(busy > 0, "mpc: the profiler saw no device time")
    for i, t in enumerate(ticks):
        check(t["success"], f"mpc: tick {i} not solved (status "
                            f"{t['status']})")
        check(t["qp_iters"] < QP.max_iter, f"mpc: tick {i} hit the cap")
        for name, n in t["launches"].items():
            check(n > 0, f"mpc: kernel {name} not launched in tick {i}")
    check(ticks[MPC_TICKS - 1]["tick"] == ctrl.max_tick == 30
          and ticks[-1]["tick"] == ctrl.max_tick,
          f"mpc: the tick does not clamp at {ctrl.max_tick}")
    return rec


def phase_monte_carlo(card, prob, sol):
    """sim.monte_carlo.run_monte_carlo on the main path's scenario-0 plan
    (its X, U and K), MC_SIMS sims, disturbances drawn on the CPU from a
    generator seeded with SEED and moved to the card; the same draws
    through the port on the CPU in f32 must agree within MC_RTOL of
    max|X_sim|.  The rollout launches none of the port's kernels."""
    plan = (sol.X[0], sol.U[0], sol.K[0])

    def run(model, schedule, X, U, K):
        return run_monte_carlo(model, schedule, X, U, K,
                               torch.Generator().manual_seed(SEED), MC_SIMS)

    torch.cuda.synchronize()
    reset_counts()
    res = run(prob.model, prob.plan.schedule, *plan)
    torch.cuda.synchronize()
    counts = launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    again = run(prob.model, prob.plan.schedule, *plan)
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    cpu = run(*_tree.to_device((prob.model, prob.plan.schedule) + plan,
                               "cpu"))
    scale = float(res.X_sim.abs().max())
    err = float((res.X_sim.cpu() - cpu.X_sim).abs().max()) / scale
    cost = metrics.cumulative_tracking_cost(prob.model.Q, res.X_sim,
                                            plan[0])
    fric = metrics.friction_cone_stats(prob.ocp.pyramid, prob.plan.schedule,
                                       res.U_sim)
    ratio = metrics.tangential_ratio(prob.plan.schedule, res.U_sim)
    rec = dict(path="monte_carlo", sims=MC_SIMS, wall_ms=wall_ms,
               rel_err_vs_cpu=err,
               cum_cost_mean=float(cost["cum_mean"][-1]),
               cum_cost_std=float(cost["cum_std"][-1]),
               violations=int(fric["violations"].sum()),
               saturations=int(fric["saturations"].sum()),
               max_tangential_ratio=float(ratio.nan_to_num(0.0).max()))
    print(f"# monte_carlo: {MC_SIMS} sims of solo12_trot_n50's scenario-0 "
          f"plan (push {float(res.push_force[:, 1].abs().max()):.2f} N at "
          f"most): batch {wall_ms:.2f} ms (CUDA events) [{card}]; X_sim "
          f"card vs CPU {err:.2e} of max|X_sim| {scale:.3f}; cumulative "
          f"tracking cost mean {rec['cum_cost_mean']:.4e}, std "
          f"{rec['cum_cost_std']:.4e}; pyramid violations "
          f"{rec['violations']}, saturations {rec['saturations']}; max "
          f"|f_t|/f_z {rec['max_tangential_ratio']:.4f}; launches {counts}")
    check(res.X_sim.shape == (MC_SIMS, prob.plan.horizon + 1, 9),
          "monte_carlo: X_sim shape")
    check(bool(torch.isfinite(res.X_sim).all()
               and torch.isfinite(res.U_sim).all()
               and torch.isfinite(cost["cum_mean"]).all()),
          "monte_carlo: non-finite outputs")
    check(torch.equal(res.X_sim, again.X_sim),
          "monte_carlo: a second run of the same draws differs")
    check(err <= MC_RTOL, f"monte_carlo: card vs CPU {err} > {MC_RTOL}")
    check(all(n == 0 for n in counts.values()),
          f"monte_carlo: launched kernels {counts}")
    return rec


# ---------------------------------------------------------------------------
# the main path sharded over a torch.distributed group (parallel/multihost)
# ---------------------------------------------------------------------------

# sharded vs unsharded lanes (__graft_entry__.py:91-97, dryrun_multichip)
SHARD_BAND = 1e-3
SHARD_WORKER = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
SHARD_TIMEOUT_S = 300
# the worker processes started; the deadline kills them before it exits
SPAWNED = []


def lane_deviation(X, U, sol, rows):
    """(max|X - X_main|, max|U - U_main|) over the main path's `rows`."""
    return (float((X - sol.X[rows].cpu()).abs().max()),
            float((U - sol.U[rows].cpu()).abs().max()))


def phase_sharded(card, prob, scp, sol):
    """The main path's 128 scenarios through parallel/multihost, held to
    the main path's solution `sol`: first in this process at world 1
    (NCCL), then on SHARD_RANKS worker processes sharing the card (gloo:
    NCCL refuses two ranks on one card), each with its own rows."""
    X0, U0, cfg = scenarios(prob)
    return [sharded_one_process(card, prob, scp, sol, (cfg, X0, U0)),
            sharded_processes(card, prob, scp, sol, (cfg, X0, U0))]


def sharded_one_process(card, prob, scp, sol, batch):
    """`# sharded/1proc`: initialize() alone makes a group of this process
    (NCCL on the card); fleet_solver over shard_global_batch of the main
    batch, with the launch counts zeroed just before the solve and read
    just after; then scaling_report.  The group is destroyed at the end,
    so that later phases see none."""
    path = "sharded/1proc"
    multihost.initialize()
    try:
        world, backend = dist.get_world_size(), dist.get_backend()
        solver, mesh = multihost.fleet_solver(prob.model, prob.plan.schedule,
                                              scp)
        args = multihost.shard_global_batch(mesh, batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts()
        start.record()
        out, stats = solver(*args)
        end.record()
        torch.cuda.synchronize()
        counts = launch_counts()
        report = multihost.scaling_report(solver, args, BATCH)
    finally:
        dist.destroy_process_group()
    n_success = int(stats["n_success"])
    qp_iters = int(stats["qp_iterations"])
    x_dev, u_dev = lane_deviation(out.X.to_local().cpu(),
                                  out.U.to_local().cpu(), sol, slice(None))
    rec = dict(path=path, batch=BATCH, world=world, backend=backend,
               launches=counts, wall_ms=start.elapsed_time(end),
               n_success=n_success, qp_iterations=qp_iters,
               max_rho=float(stats["max_rho"]), x_dev=x_dev, u_dev=u_dev,
               solves_per_s=report["solves_per_s"])
    print(f"# {path}: world {world} ({backend}), mesh {mesh.size()} on "
          f"{mesh.device_type}, B={BATCH}: launches {counts}; wall "
          f"{rec['wall_ms']:.2f} ms (CUDA events, one batch); n_success "
          f"{n_success}/{BATCH}, qp_iterations {qp_iters} (main path "
          f"{int(sol.qp_iterations.sum())}), max_rho {rec['max_rho']:.4g}; "
          f"vs the main path's lanes: x {x_dev:.3e}, u {u_dev:.3e} (band "
          f"{SHARD_BAND:g}) [{card}]")
    print(f"# {path} scaling_report: {json.dumps(report)} [{card}]")
    for name, n in counts.items():
        check(n > 0, f"{path}: kernel {name} was not launched")
    for f in dataclasses.fields(out):
        check(getattr(out, f.name).to_local().device.type == "cuda",
              f"{path}: output {f.name} is not on the card")
    check(world == 1 and backend == "nccl", f"{path}: world {world} "
          f"({backend}), expected 1 (nccl)")
    check(tuple(out.X.shape) == (BATCH, 51, 9), f"{path}: X global shape "
          f"{tuple(out.X.shape)}")
    check(n_success == BATCH, f"{path}: n_success {n_success}/{BATCH}")
    check(qp_iters == int(sol.qp_iterations.sum()),
          f"{path}: qp_iterations {qp_iters} != the main path's "
          f"{int(sol.qp_iterations.sum())}")
    check(x_dev < SHARD_BAND and u_dev < SHARD_BAND,
          f"{path}: lanes off the main path's by x {x_dev}, u {u_dev}")
    return rec


def sharded_processes(card, prob, scp, sol, batch):
    """`# sharded/2proc`: SHARD_RANKS worker processes
    (tests/_torch_multihost_worker.py) on the one card, a gloo group; each
    passes its own rows of the main batch through shard_local_rows, solves
    and prints its reduced stats, launch counts and scaling report, and
    writes its lanes to build/chip_smoke/sharded_rank<r>.npz.  The
    library is built already, so the workers load it."""
    path = f"sharded/{SHARD_RANKS}proc"
    os.makedirs(WORK_DIR, exist_ok=True)
    problem = os.path.join(WORK_DIR, "sharded_problem.pt")
    model, schedule, cfg, X0, U0 = _tree.to_device(
        (prob.model, prob.plan.schedule) + batch, "cpu")
    torch.save(dict(model=model, schedule=schedule, settings=scp, cfg=cfg,
                    X0=X0, U0=U0), problem)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(WORK_DIR, f"sharded_rank{r}.npz")
            for r in range(SHARD_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, SHARD_WORKER, f"localhost:{port}",
         str(SHARD_RANKS), str(r), problem, outs[r], "--device", "cuda",
         "--backend", "gloo", "--mode", "local", "--repeats", "3"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(SHARD_RANKS)]
    SPAWNED.extend(procs)
    try:
        logs = [p.communicate(timeout=SHARD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    results, rows = [], BATCH // SHARD_RANKS
    for r, (p, log) in enumerate(zip(procs, logs)):
        lines = [ln for ln in log.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print("\n".join(f"#   rank {r}: {ln}"
                            for ln in log.splitlines()[-30:]))
        check(p.returncode == 0, f"{path}: rank {r} exited "
              f"{p.returncode}")
        check(bool(lines), f"{path}: no RESULT line from rank {r}")
        res = json.loads(lines[-1][len("RESULT "):])
        with np.load(outs[r]) as lanes:
            mine = slice(r * rows, (r + 1) * rows)
            res["x_dev"], res["u_dev"] = lane_deviation(
                torch.as_tensor(lanes["X"]), torch.as_tensor(lanes["U"]),
                sol, mine)
        results.append(res)
        rep = res["report"]
        print(f"# {path} rank {r}: n_success {res['n_success']}, "
              f"qp_iterations {res['qp_iterations']}, max_rho "
              f"{res['max_rho']:.4g}, global {res['global_shape']}, local "
              f"{res['local_shape']} on {res['device']}; launches "
              f"{res['launches']}; vs the main path's lanes {mine.start}-"
              f"{mine.stop - 1}: x {res['x_dev']:.3e}, u "
              f"{res['u_dev']:.3e}; scaling_report "
              f"{rep['solves_per_s']:.1f} solves/s, "
              f"{rep['solves_per_s_per_device']:.1f} a rank [{card}]")
    print(f"# {path}: {SHARD_RANKS} ranks (gloo) on one card, "
          f"{seconds:.1f} s with the workers' start-up")
    stats = [(r["n_success"], r["qp_iterations"], r["max_rho"])
             for r in results]
    check(len(set(stats)) == 1, f"{path}: the ranks' stats differ {stats}")
    check(stats[0][0] == BATCH, f"{path}: n_success {stats[0][0]}/{BATCH}")
    for r, res in enumerate(results):
        for name, n in res["launches"].items():
            check(n > 0, f"{path}: rank {r} did not launch {name}")
        check(res["device"].startswith("cuda"), f"{path}: rank {r} solved "
              f"on {res['device']}")
        check(res["global_shape"] == [BATCH, 51, 9]
              and res["local_shape"] == [rows, 51, 9],
              f"{path}: rank {r} shapes {res['global_shape']}, "
              f"{res['local_shape']}")
        check(res["report"]["processes"] == SHARD_RANKS,
              f"{path}: rank {r} reports {res['report']['processes']} "
              "processes")
        check(res["x_dev"] < SHARD_BAND and res["u_dev"] < SHARD_BAND,
              f"{path}: rank {r} lanes off the main path's by x "
              f"{res['x_dev']}, u {res['u_dev']}")
    return dict(path=path, batch=BATCH, world=SHARD_RANKS, backend="gloo",
                seconds=seconds,
                launches={name: [res["launches"][name] for res in results]
                          for name in REPLACES},
                n_success=stats[0][0], qp_iterations=stats[0][1],
                x_dev=max(res["x_dev"] for res in results),
                u_dev=max(res["u_dev"] for res in results),
                solves_per_s=results[0]["report"]["solves_per_s"])


# ---------------------------------------------------------------------------
# the dense reference-layout path, the block solver's other backends, the
# exact back-offs and the MPC server
# ---------------------------------------------------------------------------

N165_REF = "solo12_trot_09517e40f669.npz"
JAX_DENSE_REF = os.path.join(ROOT, "tests", "data",
                             "jax_dense_solo12_trot.npz")
# card vs the JAX package's CPU solve, both f64 at equal iterations:
# cuSOLVER's and LAPACK's round-off carried through the iterations
JAX_PARITY = 1e-6
DARE_ONLY = ("dare_lqr",)   # the dense path and 'thomas': no block kernel


def lane_stats(sol):
    """QP iterations and adaptive-rho refactors of every lane."""
    return (sol.qp_iterations.tolist(), sol.qp_refactors.tolist())


def phase_dense_n50(card):
    """The README's solve on the N=50 bench problem: the preset's own
    settings (dense backend, 'cond' rho, eps 1e-7, SVD trust norm) in
    f64, B=8; scenario 0 against the f64 cache; the same batch through
    the port on the CPU (data)."""
    prob = presets.build_problem(presets.SOLO12_TROT_N50,
                                 dtype=torch.float64, device="cuda")
    check(prob.scp.qp_backend == "dense", "the preset is not dense")
    sol, rec = drive("dense/solo12_trot_n50", prob, prob.scp, 8, card,
                     profile=True, kernels=DARE_ONLY)
    rec["x_err_inf"], rec["u_err_inf"] = ref_errors(
        sol, os.path.basename(REF_CACHE))
    rec["qp_iters"], rec["refactors"] = lane_stats(sol)
    cpu = _tree.to_device(prob, "cpu")
    X0, U0, cfg = scenarios(cpu, 8)
    t0 = time.perf_counter()
    ref = batched_solve(cpu.model, cpu.plan.schedule, cfg, X0, U0, cpu.scp)
    rec["cpu_s"] = time.perf_counter() - t0
    rec["card_vs_cpu_u"] = float((sol.U.cpu() - ref.U).abs().max())
    rec["cpu_qp_iters"] = ref.qp_iterations.tolist()
    print(f"# dense/solo12_trot_n50: scenario 0 x_err_inf "
          f"{rec['x_err_inf']:.3e}, u_err_inf {rec['u_err_inf']:.3e}; QP "
          f"iterations a lane {rec['qp_iters']} (CPU {rec['cpu_qp_iters']}),"
          f" refactors {rec['refactors']}; card vs CPU max|dU| "
          f"{rec['card_vs_cpu_u']:.3e} (data; the CPU took "
          f"{rec['cpu_s']:.1f} s)")
    check(rec["n_success"] == 8, f"dense n50: {rec['n_success']}/8")
    check(rec["x_err_inf"] <= PARITY_BAR and rec["u_err_inf"] <= PARITY_BAR,
          f"dense n50 parity: {rec['x_err_inf']}, {rec['u_err_inf']}")
    return rec


def phase_dense_n165(card):
    """The README's quick-start problem (solo12_trot, N=165) on the
    preset's settings in f64, B=1; then the first SCP iteration's dense
    QP solved again on the card and certified on the host by ops/certify
    (tests/test_certification.py's KKT gates).  The JAX package's own
    dense solve misses the 1e-4 bar against the block-solver cache
    (u_err 1.06e-4, certified gap 1.07e-4), so both are data here and the
    gate is parity with the JAX package's f64 solve of the same problem
    (JAX_DENSE_REF, scripts/jax_dense_reference.py): equal QP iterations,
    X, U and the QP's x within JAX_PARITY."""
    jref = np.load(JAX_DENSE_REF)
    prob = presets.build_problem(presets.SOLO12_TROT, dtype=torch.float64,
                                 device="cuda")
    sol, rec = drive("dense/solo12_trot", prob, prob.scp, 1, card,
                     kernels=DARE_ONLY)
    rec["x_err_inf"], rec["u_err_inf"] = ref_errors(sol, N165_REF)
    rec["qp_iters"], rec["refactors"] = lane_stats(sol)
    rec["vs_jax_x"] = float(np.abs(sol.X[0].cpu().numpy() - jref["X"]).max())
    rec["vs_jax_u"] = float(np.abs(sol.U[0].cpu().numpy() - jref["U"]).max())
    print(f"# dense/solo12_trot: against the JAX package's f64 dense solve: "
          f"max|dX| {rec['vs_jax_x']:.3e}, max|dU| {rec['vs_jax_u']:.3e}, "
          f"QP iterations {rec['qp_iters']} (JAX "
          f"{int(jref['scp_qp_iterations'])}), refactors "
          f"{rec['refactors']}; x_err_inf {rec['x_err_inf']:.3e}, u_err_inf "
          f"{rec['u_err_inf']:.3e} against {N165_REF} (data)")
    check(rec["n_success"] == 1, "dense N=165: not solved")
    check(rec["qp_iters"][0] == int(jref["scp_qp_iterations"]),
          f"dense N=165: {rec['qp_iters']} QP iterations, JAX "
          f"{int(jref['scp_qp_iterations'])}")
    check(max(rec["vs_jax_x"], rec["vs_jax_u"]) <= JAX_PARITY,
          f"dense N=165 vs JAX: {rec['vs_jax_x']}, {rec['vs_jax_u']}")

    X0, U0, cfg = scenarios(prob, 1)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X0, U0,
                                   lqr_iters=prob.scp.lqr_iters,
                                   with_covariance=False)
    qp = build_qp(prob.model, prob.plan.schedule, cfg, X0, U0, data,
                  prob.scp.trust_region_radius0, prob.scp.omega0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    qsol = solve_qp(qp, prob.scp.qp)
    end.record()
    torch.cuda.synchronize()
    x = qsol.x[0].cpu().numpy()
    t0 = time.perf_counter()
    res = certify_qp_solution(*(getattr(qp, f)[0].cpu().numpy()
                                for f in "PqAlu"),
                              x, qsol.y[0].cpu().numpy())
    n_xu = 9 * 166 + 12 * 165
    gap = float(np.abs(x[:n_xu] - res.x[:n_xu]).max())
    rec.update(qp_solve_ms=start.elapsed_time(end),
               qp_solve_iters=int(qsol.iterations[0]),
               qp_vs_jax=float(np.abs(x - jref["qp_x"]).max()),
               certify_s=time.perf_counter() - t0,
               stationarity=res.stationarity,
               primal_violation=res.primal_violation,
               comp_slack=res.comp_slack, certified_gap=gap)
    print(f"# dense/solo12_trot certify: QP (n {qp.P.shape[-1]}, m "
          f"{qp.A.shape[-2]}) solved on the card in "
          f"{rec['qp_solve_iters']} iterations (JAX "
          f"{int(jref['qp_iterations'])}), {rec['qp_solve_ms']:.1f} ms (CUDA"
          f" events) [{card}], max|x - x_JAX| {rec['qp_vs_jax']:.3e}; host "
          f"certifier: converged {res.converged} in {res.active_set_iters} "
          f"active-set iterations, stationarity {res.stationarity:.2e}, "
          f"primal violation {res.primal_violation:.2e}, complementary "
          f"slackness {res.comp_slack:.2e} ({rec['certify_s']:.1f} s); "
          f"ADMM-vs-certified X/U gap {gap:.3e} (data; JAX 1.0675e-04)")
    check(bool(qsol.converged[0]), "dense N=165: the certified QP failed")
    check(rec["qp_solve_iters"] == int(jref["qp_iterations"]),
          "dense N=165: the QP's iterations differ from JAX's")
    check(rec["qp_vs_jax"] <= JAX_PARITY,
          f"dense N=165 QP vs JAX: {rec['qp_vs_jax']}")
    check(res.converged, "certifier did not converge")
    check(res.stationarity < 1e-8 and res.primal_violation < 1e-8,
          f"certifier KKT: {res.stationarity}, {res.primal_violation}")
    check(res.comp_slack < 1e-6, f"certifier slackness {res.comp_slack}")
    return rec


def phase_assoc(card):
    """The main path's bench point with sweep_method='assoc' in f32,
    B=32: tridiag_factor factors, the doubling scan sweeps, so the sweep
    kernels stay at 0; QP iterations against a 'scan' run of the same
    batch (data)."""
    qp = dataclasses.replace(QP, sweep_method="assoc")
    prob, scp = problem(presets.SOLO12_TROT_N50, qp=qp)
    sol, rec = drive("assoc", prob, scp, 32, card, profile=True,
                     kernels=("tridiag_factor", "dare_lqr"))
    rec["x_err_inf"], rec["u_err_inf"] = ref_errors(
        sol, os.path.basename(REF_CACHE))
    X0, U0, cfg = scenarios(prob, 32)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    scan = batched_solve(prob.model, prob.plan.schedule, cfg, X0, U0,
                         dataclasses.replace(scp, qp=QP))
    end.record()
    torch.cuda.synchronize()
    rec["scan_wall_ms"] = start.elapsed_time(end)
    rec["scan_mean_qp_iters"] = float(scan.qp_iterations.float().mean())
    rec["assoc_vs_scan_u"] = float((sol.U - scan.U).abs().max())
    print(f"# assoc: scenario 0 x_err_inf {rec['x_err_inf']:.3e}, u_err_inf "
          f"{rec['u_err_inf']:.3e}; mean QP iterations {rec['mean_qp_iters']:.1f}"
          f" ('scan' {rec['scan_mean_qp_iters']:.1f}); max|U_assoc - "
          f"U_scan| {rec['assoc_vs_scan_u']:.3e}; the same batch with 'scan'"
          f" {rec['scan_wall_ms']:.2f} ms (CUDA events, after the 'assoc' "
          f"batch) (data)")
    check(rec["n_success"] == 32, f"assoc: {rec['n_success']}/32")
    check(rec["x_err_inf"] <= PARITY_BAR and rec["u_err_inf"] <= PARITY_BAR,
          f"assoc parity: {rec['x_err_inf']}, {rec['u_err_inf']}")
    return rec


def phase_thomas(card):
    """solo12_trot_n50 with factor_method='thomas', 'always' rho, eps 1e-5
    (tests/test_sweep_backends.py's settings), B=8: in f64 gated against
    a 'cholesky' run of the same batch; in f32 (whose convergence the JAX
    package documents as broken) success and u_err are data.  The Thomas
    factor is plain PyTorch: only the DARE launches a kernel."""
    qp = QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000,
                    adaptive_rho=True, adaptive_rho_mode="always",
                    factor_method="thomas")
    recs = []
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        prob, scp = problem(presets.SOLO12_TROT_N50, qp=qp, dtype=dtype)
        sol, rec = drive(f"thomas/{tag}", prob, scp, 8, card,
                         kernels=DARE_ONLY)
        rec["x_err_inf"], rec["u_err_inf"] = ref_errors(
            sol, os.path.basename(REF_CACHE))
        print(f"# thomas/{tag}: scenario 0 x_err_inf {rec['x_err_inf']:.3e},"
              f" u_err_inf {rec['u_err_inf']:.3e} (data)")
        if dtype == torch.float64:
            X0, U0, cfg = scenarios(prob, 8)
            chol = batched_solve(prob.model, prob.plan.schedule, cfg, X0, U0,
                                 dataclasses.replace(scp, qp=dataclasses.replace(
                                     qp, factor_method="cholesky")))
            rec["vs_cholesky_x"] = float((sol.X - chol.X).abs().max())
            rec["vs_cholesky_u"] = float((sol.U - chol.U).abs().max())
            print(f"# thomas/f64: against 'cholesky' on the same batch: "
                  f"max|dX| {rec['vs_cholesky_x']:.3e}, max|dU| "
                  f"{rec['vs_cholesky_u']:.3e}; mean QP iterations "
                  f"{rec['mean_qp_iters']:.1f} ('cholesky' "
                  f"{float(chol.qp_iterations.float().mean()):.1f})")
            check(rec["n_success"] == 8, f"thomas f64: {rec['n_success']}/8")
            check(rec["vs_cholesky_x"] <= PARITY_BAR
                  and rec["vs_cholesky_u"] <= PARITY_BAR,
                  f"thomas vs cholesky: {rec['vs_cholesky_x']}, "
                  f"{rec['vs_cholesky_u']}")
        recs.append(rec)
    return recs


def phase_exact_backoffs(card):
    """The exact chance back-offs (solver/stochastic.py) on the tiny
    stochastic problem of tests/test_stochastic_exact.py, f64, B=1: the
    jacobians through the DARE kernel's autograd.Function on the card
    against the CPU's, then the exact-mode QP solved by the dense
    solve_qp on the card."""
    gait = gaits.GaitSpec(gaits.TROT, step_length=0.0, step_height=0.05,
                          step_knots=3, support_knots=2, nb_steps=1)
    prob = presets.build_problem(
        dataclasses.replace(presets.SOLO12_TROT, gait=gait), stochastic=True,
        dtype=torch.float64, device="cuda")

    def inputs(p):
        X, U = p.X0[None], p.U0[None]
        return (p.model, p.plan.schedule,
                tile_ocp_config(p.ocp, X[:, 0], X[:, -1], X), X, U)

    card_in = inputs(prob)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    b, jx, ju = backoff_jacobians(*card_in)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    counts = launch_counts()
    cb, cjx, cju = backoff_jacobians(*inputs(_tree.to_device(prob, "cpu")))
    errs = [rel_err(a.cpu(), r) for a, r in ((b, cb), (jx, cjx), (ju, cju))]
    model, schedule, cfg, X, U = card_in
    data = compute_trajectory_data(model, schedule, X, U)
    qp = apply_exact_backoffs(
        build_qp(model, schedule, dataclasses.replace(cfg, stochastic=False),
                 X, U, data, 100.0, 100.0), model, schedule, cfg, X, U)
    qsol = solve_qp(qp, QPSettings(eps_abs=1e-6, eps_rel=1e-6))
    torch.cuda.synchronize()
    rec = dict(path="exact_backoffs", batch=1, horizon=prob.plan.horizon,
               launches=counts, jacobian_s=jac_s, rel_err_b=errs[0],
               rel_err_dX=errs[1], rel_err_dU=errs[2],
               qp_iters=int(qsol.iterations[0]),
               qp_status=int(qsol.status[0]), max_backoff=float(b.max()))
    print(f"# exact_backoffs: N={prob.plan.horizon} B=1 f64: launches "
          f"{counts}; jacobians {tuple(jx.shape)}, {tuple(ju.shape)} in "
          f"{jac_s:.2f} s (host, synced) [{card}]; card vs CPU relative "
          f"to max|.|: b {errs[0]:.2e}, dB/dX {errs[1]:.2e}, dB/dU "
          f"{errs[2]:.2e}; exact-mode QP: status {rec['qp_status']} in "
          f"{rec['qp_iters']} iterations")
    check(float(b.max()) > 1e-6, "exact_backoffs: no active back-off")
    check(max(errs) <= 1e-9, f"exact_backoffs: card vs CPU {errs}")
    check(counts["dare_lqr"] > 0, "exact_backoffs: dare_lqr not launched")
    check(bool(qsol.converged[0]), "exact_backoffs: the QP did not solve")
    return rec


def phase_server(card):
    """cli.mpc_server_main on the card (solo12_trot_n50, dense backend,
    f32): a solver thread publishing 3 solves over the native trajectory
    bus and the 1 kHz control loop; the runtime library is built from the
    repo's runtime/ sources.  Latency, lateness and tracking are data."""
    torch.cuda.synchronize()
    reset_counts()
    stats = cli.mpc_server_main(["--ticks", "1000", "--resolves", "3"])
    counts = launch_counts()
    lib = native.library_path()
    prob = presets.SOLO12_TROT_N50
    want = min(1000, round(prob.horizon * prob.dt / prob.dt_ctrl))
    st = np.array(stats["solve_times_s"]) * 1e3
    err = np.array(stats["track_err"])
    rec = dict(path="server", batch=1, horizon=prob.horizon,
               launches=counts, n_success=sum(stats["successes"]),
               solves=len(st), solve_min_ms=float(st.min()),
               solve_mean_ms=float(st.mean()), ticks=stats["ticks"],
               late_mean_us=stats["mean_late_ns"] / 1e3,
               late_max_us=stats["max_late_ns"] / 1e3,
               track_err_mean=float(err.mean()),
               track_err_final=float(err[-1]))
    print(f"# server: {rec['solves']} solves ({rec['n_success']} "
          f"successful), latency min/mean {rec['solve_min_ms']:.1f}/"
          f"{rec['solve_mean_ms']:.1f} ms (host); {rec['ticks']} ticks, "
          f"wake-up lateness mean/max {rec['late_mean_us']:.1f}/"
          f"{rec['late_max_us']:.1f} us; tracking error mean "
          f"{rec['track_err_mean']:.4f}, final {rec['track_err_final']:.4f}"
          f"; launches {counts}; runtime library "
          f"{os.path.relpath(lib, ROOT)} [{card}]")
    check(stats["device"] == "cuda", "server: not on the card")
    check(rec["solves"] == 3 and rec["n_success"] == 3,
          f"server: {rec['n_success']}/{rec['solves']} solves")
    check(rec["ticks"] == want, f"server: {rec['ticks']} ticks, not {want}")
    check(bool(np.isfinite(err).all()), "server: non-finite tracking")
    check(lib.exists() and lib.is_relative_to(os.path.join(ROOT, "build")),
          "server: the runtime library was not built in the checkout")
    check(counts["dare_lqr"] >= 3, "server: dare_lqr not launched")
    return rec


# ---------------------------------------------------------------------------
# the motion pipeline (pipeline.run_pipeline) and the whole-body DDP
# ---------------------------------------------------------------------------

# the JAX package's float64 run of the f64 phase's call, its 1-step trot
# DDP and its artifact manifest (scripts/jax_pipeline_reference.py)
PIPELINE_REF = os.path.join(ROOT, "tests", "data",
                            "jax_pipeline_solo12_trot_n50.npz")
# card (f64, cuBLAS/cuSOLVER) vs the JAX package's CPU run at equal
# iteration counts; the whole-body DDP's Q, V, TAU relative to their
# largest entry (see phase_pipeline_f64)
PIPELINE_TOL = 1e-6
PIPELINE_SIMS = {torch.float64: 64, torch.float32: 1024}
# the 1-step bolt pace of tests/test_whole_body_biped.py:191-196
BOLT_GAIT = gaits.GaitSpec(gaits.PACE, step_length=0.0, step_height=0.04,
                           step_knots=6, support_knots=3, nb_steps=1)
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")


class StageClock:
    """Host time (synced, by the port's utils/profiling.StageTimer) and
    launches of each stage of run_pipeline, taken by wrapping the
    functions it calls for as long as the `with` lasts; also the DARE step
    count of every `dare_lqr` launch."""

    STAGES = ((pipeline, "ddp_warm_start_solution", "warm start"),
              (pipeline, "_solve", None),
              (pipeline.whole_body, "track_centroidal_solution",
               "kinematic stage 3"),
              (pipeline.wbd, "solve_whole_body_ddp", "DDP stage 3"),
              (pipeline.monte_carlo, "run_monte_carlo", "Monte-Carlo"),
              (pipeline, "compute_trajectory_data", "stage 4b gains"),
              (pipeline.phys, "run_physics_monte_carlo",
               "physics Monte-Carlo"))

    def __init__(self):
        self.timer = StageTimer()
        self.seconds = self.timer.totals
        self.launches, self.dare_steps = {}, []
        self._saved = []

    def _timed(self, fn, name):
        def run(*args, **kw):
            stage = name or ("stochastic SCP" if args[0].ocp.stochastic
                             else "SCP")
            torch.cuda.synchronize()
            before = launch_counts()
            with self.timer.stage(stage):
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            counts = self.launches.setdefault(
                stage, {k: 0 for k in before})
            for k, n in launch_counts().items():
                counts[k] += n - before[k]
            return out
        return run

    def _dare(self, fn):
        def run(Q, R, A, B, n_iter=2):
            self.dare_steps.append(n_iter)
            return fn(Q, R, A, B, n_iter)
        return run

    def __enter__(self):
        for module, attr, name in self.STAGES:
            fn = getattr(module, attr)
            self._saved.append((module, attr, fn))
            setattr(module, attr, self._timed(fn, name))
        self._saved.append((lqr_kernel, "lqr_gain_batched",
                            lqr_kernel.lqr_gain_batched))
        lqr_kernel.lqr_gain_batched = self._dare(lqr_kernel.lqr_gain_batched)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)

    def line(self):
        return ", ".join(f"{k} {v:.2f} s" for k, v in self.seconds.items())


def run_pipeline_timed(dtype, whole_body_mode):
    """run_pipeline on solo12_trot_n50 (stochastic, PIPELINE_SIMS[dtype]
    Monte-Carlo sims) on the card into a fresh store under WORK_DIR, with
    the launch counts zeroed just before and read just after: (result,
    launches, the StageClock, the store's manifest, host seconds)."""
    os.makedirs(WORK_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as root, \
            StageClock() as clock:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(
            presets.SOLO12_TROT_N50, ArtifactStore(root), stochastic=True,
            n_sims=PIPELINE_SIMS[dtype], dtype=dtype,
            whole_body_mode=whole_body_mode)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        manifest = ArtifactStore(root).manifest()
    return res, counts, clock, manifest, seconds


def check_pipeline_launches(path, counts, clock):
    """Both SCP stages run the block backend (all four kernels), the DARE
    at 2 steps (stage 2) and 30 (stage 2'); no other stage launches a
    kernel."""
    for name, n in counts.items():
        check(n > 0, f"{path}: kernel {name} was not launched")
    for stage, launched in clock.launches.items():
        if stage.endswith("SCP"):
            for name, n in launched.items():
                check(n > 0, f"{path}: {stage} launched no {name}")
        else:
            check(not any(launched.values()),
                  f"{path}: {stage} launched {launched}")
    check(set(clock.dare_steps) == {2, 30},
          f"{path}: DARE steps {sorted(set(clock.dare_steps))}")


def phase_ddp_iteration(card):
    """One iteration of the pipeline's whole-body DDP on the card (solo12,
    N=50, f64, targets from the JAX run's nominal SCP solution, which the
    port's equals to ~1e-12): a 1-iteration solve less a 0-iteration solve
    (the same set-up and extraction), each timed by CUDA events, then each
    run under torch.profiler (after both timings: a profiled run slows
    the host-bound launches after it): device launches, device busy ms,
    wall ms, busy share.  Launches none of the four kernels."""
    ref = np.load(PIPELINE_REF)
    prob = presets.build_problem(presets.SOLO12_TROT_N50,
                                 dtype=torch.float64, device="cuda")
    dt_ctrl = presets.SOLO12_TROT_N50.dt_ctrl
    targets = wbd.build_targets(
        prob.plan, compute_swing_trajectories(prob.plan, dt_ctrl), dt_ctrl,
        X_centroidal=ref["nom_X"], U_centroidal=ref["nom_U"])
    spec = rb.solo12_spec()

    def solve(n):
        return lambda: wbd.solve_whole_body_ddp(
            spec, targets, presets.SOLO12_TROT_N50.dt,
            settings=DdpSettings(iterations=n, exact_quu=True))

    solve(0)()              # warm: the set-up's first-call costs
    torch.cuda.synchronize()
    reset_counts()
    wall = {}
    for n in (0, 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        solve(n)()
        end.record()
        torch.cuda.synchronize()
        wall[n] = start.elapsed_time(end)
    counts = launch_counts()
    device = {}
    for n in (0, 1):
        _, per_name, _ = profile_batch(solve(n))
        device[n] = (sum(c for _, c in per_name.values()),
                     sum(us for us, _ in per_name.values()) / 1e3)
    events = device[1][0] - device[0][0]
    busy_ms = device[1][1] - device[0][1]
    wall_ms = wall[1] - wall[0]
    rec = dict(path="pipeline/f64 DDP iteration", batch=1, horizon=50,
               launches=counts, ddp_iteration_launches=events,
               ddp_iteration_busy_ms=busy_ms, ddp_iteration_ms=wall_ms,
               busy_share=busy_ms / wall_ms)
    print(f"# pipeline/f64 DDP iteration: {events} device launches, "
          f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms (busy share "
          f"{busy_ms / wall_ms:.1%}; a 1-iteration solve less a 0-iteration "
          f"solve, CUDA events, then torch.profiler) [{card}]")
    check(events > 0 and busy_ms > 0, "DDP iteration: no device time")
    check(not any(counts.values()), f"DDP iteration: launches {counts}")
    return rec


def phase_pipeline_f64(card):
    """run_pipeline(SOLO12_TROT_N50, store, stochastic=True, n_sims=64,
    dtype=float64, whole_body_mode="ddp") on the card (nq 18, nv 18, 12
    joints, N=50), held to the JAX package's run of the same call
    (PIPELINE_REF) at equal iteration counts: stage 1 (iLQR), stage 2
    and 2' (SCP and QP iterations), the kinematic stage 3, the whole-body
    DDP (iterations; cost 1e-8 relative; Q, V, TAU within PIPELINE_TOL of
    their largest entry: the DDP stops at its 60-iteration cap in a flat
    valley where, from its ~45th iteration, an accepted step lowers the
    cost by ~1e-12, the acceptance threshold, so a round-off-sized merit
    difference can accept one more step of ~1e-7; the cost agrees to
    ~1e-14), the artifact files, keys and shapes.  Prints each stage's
    host time (one DDP iteration's launches: phase_ddp_iteration)."""
    ref = np.load(PIPELINE_REF)
    res, counts, clock, manifest, seconds = run_pipeline_timed(
        torch.float64, "ddp")
    wb = res.wb_ddp

    def err(a, key):
        return float(np.abs(a.detach().cpu().numpy() - ref[key]).max())

    errs = {"warm X": err(res.warm_X, "warm_X"),
            "warm U": err(res.warm_U, "warm_U")}
    iters = {"warm": (res.warm_ddp.iterations, int(ref["warm_iterations"])),
             "DDP": (wb.iterations, int(ref["wb_iterations"]))}
    for stage, key in (("nominal", "nom"), ("stochastic", "sto")):
        sol = getattr(res, stage)
        errs[f"{stage} X"] = err(sol.X[0], f"{key}_X")
        errs[f"{stage} U"] = err(sol.U[0], f"{key}_U")
        iters[f"{stage} SCP"] = (int(sol.iterations[0]),
                                 int(ref[f"{key}_iterations"]))
        iters[f"{stage} QP"] = (int(sol.qp_iterations[0]),
                                int(ref[f"{key}_qp_iterations"]))
    for f in ("q", "qdot", "tau_ff"):
        errs[f"kinematic {f}"] = err(getattr(res.wb_traj, f), f"kin_{f}")
    ddp_rel = {f: err(getattr(wb, f), f"wb_{f}")
               / float(np.abs(ref[f"wb_{f}"]).max())
               for f in ("Q", "V", "TAU")}
    cost_rel = abs(float(wb.cost) - float(ref["wb_cost"])) / float(
        ref["wb_cost"])
    stats_finite = all(np.isfinite(v).all() for v in res.eval_stats.values())
    manifest_ok = manifest == json.loads(str(ref["manifest"]))
    print(f"# pipeline/f64: solo12_trot_n50 N=50 f64, whole-body DDP "
          f"(nq {rb.solo12_spec().nq}, nv {rb.solo12_spec().nv}), 64 sims: "
          f"{seconds:.2f} s (host, synced); stages: {clock.line()}; "
          f"launches {counts}, by stage {clock.launches}; DARE steps "
          f"{clock.dare_steps} [{card}]")
    print(f"# pipeline/f64: iterations (card, JAX): {iters}; max abs err "
          f"vs JAX: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; DDP Q/V/TAU err / max|.|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in ddp_rel.items())
          + f", cost rel {cost_rel:.3e}; artifacts as the JAX run's: "
          f"{manifest_ok}; Monte-Carlo stats finite: {stats_finite}")
    print(f"# pipeline/f64: the whole-body DDP: {wb.iterations} iterations "
          f"in {clock.seconds['DDP stage 3']:.2f} s (host, synced) [{card}]")
    rec = dict(path="pipeline/f64", batch=1, horizon=50, launches=counts,
               n_success=int(res.nominal.success[0])
               + int(res.stochastic.success[0]), seconds=seconds,
               stage_s=dict(clock.seconds), iterations=iters, errors=errs,
               ddp_rel=ddp_rel, ddp_cost_rel=cost_rel)
    check_pipeline_launches("pipeline/f64", counts, clock)
    for k, (a, b) in iters.items():
        check(a == b, f"pipeline/f64: {k} iterations {a} != JAX {b}")
    for k, v in errs.items():
        check(v <= PIPELINE_TOL, f"pipeline/f64: {k} err {v:.3e}")
    for k, v in ddp_rel.items():
        check(v <= PIPELINE_TOL, f"pipeline/f64: DDP {k} rel err {v:.3e}")
    check(cost_rel <= 1e-8, f"pipeline/f64: DDP cost rel {cost_rel:.3e}")
    check(manifest_ok, f"pipeline/f64: artifacts {manifest}")
    check(stats_finite, "pipeline/f64: non-finite Monte-Carlo stats")
    check(wb.Q.device.type == "cuda" and res.warm_X.device.type == "cuda",
          "pipeline/f64: not on the card")
    return rec


def phase_pipeline_f32(card):
    """The user default: run_pipeline(SOLO12_TROT_N50, store,
    stochastic=True, n_sims=1024) in float32 with the kinematic stage 3
    on the card.  Gates: both SCP stages solved, the JAX run's artifact
    files written (the kinematic layout of wholeBody_interpolated_traj),
    the warm start a rollout of itself (gap <= 1e-4 of max|X|); the
    nominal's error against the JAX f64 run is data."""
    ref = np.load(PIPELINE_REF)
    res, counts, clock, manifest, seconds = run_pipeline_timed(
        torch.float32, "kinematic")
    prob = res.problem
    X_roll = rollout(prob.model, prob.plan.schedule, res.warm_X[0],
                     res.warm_U)
    gap = float((X_roll - res.warm_X).abs().max()
                / res.warm_X.abs().max())
    u_err = float(np.abs(res.nominal.U[0].double().cpu().numpy()
                         - ref["nom_U"]).max())
    x_err = float(np.abs(res.nominal.X[0].double().cpu().numpy()
                         - ref["nom_X"]).max())
    files = set(json.loads(str(ref["manifest"])))
    wb_keys = manifest.get("wholeBody_interpolated_traj.npz", {})
    stats_finite = all(np.isfinite(v).all() for v in res.eval_stats.values())
    print(f"# pipeline/f32: solo12_trot_n50 N=50 f32, kinematic stage 3, "
          f"1024 sims: {seconds:.2f} s (host, synced); stages: "
          f"{clock.line()}; launches {counts}, by stage {clock.launches}; "
          f"DARE steps {clock.dare_steps}; success nominal "
          f"{bool(res.nominal.success[0])} ({int(res.nominal.qp_iterations[0])}"
          f" QP iterations), stochastic {bool(res.stochastic.success[0])} "
          f"({int(res.stochastic.qp_iterations[0])}); warm start iLQR "
          f"{res.warm_ddp.iterations} iterations, rollout gap {gap:.2e} of "
          f"max|X|; nominal vs the JAX f64 run (data): u_err {u_err:.3e}, "
          f"x_err {x_err:.3e} [{card}]")
    rec = dict(path="pipeline/f32", batch=1, horizon=50, launches=counts,
               n_success=int(res.nominal.success[0])
               + int(res.stochastic.success[0]), seconds=seconds,
               stage_s=dict(clock.seconds), warm_gap=gap, u_err=u_err,
               x_err=x_err)
    check_pipeline_launches("pipeline/f32", counts, clock)
    check(bool(res.nominal.success[0]), "pipeline/f32: nominal failed")
    check(bool(res.stochastic.success[0]), "pipeline/f32: stochastic failed")
    check(set(manifest) == files, f"pipeline/f32: files {sorted(manifest)}")
    check(set(wb_keys) == {"X", "U", "q", "qdot", "tau", "gains"},
          f"pipeline/f32: wholeBody_interpolated_traj keys {wb_keys}")
    check(gap <= 1e-4, f"pipeline/f32: warm start rollout gap {gap:.2e}")
    check(stats_finite, "pipeline/f32: non-finite Monte-Carlo stats")
    return rec


def phase_whole_body_bolt(card):
    """solve_whole_body_ddp on the card for the 1-step bolt pace of
    tests/test_whole_body_biped.py:191-196 (f64, dt 0.01, 30 iterations,
    exact Quu; V = 12 and a biped's KKT), with that test's gates: stance
    feet within 0.02 and the CoM height within 0.05 of their targets.  No
    kernel runs on this path."""
    plan = build_contact_plan(BOLT, BOLT_GAIT, 0.01, dtype=torch.float64,
                              device="cuda")
    targets = wbd.build_targets(plan, compute_swing_trajectories(plan, 0.001),
                                0.001)
    spec = rb.bolt_spec()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sol = wbd.solve_whole_body_ddp(
        spec, targets, 0.01, settings=DdpSettings(iterations=30,
                                                  exact_quu=True))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    mask = targets.contact_mask[:, :, None]
    err = (sol.feet[:-1] - targets.foot_target).abs()
    stance_err = float((err * mask).max())
    com_z_err = float((sol.com[:, 2] - targets.com_target[:, 2]).abs().max())
    ds = targets.contact_mask.sum(1) == 2
    fz = float(sol.forces[ds][:, :, 2].sum(1).mean())
    rec = dict(path="whole_body_ddp/bolt", batch=1, horizon=plan.horizon,
               launches=counts, iterations=sol.iterations, seconds=seconds,
               cost=float(sol.cost), stance_err=stance_err,
               com_z_err=com_z_err)
    print(f"# whole_body_ddp/bolt: N={plan.horizon} f64, nv {spec.nv}: "
          f"{sol.iterations} iterations, cost {float(sol.cost):.6g}, "
          f"{seconds:.2f} s (host, synced); stance err {stance_err:.2e}, "
          f"CoM z err {com_z_err:.2e}, double-support fz {fz:.2f} N "
          f"(weight {spec.total_mass * rb.GRAVITY:.2f} N); launches "
          f"{counts} [{card}]")
    check(sol.Q.device.type == "cuda", "whole_body_ddp/bolt: not on the card")
    check(bool(torch.isfinite(sol.Q).all()), "whole_body_ddp/bolt: non-finite")
    check(stance_err < 0.02, f"whole_body_ddp/bolt: stance {stance_err}")
    check(com_z_err < 0.05, f"whole_body_ddp/bolt: CoM z {com_z_err}")
    check(not any(counts.values()), f"whole_body_ddp/bolt: launches {counts}")
    return rec


# the JAX package's float64 plant on solo12_trot_n50's nominal plan and
# the file manifests of its run-motion CLI (scripts/jax_physics_reference.py)
PHYSICS_REF = os.path.join(ROOT, "tests", "data",
                           "jax_physics_solo12_trot_n50.npz")
# card vs the JAX package's CPU run, relative to max|.|: the first
# PHYSICS_WINDOW steps at PHYSICS_STEP_TOL, the whole episode and the
# statistics at PHYSICS_EPISODE_TOL, the tolerances of
# tests/test_torch_physics.py (the friction anchors switch discretely, so
# round-off can part two runs late in an episode; on this plan the port's
# CPU run stays within 1.1e-12 of max|.| over all 500 steps)
PHYSICS_WINDOW = 200
PHYSICS_STEP_TOL = 1e-9
PHYSICS_EPISODE_TOL = 1e-4
# run-motion's physics episodes (the CLI's --physics-sims 64)
RUN_MOTION_SIMS = 64
PROFILE_STEPS = 50      # the plant's profiled window


def physics_refs(device, dtype):
    """(references, x0, push forces, push starts, push length) of the
    committed JAX plant run on `device` in `dtype`."""
    ref = np.load(PHYSICS_REF)
    refs = convert.from_numpy(
        phys.ClosedLoopReferences,
        {k[len("refs_"):]: ref[k] for k in ref.files
         if k.startswith("refs_")}, device, dtype)
    return (refs, convert.to_tensor(ref["x0"], device, dtype),
            convert.to_tensor(ref["push_force"], device, dtype),
            convert.to_tensor(ref["push_start"], device),
            int(ref["push_len"]), ref)


def parting_steps(got, want, tol):
    """The first step of each episode where |got - want| passes tol (-1:
    none)."""
    err = np.abs(got - want).reshape(got.shape[0], got.shape[1], -1).max(-1)
    return [int(np.argmax(e > tol)) if (e > tol).any() else -1 for e in err]


def phase_physics(card):
    """sim/physics.simulate_episode on the card for four episodes of
    solo12_trot_n50's plan (500 steps at 1 kHz, nq 18, nv 18, f64; two
    unpushed, two pushed), from the JAX package's references and pushes
    (PHYSICS_REF), held to the JAX package's episodes step by step (h,
    feet, rpy) and to its statistics (foot_slippage, tracking_cost at the
    end, fell).  Launches none of the four kernels."""
    spec = rb.solo12_spec()
    refs, x0, forces, starts, push_len, ref = physics_refs(
        "cuda", torch.float64)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    h, feet, rpy = phys.simulate_episode(spec, refs, x0, forces, starts,
                                         push_len)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    res = phys.PhysicsSimResult(
        h=h, feet=feet, base_rpy=rpy, fell=h[..., 2].amin(-1) < 0.5 * x0[2],
        push_force=forces, push_start=starts)
    steps = h.shape[1]
    window, whole, parting = {}, {}, {}
    for name, got in (("h", h), ("feet", feet), ("rpy", rpy)):
        got, want = got.cpu().numpy(), ref[name]
        scale = float(np.abs(want).max())
        err = np.abs(got - want)
        window[name] = float(err[:, :PHYSICS_WINDOW].max()) / scale
        whole[name] = float(err.max()) / scale
        parting[name] = parting_steps(got, want, PHYSICS_STEP_TOL * scale)
    slip = phys.foot_slippage(res, refs).cpu().numpy()
    cost = phys.tracking_cost(res, refs)[:, -1].cpu().numpy()
    fell = res.fell.cpu().numpy()
    slip_rel = float(np.abs(slip - ref["slippage"]).max()
                     / np.abs(ref["slippage"]).max())
    cost_rel = float(np.abs(cost - ref["cum_cost"]).max()
                     / np.abs(ref["cum_cost"]).max())
    rec = dict(path="physics/solo12_trot_n50", batch=4, steps=steps,
               launches=counts, seconds=seconds,
               ms_per_step=seconds / steps * 1e3, window_rel=window,
               episode_rel=whole, parting=parting, slippage_rel=slip_rel,
               cum_cost_rel=cost_rel)
    print(f"# physics/solo12_trot_n50: 4 episodes x {steps} steps at 1 kHz "
          f"(nq {spec.nq}, nv {spec.nv}, f64): {seconds:.2f} s (host, "
          f"synced), {seconds / steps * 1e3:.2f} ms a step; launches "
          f"{counts} [{card}]")
    print("# physics/solo12_trot_n50: err / max|.| vs JAX, first "
          f"{PHYSICS_WINDOW} steps: "
          + ", ".join(f"{k} {v:.3e}" for k, v in window.items())
          + "; whole episode: "
          + ", ".join(f"{k} {v:.3e}" for k, v in whole.items())
          + f"; first step past {PHYSICS_STEP_TOL} of max (-1: none): "
          f"{parting}; slippage {slip} (JAX {ref['slippage']}, rel "
          f"{slip_rel:.3e}); cum cost rel {cost_rel:.3e}; fell {fell} "
          f"(JAX {ref['fell']})")
    check(h.device.type == "cuda" and bool(torch.isfinite(h).all()),
          "physics: not on the card or non-finite")
    for k in window:
        check(window[k] <= PHYSICS_STEP_TOL,
              f"physics: {k} err {window[k]:.3e} in the first "
              f"{PHYSICS_WINDOW} steps (parting at {parting[k]})")
        check(whole[k] <= PHYSICS_EPISODE_TOL,
              f"physics: {k} err {whole[k]:.3e} over the episode")
    check(slip_rel <= PHYSICS_EPISODE_TOL and cost_rel <= PHYSICS_EPISODE_TOL,
          f"physics: slippage rel {slip_rel:.3e}, cost rel {cost_rel:.3e}")
    check((fell == ref["fell"]).all(), f"physics: fell {fell}")
    check(not any(counts.values()), f"physics: launches {counts}")
    return rec


def phase_run_motion(card):
    """What `run-motion --preset solo12_trot --sims 16 --physics-sims 64
    --terrain debris` does on the device, on the card (f32, N=165,
    kinematic stage 3, the plant's 64 episodes of 1,650 steps on the trot
    stepstones): its run_pipeline call and HTML preview.  Its figures are
    left out: they are host-side matplotlib work, and the card's machine
    has no matplotlib (the CPU tests draw them).  Gates: both SCP stages
    solved; the nominal and stochastic SCP launch all four kernels, stage
    4b's gains one DARE, no other stage any; the DARE at 2 and 30 steps;
    the plant's tensors on the card and finite; the JAX stage-4b shapes;
    slippage >= 0; the cumulative cost non-decreasing; the files, npz
    keys and shapes of the JAX CLI's run of the same command
    (PHYSICS_REF) but its figures."""
    preset = presets.SOLO12_TROT
    os.makedirs(WORK_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as root, \
            StageClock() as clock:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        store = ArtifactStore(root)
        res = pipeline.run_pipeline(
            preset, store, n_sims=16, physics_sims=RUN_MOTION_SIMS,
            terrain=DEBRIS_BY_GAIT[preset.gait.gait_type])
        write_motion_preview(res, preset, root)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        manifest = store.manifest()
    want = {k: v for k, v in json.loads(str(np.load(PHYSICS_REF)[
        "manifest_solo12_trot"])).items() if not k.endswith(".png")}
    mc, refs, stats = res.mc_physics, res.physics_refs, res.eval_stats
    steps = refs.q_des.shape[0]
    shapes = {k: stats[k].shape for k in (
        "physics_slippage", "physics_slippage_series", "physics_cum_cost",
        "physics_fell")}
    cost = phys.tracking_cost(mc, refs)
    rise = float((cost[:, 1:] - cost[:, :-1]).min())
    plant_s = clock.seconds["physics Monte-Carlo"]
    fell = int(stats["physics_fell"].sum())
    rec = dict(path="run_motion/solo12_trot", batch=1, horizon=preset.horizon,
               launches=counts, seconds=seconds, stage_s=dict(clock.seconds),
               physics_episodes=RUN_MOTION_SIMS, physics_steps=steps,
               physics_ms_per_step=plant_s / steps * 1e3, fell=fell)
    print(f"# run_motion/solo12_trot: run_pipeline + write_motion_preview, "
          f"N={preset.horizon} f32, 16 sims, {RUN_MOTION_SIMS} physics "
          f"episodes x {steps} steps on the trot debris: {seconds:.2f} s "
          f"(host, synced); stages: {clock.line()}; the plant "
          f"{plant_s / steps * 1e3:.2f} ms a step; launches {counts}, by "
          f"stage {clock.launches}; DARE steps {clock.dare_steps} [{card}]")
    print(f"# run_motion/solo12_trot: nominal "
          f"{bool(res.nominal.success[0])} "
          f"({int(res.nominal.qp_iterations[0])} QP iterations), stochastic "
          f"{bool(res.stochastic.success[0])} "
          f"({int(res.stochastic.qp_iterations[0])}); physics stats "
          f"{shapes}; fell {fell}/{RUN_MOTION_SIMS} (data); slippage mean "
          f"{float(stats['physics_slippage'].mean()):.3f} m, min "
          f"{float(stats['physics_slippage'].min()):.3e}; cum cost mean "
          f"{float(stats['physics_cum_cost'].mean()):.2f}, least step "
          f"{rise:.3e}; files as the JAX CLI's: {manifest == want}")
    check(bool(res.nominal.success[0]), "run_motion: nominal failed")
    check(bool(res.stochastic.success[0]), "run_motion: stochastic failed")
    for stage, launched in clock.launches.items():
        if stage.endswith("SCP"):
            for name, n in launched.items():
                check(n > 0, f"run_motion: {stage} launched no {name}")
        elif stage == "stage 4b gains":
            check(launched == {**{k: 0 for k in launched}, "dare_lqr": 1},
                  f"run_motion: stage 4b launched {launched}")
        else:
            check(not any(launched.values()),
                  f"run_motion: {stage} launched {launched}")
    check(counts["dare_lqr"] == 3 and sorted(clock.dare_steps) == [2, 2, 30],
          f"run_motion: DARE launches {counts['dare_lqr']}, steps "
          f"{clock.dare_steps}")
    check(all(n > 0 for n in counts.values()),
          f"run_motion: launches {counts}")
    check(mc.h.device.type == "cuda" and all(
        bool(torch.isfinite(t).all()) for t in (mc.h, mc.feet, mc.base_rpy)),
          "run_motion: the plant is not on the card or not finite")
    check(steps == 1650 and shapes == {
        "physics_slippage": (64,), "physics_slippage_series": (64, 1649),
        "physics_cum_cost": (64,), "physics_fell": (64,)},
          f"run_motion: {steps} steps, shapes {shapes}")
    check(float(stats["physics_slippage"].min()) >= 0.0,
          "run_motion: negative slippage")
    check(rise >= -1e-6 * float(cost.abs().max()),
          f"run_motion: the cumulative cost falls by {rise}")
    check(manifest == want, f"run_motion: files {manifest}")
    return rec


def phase_run_motion_profile(card):
    """Device time of the four kernels on run-motion's shapes, and the
    plant's launches a step and busy share.  (1) solo12_trot on the trot
    debris (N=165, B=1, f32 at the pipeline's f32 settings, block
    backend, from the analytic warm start): the nominal SCP (DARE at 2
    steps), the stochastic SCP (30 steps) and stage 4b's gains
    (compute_trajectory_data, 2 steps), each run once and then once under
    torch.profiler: each kernel's device ms a call.  (2) PROFILE_STEPS
    plant steps of RUN_MOTION_SIMS episodes in f32 (the committed solo12
    references; a step does the same work on any plan), timed by CUDA
    events, then under torch.profiler: device launches a step, busy
    share.  Runs last: a profiled run slows the host-bound launches after
    it."""
    preset = presets.SOLO12_TROT
    terrain = DEBRIS_BY_GAIT[preset.gait.gait_type]
    recs = []

    def built(**kw):
        prob = presets.build_problem(preset, dtype=torch.float32,
                                     qp=pipeline.F32_QP, terrain=terrain,
                                     device="cuda", **kw)
        return dataclasses.replace(prob, scp=dataclasses.replace(
            prob.scp, qp_backend="block"))

    prob, prob_s = built(), built(stochastic=True)
    sched = prob.plan.schedule
    runs = (("SCP", lambda: pipeline._solve(prob, prob.scp)),
            ("stochastic SCP", lambda: pipeline._solve(
                prob_s, dataclasses.replace(prob_s.scp, lqr_iters=30))),
            ("stage 4b gains", lambda: compute_trajectory_data(
                prob.model, sched, prob.X0, prob.U0)))
    for stage, run in runs:
        run()
        _, per_name, calls = profile_batch(run)
        per_call = {}
        for name in REPLACES:
            ms, _ = kernel_device_ms(per_name, name)
            if calls[name]:
                per_call[name] = ms / calls[name]
        recs.append(dict(path=f"run_motion {stage} profile", batch=1,
                         horizon=preset.horizon, launches=calls,
                         kernel_ms_per_call=per_call))
        print(f"# run_motion {stage} profile: N={preset.horizon} B=1 f32: "
              f"calls {calls}; device ms a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in per_call.items())
              + f" [{card}]")
        check(calls["dare_lqr"] == 1, f"run_motion {stage}: DARE {calls}")

    spec = rb.solo12_spec()
    refs, x0, _, _, push_len, _ = physics_refs("cuda", torch.float32)
    refs = dataclasses.replace(refs, **{
        f: getattr(refs, f)[:PROFILE_STEPS] for f in (
            "q_des", "qd_des", "tau_ff", "h_des", "K_lqr", "logic")})
    gen = torch.Generator(x0.device).manual_seed(SEED)
    forces = 15.0 ** 0.5 * torch.randn((RUN_MOTION_SIMS, 3), generator=gen,
                                       device=x0.device)
    starts = torch.zeros(RUN_MOTION_SIMS, dtype=torch.long, device=x0.device)

    def window():
        phys.simulate_episode(spec, refs, x0, forces, starts, push_len)

    window()                 # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    window()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    _, per_name, calls = profile_batch(window)
    events = sum(n for _, n in per_name.values())
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    recs.append(dict(path="physics step window", batch=RUN_MOTION_SIMS,
                     steps=PROFILE_STEPS, launches=calls,
                     launches_per_step=events / PROFILE_STEPS,
                     ms_per_step=wall_ms / PROFILE_STEPS, busy_ms=busy_ms,
                     busy_share=busy_ms / wall_ms))
    print(f"# physics step window: {RUN_MOTION_SIMS} episodes x "
          f"{PROFILE_STEPS} steps, f32: {events / PROFILE_STEPS:.0f} device "
          f"launches a step, {wall_ms / PROFILE_STEPS:.3f} ms a step (CUDA "
          f"events), device busy {busy_ms:.2f} of {wall_ms:.2f} ms (busy "
          f"share {busy_ms / wall_ms:.1%}) [{card}]")
    for k, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:4]:
        print(f"#   physics profile top: {us / 1e3:8.3f} ms {n:6d}x "
              f"{k[:80]}")
    check(events > 0 and busy_ms > 0, "physics profile: no device time")
    check(not any(calls.values()), f"physics profile: launches {calls}")
    return recs


# run right after the kernel checks, before the main path's profile: the
# whole-body DDP and the plant are host-bound, and the DDP's launches ran
# ~1.3x slower after a torch.profiler session on an H100 (PERF.md
# section 5)
WHOLE_BODY_PATHS = (phase_pipeline_f64, phase_pipeline_f32,
                    phase_whole_body_bolt, phase_physics, phase_run_motion)
PATHS = (phase_stochastic, phase_stochastic_stage, phase_presets,
         phase_cond, phase_terrain, phase_mpc, phase_dense_n50,
         phase_dense_n165, phase_assoc, phase_thomas, phase_exact_backoffs,
         phase_server)
# the profiled windows of the host-bound paths come last
LAST_PATHS = (phase_ddp_iteration, phase_run_motion_profile)
# the overall deadline (s): the chip run's limit is 1,200 s
DEADLINE_S = 1080.0


def phase_name(fn):
    return fn.__name__[len("phase_"):]


PHASE_NAMES = ([phase_name(p) for p in WHOLE_BODY_PATHS + PATHS]
               + ["monte_carlo", "sharded"]
               + [phase_name(p) for p in LAST_PATHS])


class Deadline:
    """The overall deadline: when it passes, whether a phase is running or
    not, print `# DEADLINE` with the phase running and those not reached
    and end the process with exit code 4, before any result line."""

    def __init__(self, seconds, phases):
        self.t0 = time.perf_counter()
        self.seconds = seconds
        self.pending = list(phases)
        self.running = "build and kernel checks"
        self._timer = threading.Timer(seconds, self._expire)
        self._timer.daemon = True
        self._timer.start()

    def start(self, name):
        if name in self.pending:
            self.pending.remove(name)
        self.running = name

    def _expire(self):
        print(f"# DEADLINE: {self.seconds:.0f} s passed in "
              f"{self.running!r}; phases not reached: {self.pending}",
              flush=True)
        for p in SPAWNED:
            p.kill()
        sys.stderr.flush()
        os._exit(4)

    def cancel(self):
        self._timer.cancel()


def run_paths(phases, records, failed, deadline):
    """Run (name, phase) pairs, each timed; a failed gate is recorded and
    the remaining paths still run."""
    for name, phase in phases:
        deadline.start(name)
        t0 = time.perf_counter()
        try:
            out = phase()
            records.extend(out if isinstance(out, list) else [out])
        except Exception as e:  # noqa: BLE001 -- re-raised by main
            failed.append(f"{name}: {type(e).__name__}: {e}")
            print(f"# FAILED {failed[-1]}")
        print(f"# {name}: {time.perf_counter() - t0:.1f} s")


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description="Build the port's kernels, check each against its "
        "plain version, drive the main path, then the named phases (all "
        "when none is named).")
    ap.add_argument("phases", nargs="*", metavar="phase",
                    help="one of: " + ", ".join(PHASE_NAMES))
    ap.add_argument("--deadline", type=float, default=DEADLINE_S,
                    help="seconds until the script stops, reports the "
                    "phases it did not reach and exits 4 without a result "
                    f"(default {DEADLINE_S:.0f})")
    args = ap.parse_args(argv)
    unknown = set(args.phases) - set(PHASE_NAMES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    return args


def main(argv=None):
    args = parse_args(argv)
    chosen = [n for n in PHASE_NAMES if not args.phases or n in args.phases]
    deadline = Deadline(args.deadline, ["main"] + chosen)
    t0 = time.perf_counter()
    card = phase_environment()
    phase_build()
    results = phase_kernels()
    print(f"# environment, build and kernels: "
          f"{time.perf_counter() - t0:.1f} s")

    def selected(paths):
        return [(phase_name(p), lambda p=p: p(card)) for p in paths
                if phase_name(p) in chosen]

    # every path has its own gates; a failed gate fails the script after
    # the remaining paths have run
    records, failed = [], []
    run_paths(selected(WHOLE_BODY_PATHS), records, failed, deadline)
    deadline.start("main")
    t0 = time.perf_counter()
    counts, solve, batch_ms, main_solution = phase_slice(card)
    in_path = phase_profile(solve, batch_ms)
    print(f"# main path and its profile: {time.perf_counter() - t0:.1f} s")
    for name, r in results.items():
        # cold reads its inputs from HBM; a warm repeat finds those that
        # fit in the 50 MB L2, so its share is not one of the HBM bound
        path = r["bound_ms"] / in_path[name] if in_path[name] else 0.0
        print(f"# share of bound {name}: {r['bound_ms'] / r['cold_ms']:.1%}"
              f" cold, {path:.1%} in the batch, "
              f"{r['bound_ms'] / r['ms']:.1%} warm (from L2)")
    phases = selected(PATHS)
    prob, scp, sol = main_solution
    if "monte_carlo" in chosen:
        phases.append(("monte_carlo",
                       lambda: phase_monte_carlo(card, prob, sol)))
    if "sharded" in chosen:
        phases.append(("sharded",
                       lambda: phase_sharded(card, prob, scp, sol)))
    run_paths(phases + selected(LAST_PATHS), records, failed, deadline)
    deadline.cancel()
    # the Monte-Carlo rollout launches no kernel: no launches entry
    by_path = {"main": counts, **{r["path"]: r["launches"] for r in records
                                  if "launches" in r}}
    if failed:
        raise SystemExit("chip_smoke: failed: " + "; ".join(failed))
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **results[name], path_ms=in_path[name],
                    launches_by_path={p: c[name] for p, c in by_path.items()},
                    library_note=LIBRARY_NOTE[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main(sys.argv[1:])
    print(f"# total {time.perf_counter() - t0:.1f} s", file=sys.stderr)
