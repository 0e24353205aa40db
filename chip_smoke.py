"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit;
     fails when no CUDA device is present (there is no CPU fallback);
  2. build: compiles the hand-written kernels (centroidal_mpc_tpu_torch/
     csrc/*.cu) with nvcc for sm_90a;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the small bench shape, the main path's shapes, a horizon that
     wraps the sweeps' ring (N=165) and a batch of more than one wave
     (B=300); the factor's two launches (chain, couplings) also each
     alone; the DARE gains on the real linearizations of solo12_trot_n50
     (nu 12) and bolt_pace (nu 6) over 128 scenarios, at 2 steps (the
     main path's) and 30 (the stochastic stage's); CUDA-event times of
     kernel and plain version, warm and with L2 flushed, beside the bound
     computed from the bytes and operations of the launch;
  4. the slice: 128 solo12_trot_n50 SCP problems in float32 through
     parallel.batch.batched_solve (block backend, frozen linearization,
     power-iteration trust norm, fixed-rho block ADMM with its refinement
     polish), checked for success on every lane, for launches of every
     kernel, and against the committed float64 reference solution; then
     one more batch under torch.profiler: device time per kernel name and
     the device's busy share.

Output: a JSON line of per-kernel results, the nvidia-smi name/power-limit
line, and as the last line {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.models.centroidal import linearize_step
from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import cuda_lib
from centroidal_mpc_tpu_torch.ops import lqr_kernel
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)
from centroidal_mpc_tpu_torch.solver.scp import set_fp32_exact

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_CACHE = os.path.join(ROOT, "benchmarks", "ref_cache",
                         "solo12_trot_n50_1dbb8aa1aab5.npz")
BATCH = 128
SEED = 0
KERNEL_RTOL = 1e-4      # f32 kernel vs plain, relative to the plain max
PARITY_BAR = 1e-4       # u_err_inf / x_err_inf vs the f64 reference
# kernel-vs-plain shapes (B, N, V): the bench's kernel_exact shape, the
# main path's, a horizon that wraps the sweeps' ring, more than one wave
KERNEL_SHAPES = [(32, 8, 22), (BATCH, 50, 22), (4, 165, 22), (300, 50, 22)]
# DARE steps: the main path's, then the stochastic stage's
# (centroidal_mpc_tpu/pipeline.py:55, stochastic_lqr_iters)
DARE_ITERS = (2, 30)
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
    results = {}
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

    results["dare_lqr"] = phase_dare()
    for name, r in results.items():
        print(f"# time {name}: kernel {r['ms']:.4f} ms warm, "
              f"{r['cold_ms']:.4f} ms cold, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['layout_bound_ms']:.4f} ms for the bytes of the whole "
              f"tensors)")
    return results


def dare_inputs(preset):
    """Q, R and the (A, B) pairs of a preset's real linearization at the
    BATCH scenarios' warm starts, f32 on the card: S = BATCH * N."""
    prob = presets.build_problem(preset, dtype=torch.float32, device="cuda")
    X0, U0, _ = scenarios(prob)
    sched = prob.plan.schedule
    pos = sched.positions_flat().reshape(sched.horizon, sched.n_contacts, 3)
    _, A, Bm, _ = linearize_step(prob.model, X0[:, :-1], U0, pos,
                                 sched.logic, sched.orientation)
    nu = prob.model.n_u
    return (prob.model.Q, prob.model.R, A.reshape(-1, 9, 9).contiguous(),
            Bm.reshape(-1, 9, nu).contiguous())


def phase_dare():
    """dare_lqr against its plain version on solo12_trot_n50 (nu 12) and
    bolt_pace (nu 6) at DARE_ITERS steps; timed on solo12 at both."""
    inputs = {p.name: dare_inputs(p)
              for p in (presets.SOLO12_TROT_N50, presets.BOLT_PACE)}
    max_abs = None
    for name, args in inputs.items():
        for n_iter in DARE_ITERS:
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
    Q, R, A, Bm = inputs[presets.SOLO12_TROT_N50.name]
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
    return dict(max_abs_err=max_abs, **runs[DARE_ITERS[0]],
                **{k + tag: r[k] for k in ("ms", "cold_ms", "plain_ms",
                                           "bound_ms")})


def scenarios(prob):
    """Scenario 0 unperturbed; the others get 0.005 N(0,1) on CoM x, y
    over the whole warm-start trajectory (bench.py:239-257)."""
    rng = np.random.default_rng(SEED)
    dx = np.zeros((BATCH, 9))
    dx[1:, :2] = 0.005 * rng.standard_normal((BATCH - 1, 2))
    dx = torch.as_tensor(dx, dtype=prob.X0.dtype, device=prob.X0.device)
    X0 = prob.X0[None] + dx[:, None, :]
    U0 = prob.U0.expand((BATCH,) + prob.U0.shape)
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
    return counts, solve


def phase_profile(solve):
    """One more main-path batch under torch.profiler: device time by
    kernel name and the device's busy share of the batch's CUDA-event
    time.  Returns each of the port's kernels' mean device ms per wrapper
    call in the path (the factor's two launches summed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        solve()
        end.record()
        torch.cuda.synchronize()
    calls = launch_counts()
    batch_ms = start.elapsed_time(end)
    per_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = per_name.get(ev.name, (0.0, 0))
            per_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    print(f"# profile: batch {batch_ms:.2f} ms under the profiler, device "
          f"busy {busy_ms:.2f} ms ({busy_ms / batch_ms:.1%}), "
          f"{sum(n for _, n in per_name.values())} device events")
    check(busy_ms > 0, "the profiler saw no device time")
    in_path = {}
    for name in REPLACES:
        us = 0.0
        for kernel in DEVICE_KERNELS[name]:
            hits = [v for k, v in per_name.items() if kernel in k]
            k_us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
            check(n > 0, f"the profiler saw no {kernel} in the batch")
            print(f"#   {kernel}: {n} launches, {k_us / 1e3:.3f} ms in the "
                  f"batch ({k_us / 1e3 / n:.4f} ms per launch)")
            us += k_us
        in_path[name] = us / 1e3 / max(calls[name], 1)
        print(f"#   {name}: {calls[name]} calls, {us / 1e3:.3f} ms in the "
              f"batch ({in_path[name]:.4f} ms per call, "
              f"{us / 1e3 / busy_ms:.1%} of busy time)")
    for k, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"#   top: {us / 1e3:8.3f} ms {n:6d}x {k[:90]}")
    return in_path


def main():
    card = phase_environment()
    phase_build()
    results = phase_kernels()
    counts, solve = phase_slice(card)
    in_path = phase_profile(solve)
    for name, r in results.items():
        # cold reads its inputs from HBM; a warm repeat finds those that
        # fit in the 50 MB L2, so its share is not one of the HBM bound
        path = r["bound_ms"] / in_path[name] if in_path[name] else 0.0
        print(f"# share of bound {name}: {r['bound_ms'] / r['cold_ms']:.1%}"
              f" cold, {path:.1%} in the batch, "
              f"{r['bound_ms'] / r['ms']:.1%} warm (from L2)")
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **results[name], path_ms=in_path[name],
                    library_note=LIBRARY_NOTE[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"# total {time.perf_counter() - t0:.1f} s", file=sys.stderr)
