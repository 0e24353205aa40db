"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit;
     fails when no CUDA device is present (there is no CPU fallback);
  2. build: compiles the hand-written kernels (centroidal_mpc_tpu_torch/
     csrc/*.cu) with nvcc for sm_90a;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the small bench shape and the main path's shapes, with CUDA-event
     times of both;
  4. the slice: 128 solo12_trot_n50 SCP problems in float32 through
     parallel.batch.batched_solve (block backend, frozen linearization,
     power-iteration trust norm, fixed-rho block ADMM with its refinement
     polish), checked for success on every lane, for launches of every
     kernel, and against the committed float64 reference solution.

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
SOURCES = {
    "tridiag_factor": "centroidal_mpc_tpu_torch/csrc/block_tridiag.cu",
    "tridiag_fwd": "centroidal_mpc_tpu_torch/csrc/block_tridiag.cu",
    "tridiag_bwd": "centroidal_mpc_tpu_torch/csrc/block_tridiag.cu",
    "dare_lqr": "centroidal_mpc_tpu_torch/csrc/dare_lqr.cu",
}


def launch_counts():
    return {**bt.launches, **lqr_kernel.launches}


def reset_counts():
    for d in (bt.launches, lqr_kernel.launches):
        for k in d:
            d[k] = 0


def cuda_ms(fn, reps=20, warmup=3):
    """Mean CUDA-event time of fn() in ms over `reps` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        if "registers" in line or "Compiling entry" in line:
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
    for (b, n, v) in [(32, 8, 22), (BATCH, 50, 22)]:
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
        if b == BATCH:   # main-path shape: record errors and times
            results["tridiag_factor"] = dict(
                max_abs_err=f_abs,
                ms=cuda_ms(lambda: bt.factor_batched(diag, off)),
                plain_ms=cuda_ms(lambda: bt.factor_plain(diag, off), 3, 1))
            results["tridiag_fwd"] = dict(
                max_abs_err=float((vk - vp).abs().max()),
                ms=cuda_ms(lambda: bt.forward_sweep(fk, rhs)),
                plain_ms=cuda_ms(lambda: bt.forward_sweep_plain(fk, rhs)))
            results["tridiag_bwd"] = dict(
                max_abs_err=float((wk - wp).abs().max()),
                ms=cuda_ms(lambda: bt.backward_sweep(fk, vk)),
                plain_ms=cuda_ms(lambda: bt.backward_sweep_plain(fk, vk)))

    # DARE gains on the real solo12_trot_n50 linearization, 128 scenarios
    prob = presets.build_problem(presets.SOLO12_TROT_N50,
                                 dtype=torch.float32, device="cuda")
    X0, U0, _ = scenarios(prob)
    sched = prob.plan.schedule
    pos = sched.positions_flat().reshape(sched.horizon, sched.n_contacts, 3)
    _, A, Bm, _ = linearize_step(prob.model, X0[:, :-1], U0, pos,
                                 sched.logic, sched.orientation)
    A = A.reshape(-1, 9, 9).contiguous()
    Bm = Bm.reshape(-1, 9, prob.model.n_u).contiguous()
    Q, R = prob.model.Q, prob.model.R
    Kk = lqr_kernel.lqr_gain_batched(Q, R, A, Bm, 2)
    Kp = lqr_kernel.lqr_gain_plain(Q, R, A, Bm, 2)
    torch.cuda.synchronize()
    k_err = rel_err(Kk, Kp)
    print(f"# dare_lqr S={A.shape[0]}: |K - K_plain|inf / |K_plain|inf "
          f"{k_err:.2e}")
    check(k_err < KERNEL_RTOL, f"dare_lqr rel err {k_err}")
    results["dare_lqr"] = dict(
        max_abs_err=float((Kk - Kp).abs().max()),
        ms=cuda_ms(lambda: lqr_kernel.lqr_gain_batched(Q, R, A, Bm, 2)),
        plain_ms=cuda_ms(lambda: lqr_kernel.lqr_gain_plain(Q, R, A, Bm, 2)))
    for name, r in results.items():
        print(f"# time {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")
    return results


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
    return counts


def main():
    card = phase_environment()
    phase_build()
    results = phase_kernels()
    counts = phase_slice(card)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **results[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"# total {time.perf_counter() - t0:.1f} s", file=sys.stderr)
