"""The comparison that decides `correct`.

After the window has closed, a sample of the window's answers, drawn from
the run's seed, is worked out again by the configuration's plain
reference (`references/<name>.py`) in float64, from the configuration
file and the same generated inputs, and compared:

    x_gap    max |X - X_ref| / max |X_ref|   (states, every knot)
    u_gap    max |U - U_ref| / max |U_ref|   (controls, every knot)
    k_gap    max |K - K_ref| / max |K_ref|   (LQR gains, every knot)
    prim     the answer's primal residual in the reference's QP (the
             initial state, the linearized dynamics, the friction
             pyramid) over the tolerance the configuration states
             (eps_abs + eps_rel max(|Az|, |z|), OSQP's), of the lanes the
             program says it solved; its limit is 1, the configuration's

x_gap and u_gap are the median over the sampled lanes or ticks (a
lane's own error is set by where its ADMM stopped, at the stated
tolerance, and a few lanes in a sample stop far looser than the rest),
k_gap and prim the largest.  The numbers that the workload file gives a
limit are compared; the others are printed as data.  The sample always holds the
first answer of the window and the one that took the most QP
iterations.

An MPC tick starts from the previous tick's plan, which is the program's
own state: the reference follows it step by step, shifting that plan a
knot itself and measuring the state at its second knot, and checks the
first tick of every episode, which starts from the reference's own warm
start, from its own inputs alone.
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
NUMBERS = ("x_gap", "u_gap", "k_gap", "prim")
CHUNK = 8           # lanes the reference solves at once


def load_reference(name: str, root: pathlib.Path = HERE):
    path = root / "references" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"scpbench_ref_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tf32_matmul(a, b):
    """A float32 product with TF32 inputs: each factor rounded to TF32's
    10-bit mantissa (round to nearest, ties to even), accumulated in
    float32, as a TF32 tensor-core product computes it; the same on the
    CPU and the card."""
    def rnd(x):
        i = x.contiguous().view(torch.int32)
        i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32)
    return torch.matmul(rnd(a), rnd(b))


def gaps(prog, ref):
    """(x_gap, u_gap, k_gap, prim) of one lane: prog and ref dicts of X,
    U, K arrays; ref also holds `prim`, the reference's function of (X,
    U) that gives the primal residual ratio.  prim is 0 for a lane that
    the program says it did not solve."""
    out = []
    for key in ("X", "U", "K"):
        p = np.asarray(prog[key], np.float64)
        r = np.asarray(ref[key], np.float64)
        out.append(float(np.abs(p - r).max() / np.abs(r).max()))
    solved = bool(np.asarray(prog.get("success", True)))
    out.append(ref["prim"](np.asarray(prog["X"], np.float64),
                           np.asarray(prog["U"], np.float64))
               if solved else 0.0)
    if not all(np.isfinite(out)):
        out = [float("inf")] * len(out)
    return out


def sample(n_items: int, first: int, busiest: int, seed: int, n: int):
    """Indices to compare: the first, the busiest, and the rest drawn
    from the seed without replacement."""
    rng = np.random.default_rng((int(seed) + 0x5C9B) % 2**64)
    picked = [first] if busiest == first else [first, busiest]
    rest = [i for i in range(n_items) if i not in picked]
    k = max(0, min(n - len(picked), len(rest)))
    picked += [rest[i] for i in sorted(rng.choice(len(rest), k,
                                                  replace=False))]
    return picked


def reference_cfg(cfg: dict, workload: dict) -> dict:
    """The configuration with the workload's solver overrides."""
    over = workload.get("overrides", {})
    return {**cfg, "scp": {**cfg["scp"], **over.get("scp", {})},
            "qp": {**cfg["qp"], **over.get("qp", {})}}


class Reference:
    """The configuration's reference at one precision on one device."""

    def __init__(self, cfg: dict, workload: dict, device, dtype=torch.float64,
                 matmul=torch.matmul, root: pathlib.Path = HERE):
        self.mod = load_reference(cfg["reference"], root)
        self.cfg = reference_cfg(cfg, workload)
        self.terminal = workload.get("overrides", {}).get(
            "terminal_equality", True)
        self.device, self.dtype, self.matmul = device, dtype, matmul
        self.logic, self.pos, self.rot = self.mod.contact_plan(self.cfg)
        Xw, Uw = self.mod.warm_start(self.cfg, self.logic, self.pos)
        self.Xw = torch.as_tensor(Xw, dtype=dtype, device=device)
        self.Uw = torch.as_tensor(Uw, dtype=dtype, device=device)

    def t(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device, self.dtype)
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def problem(self, k0: int = 0, knots=None):
        sl = slice(k0, None if knots is None else k0 + knots)
        return self.mod.Problem(self.cfg, self.logic[sl], self.pos[sl],
                                self.rot[sl], self.dtype, self.device,
                                terminal_equality=self.terminal)

    def solve(self, prob, X0, U0, X_track, x_init):
        X, U, K, success, _ = prob.solve_scp(
            X0, U0, X_track, x_init, X_track[:, -1], matmul=self.matmul)

        lin = prob.linearization
        eps = (self.cfg["qp"]["eps_abs"], self.cfg["qp"]["eps_rel"])

        def prim(i):
            def of(Xp, Up):
                prob.linearization = tuple(a[i:i + 1] for a in lin)
                r = prob.primal_ratio(self.t(Xp)[None], self.t(Up)[None],
                                      X0[i:i + 1], U0[i:i + 1],
                                      x_init[i:i + 1],
                                      X_track[i:i + 1, -1], *eps)
                return float(r[0])
            return of
        return [dict(X=X[i].double().cpu().numpy(),
                     U=U[i].double().cpu().numpy(),
                     K=K[i].double().cpu().numpy(),
                     success=bool(success[i]), prim=prim(i))
                for i in range(X.shape[0])]

    def batch_lanes(self, dxs):
        """Answers for scenarios given by their offsets dxs (L, nx)."""
        prob = self.problem()
        out = []
        for lo in range(0, len(dxs), CHUNK):
            d = self.t(dxs[lo:lo + CHUNK])
            X0 = self.Xw[None] + d[:, None, :]
            U0 = self.Uw.expand((d.shape[0],) + self.Uw.shape)
            out += self.solve(prob, X0, U0, X0, X0[:, 0])
        return out

    def mpc_start(self, dx):
        """(X0 (N+1, nx), U0 (N, nu)) of an episode with offset dx."""
        return self.Xw + self.t(dx)[None], self.Uw

    def mpc_tick(self, window: int, X_full, tick: int, X_warm, U_warm,
                 x_meas):
        """One tick's answer: the plan's window at `tick` (clamped), the
        warm start (X_warm with x_meas at its first knot)."""
        n = self.logic.shape[0]
        k = min(max(int(tick), 0), n - window)
        X0 = self.t(X_warm).clone()[None]
        X0[:, 0] = self.t(x_meas)
        X_track = self.t(X_full)[None, k:k + window + 1]
        return self.solve(self.problem(k, window), X0,
                          self.t(U_warm)[None], X_track, X0[:, 0])[0]


def shift(a):
    """A plan moved a knot forward, its last knot repeated."""
    return np.concatenate([a[1:], a[-1:]], 0)


def check_batch(ref: Reference, units, seed: int, n: int):
    """units: [(dx (B, nx), answers {X, U, K, qp}: host arrays (B, ...))].
    Returns the per-lane gaps of the sampled lanes."""
    B = units[0][0].shape[0]
    qp = np.concatenate([np.asarray(a["qp"]) for _, a in units])
    picked = sample(len(qp), 0, int(np.argmax(qp)), seed, n)
    lanes = [(i // B, i % B) for i in picked]
    refs = ref.batch_lanes(np.stack([units[u][0][l] for u, l in lanes]))
    return [gaps({k: units[u][1][k][l] for k in ("X", "U", "K", "success")},
                 r) for (u, l), r in zip(lanes, refs)]


def check_mpc(ref: Reference, window: int, episodes, seed: int, n: int):
    """episodes: [(dx (nx,), [tick answers {X, U, K, qp} host arrays of
    one lane])].  Each tick is worked out from the previous tick's
    answer (the program's state), the first of an episode from the
    reference's own warm start.  Returns the per-tick gaps of the
    sampled ticks."""
    index = [(e, i) for e, (_, ticks) in enumerate(episodes)
             for i in range(len(ticks))]
    qp = [float(np.asarray(episodes[e][1][i]["qp"])) for e, i in index]
    picked = sample(len(index), 0, int(np.argmax(qp)), seed, n)
    per = []
    for j in picked:
        e, i = index[j]
        dx, ticks = episodes[e]
        X_full, U_full = ref.mpc_start(dx)
        if i == 0:
            Xw = X_full[:window + 1].cpu().numpy()
            Uw = U_full[:window].cpu().numpy()
            x_meas = Xw[0]
        else:
            prev = ticks[i - 1]
            Xw, Uw = shift(prev["X"]), shift(prev["U"])
            x_meas = prev["X"][1]
        r = ref.mpc_tick(window, X_full, i, Xw, Uw, x_meas)
        per.append(gaps(ticks[i], r))
    return per


def summary(per):
    """The check's numbers from the per-lane gaps."""
    per = np.array(per)
    med, top = np.median(per, 0), np.max(per, 0)
    return {"x_gap": float(med[0]), "u_gap": float(med[1]),
            "k_gap": float(top[2]), "prim": float(top[3])}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}} of the compared numbers, the
    others): every number that has a limit at or under it, and at least
    one number compared."""
    rows = {k: {"value": numbers[k], "limit": limits[k]}
            for k in NUMBERS if limits.get(k) is not None}
    data = {k: numbers[k] for k in NUMBERS if k not in rows}
    ok = bool(rows) and all(r["value"] <= r["limit"] for r in rows.values())
    return ok, rows, data
