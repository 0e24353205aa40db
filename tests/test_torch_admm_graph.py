"""The block ADMM loop's segment (`ops.blockqp._segment`) and its CUDA
graph.

On the CPU the loop runs each segment eagerly: its iterates equal, bit for
bit and in float32 and float64, those of the loop written out below as one
piece (iterations, the residual test, certificates, adaptive rho,
best-so-far and stall bookkeeping inline), which keeps every QP vector as
its groups (`ZGroups`, `WVars`) and does each elementwise operation group
by group; and no graph is captured or replayed.  The graph
cache's key (the whole settings and every buffer's shape) and its cap are
checked here too.  The `cuda` cases hold the replayed loop on the card to
the eager one: at the trot (V=22) and bolt (V=16) shapes with fixed and
'cond' rho, the 'assoc' sweep, the block-Thomas factor in float64 with
'always' rho and talos' wrench contacts, to round-off; one batch of each
B=128 benchmark cell, and of talos pace at B=128 (wrench6, re-linearized,
'always' rho), bit for bit; two problems through one cached graph;
a 'cond' solve that refactors; a capture while another thread works on
the card.  They check the counters of both paths, and that a trace shows
as many sweep kernels as the launch counters count:

    python -m pytest --noconftest -m cuda tests/test_torch_admm_graph.py
"""
import dataclasses
import math

import pytest
import torch

from centroidal_mpc_tpu_torch._tree import map_tensors, select
from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu_torch.ops import admm, block_tridiag
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops.admm import (QPSettings, STATUS_MAX_ITER,
                                               STATUS_SOLVED,
                                               STATUS_PRIMAL_INFEASIBLE,
                                               STATUS_DUAL_INFEASIBLE)
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config

BASE = QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=400,
                  adaptive_rho=False, check_interval=10, polish=False)
VARIANTS = {
    "fixed": BASE,
    "cond": dataclasses.replace(BASE, adaptive_rho=True,
                                adaptive_rho_mode="cond"),
    "stall": dataclasses.replace(BASE, stall_segments=2, eps_abs=1e-9,
                                 eps_rel=1e-9),
    "no_certificates": dataclasses.replace(BASE, check_infeasibility=False),
    "polish": dataclasses.replace(BASE, polish=True),
    "thomas": dataclasses.replace(BASE, factor_method="thomas"),
    "assoc": dataclasses.replace(BASE, sweep_method="assoc"),
}


def _block_qp(preset, batch: int, device, dtype):
    """The preset's block QP at its plan for `batch` lanes, lane 0 as
    planned and the others' CoM x/y moved by 5 mm N(0, 1) (seeded), and
    the trajectory as the warm start."""
    prob = presets.build_problem(preset, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(11)
    X = prob.X0[None].repeat(batch, 1, 1)
    U = prob.U0[None].repeat(batch, 1, 1)
    X[1:, :, :2] += 0.005 * torch.randn(batch - 1, 1, 2, generator=gen,
                                        dtype=torch.float64)
    data = compute_trajectory_data(prob.model, prob.plan.schedule, X, U,
                                   with_covariance=False)
    qp = tbq.build_block_qp(prob.model, prob.plan.schedule,
                            tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X),
                            X, U, data, 100.0, 100.0)

    def to(a):
        return a.to(device=device,
                    dtype=dtype if a.is_floating_point() else a.dtype)
    qp = dataclasses.replace(qp, **{
        f.name: to(getattr(qp, f.name)) for f in dataclasses.fields(qp)})
    w0 = tbq.WVars(x=to(X), u=to(U), t=to(torch.zeros(X.shape[:2])))
    return qp, w0


def _scaled_start(qp, w0, settings):
    """The scaled problem and the scaled warm start (w packed, y (B, m)),
    as solve_block_qp hands them to the loop."""
    s = tbq._ruiz(qp, settings.scaling_iters)
    return s, _packed(w0) / s.D, torch.zeros_like(s.l)


# the written-out loop's own group helpers
def _zmap(f, *zs):
    return tbq.ZGroups(*(f(*parts) for parts in zip(*zs)))


def _wmap(f, *ws):
    return tbq.WVars(*(f(*parts) for parts in zip(*ws)))


def _groups(s, z):
    """The ZGroups of a (B, m) constraint-space vector of s."""
    nb, N, C = s.Ah.shape[0], s.Ah.shape[1], s.Gh.shape[2]
    shapes = ((9,), (N, 9), (9,), (N, C, 2), (N, C, 5), (N + 1, 8),
              (N + 1,))
    parts = z.split([math.prod(sh) for sh in shapes], dim=1)
    return tbq.ZGroups(*(p.reshape((nb,) + sh)
                         for p, sh in zip(parts, shapes)))


def _flat(z):
    return torch.cat([g.flatten(1) for g in z], dim=1)


def _wvars(W):
    """The WVars of a packed (B, N+1, V) variable-space vector."""
    return tbq.WVars(x=W[..., :9], u=W[:, :-1, 9:-1], t=W[..., -1])


def _packed(w):
    nb, n, nu = w.u.shape
    W = torch.zeros((nb, n + 1, 9 + nu + 1), dtype=w.x.dtype,
                    device=w.x.device)
    W[..., :9], W[:, :-1, 9:-1], W[..., -1] = w.x, w.u, w.t
    return W


def _written_out_loop(s, w, y, settings):
    """The ADMM loop with every segment written out inline and every QP
    vector kept as its groups: the reference that `_admm_loop_batched`
    and its `_segment` are held to.  Takes and returns w packed and y,
    y_lo (B, m), as the loop does."""
    nb = s.sh.shape[0]
    dtype, dev = s.sh.dtype, s.sh.device
    sigma, alpha = settings.sigma, settings.alpha
    n_segments = -(-settings.max_iter // settings.check_interval)
    max_it = n_segments * settings.check_interval
    factorize, backsolve = tbq._backend(settings)
    ZGroups = tbq.ZGroups
    q, lo_g, hi_g = _wvars(s.q), _groups(s, s.l), _groups(s, s.u)

    def rho_groups(rho_b):
        """Per-row step sizes at full group shapes; equality rows get
        eq_rho_scale * rho."""
        req = settings.eq_rho_scale * rho_b
        return ZGroups(*(r.reshape((-1,) + (1,) * (like.dim() - 1))
                         .expand_as(like) for r, like in
                         zip((req, req, req, rho_b, rho_b, rho_b, rho_b),
                             lo_g)))

    def refactor_lanes(rho_b, fac, lanes):
        diag, off = tbq._assemble_blocks(s, _flat(rho_groups(rho_b)), sigma)
        sub = factorize(diag.index_select(0, lanes),
                        off.index_select(0, lanes))
        return type(fac)(*(f.index_copy(0, lanes, g)
                           for f, g in zip(fac, sub)))

    rho_b = torch.full((nb,), settings.rho, dtype=dtype, device=dev)
    rho_g = rho_groups(rho_b)
    fac = factorize(*tbq._assemble_blocks(s, _flat(rho_g), sigma))
    refactors = torch.zeros(nb, dtype=torch.int32, device=dev)

    def admm_iter(w, z, y, rho_g, fac):
        rz_y = ZGroups(*(rr * zz - yy for zz, yy, rr in zip(z, y, rho_g)))
        rhs = _wmap(lambda ww, at, qq: sigma * ww + at - qq,
                    w, _wvars(tbq._apply_AT(s, _flat(rz_y))), q)
        w_t = _wvars(backsolve(fac, _packed(rhs)))
        z_t = _groups(s, tbq._apply_A(s, _packed(w_t)))
        w_new = _wmap(lambda wt, ww: alpha * wt + (1 - alpha) * ww, w_t, w)
        z_rel = _zmap(lambda zt, zz: alpha * zt + (1 - alpha) * zz, z_t, z)
        z_new = ZGroups(*(torch.clamp(zr + yy / rr, lo, hi)
                          for zr, yy, rr, lo, hi in
                          zip(z_rel, y, rho_g, lo_g, hi_g)))
        y_new = ZGroups(*(yy + rr * (zr - zn) for yy, rr, zr, zn in
                          zip(y, rho_g, z_rel, z_new)))
        return w_new, z_new, y_new

    w, y = _wvars(w), _groups(s, y)
    z = _groups(s, tbq._apply_A(s, _packed(w)))
    i32 = dict(dtype=torch.int32, device=dev)
    it = torch.zeros(nb, **i32)
    prim = torch.full((nb,), float("inf"), dtype=dtype, device=dev)
    dual = prim.clone()
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    status = torch.zeros(nb, **i32)
    wb, yb, pb, db = w, y, prim, dual
    stall = torch.zeros(nb, **i32)

    while True:
        frozen = done | (it >= max_it)
        if bool(frozen.all()):
            break
        w2, z2, y2 = w, z, y
        for _ in range(settings.check_interval):
            w2, z2, y2 = admm_iter(w2, z2, y2, rho_g, fac)
        (prim_n, dual_n, eps_prim, eps_dual,
         prim_scale, dual_scale) = tbq._residuals(
             s, settings, _packed(w2), _flat(z2), _flat(y2))
        done_new = (prim_n < eps_prim) & (dual_n < eps_dual)
        status_new = torch.where(
            done_new, torch.full((), STATUS_SOLVED, **i32),
            torch.full((), STATUS_MAX_ITER, **i32))
        if settings.check_infeasibility:
            dw = _wmap(lambda a, b: a - b, w2, w)
            dy = _zmap(lambda a, b: a - b, y2, y)
            pinf, dinf = tbq._certificates(s, settings, _packed(dw),
                                           _flat(dy))
            status_new = torch.where(
                pinf & ~done_new,
                torch.full((), STATUS_PRIMAL_INFEASIBLE, **i32),
                torch.where(dinf & ~done_new,
                            torch.full((), STATUS_DUAL_INFEASIBLE, **i32),
                            status_new))
            done_new = done_new | ((pinf | dinf) & ~done_new)
        rho_next = rho_b
        if settings.adaptive_rho:
            ratio = torch.sqrt(
                (prim_n / prim_scale.clamp(min=1e-30))
                / (dual_n / dual_scale.clamp(min=1e-30)).clamp(min=1e-30))
            new_rho = (rho_b * ratio).clamp(1e-6, 1e6)
            trigger = (((ratio > settings.adaptive_rho_tol)
                        | (ratio < 1.0 / settings.adaptive_rho_tol))
                       & ~done_new)
            rho_next = torch.where(trigger, new_rho, rho_b)
        w3, z3, y3 = select(frozen, (w, z, y), (w2, z2, y2))
        improve = ((torch.maximum(prim_n, dual_n)
                    < 0.99 * torch.maximum(pb, db)) & ~frozen)
        stall = torch.where(frozen, stall,
                            torch.where(improve, torch.zeros_like(stall),
                                        stall + 1))
        wb, yb = select(improve, (w3, y3), (wb, yb))
        pb = torch.where(improve, prim_n, pb)
        db = torch.where(improve, dual_n, db)
        if settings.stall_segments > 0:
            done_new = done_new | (stall >= settings.stall_segments)
        w, z, y = w3, z3, y3
        rho_b = torch.where(frozen, rho_b, rho_next)
        it = torch.where(frozen, it, it + settings.check_interval)
        prim = torch.where(frozen, prim, prim_n)
        dual = torch.where(frozen, dual, dual_n)
        done = done | (done_new & ~frozen)
        status = torch.where(frozen, status, status_new)
        if settings.adaptive_rho:
            lanes = (trigger & ~done & (it < max_it)).nonzero()[:, 0]
            if lanes.numel():
                fac = refactor_lanes(rho_b, fac, lanes)
                rho_g = rho_groups(rho_b)
                refactors = refactors.index_add(
                    0, lanes, torch.ones_like(lanes, dtype=torch.int32))

    adopt = torch.maximum(pb, db) < torch.maximum(prim, dual)
    w, y = select(adopt, (wb, yb), (w, y))
    prim = torch.where(adopt, pb, prim)
    dual = torch.where(adopt, db, dual)
    w, y = _packed(w), _flat(y)
    y_lo = torch.zeros_like(y)
    if settings.polish:
        w_p, z_p, y_p, y_lo_p = tbq._polish(s, settings, sigma, w, y)
        (prim_p, dual_p, eps_prim_p, eps_dual_p,
         _, _) = tbq._residuals(s, settings, w_p, z_p, y_p, y_lo_p)
        worst = torch.maximum(prim / eps_prim_p, dual / eps_dual_p)
        worst_p = torch.maximum(prim_p / eps_prim_p, dual_p / eps_dual_p)
        better = worst_p < worst
        w, y, y_lo = select(better, (w_p, y_p, y_lo_p), (w, y, y_lo))
        prim = torch.where(better, prim_p, prim)
        dual = torch.where(better, dual_p, dual)
        newly = better & (prim_p < eps_prim_p) & (dual_p < eps_dual_p)
        status = torch.where(newly, torch.full((), STATUS_SOLVED, **i32),
                             status)
    return w, y, y_lo, it, prim, dual, status, rho_b, refactors


def _leaves(out):
    return tbq._leaves(tuple(out))


def _assert_same(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), (i, (a - b).abs().max())


def _counters():
    return {**block_tridiag.launches, **admm.counts}


@pytest.fixture(scope="module")
def mini_qp():
    return _block_qp(presets.SOLO12_TROT_MINI, 3, "cpu", torch.float64)


@pytest.fixture(scope="module")
def mini_qp32():
    return _block_qp(presets.SOLO12_TROT_MINI, 3, "cpu", torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("max_iter", [10, 40, 400])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loop_gives_the_written_out_iterates(mini_qp, mini_qp32, variant,
                                             max_iter, dtype):
    """`_admm_loop_batched`, each segment run eagerly through `_segment`,
    returns bit for bit what the written-out loop returns, after one,
    four and up to forty segments; the packed iterate's dummy control
    slot stays zero."""
    settings = dataclasses.replace(VARIANTS[variant], max_iter=max_iter)
    qp, w0 = mini_qp if dtype == "float64" else mini_qp32
    s, w, y = _scaled_start(qp, w0, settings)
    got = tbq._admm_loop_batched(s, w, y, settings)
    want = _written_out_loop(s, w, y, settings)
    _assert_same(got, want)
    assert not got[0][:, -1, 9:-1].any()
    if variant == "cond" and max_iter == 400:
        assert (got[-1] > 0).any()          # some lane refactored


def test_one_segment_from_the_start(mini_qp):
    """`_segment` alone, on the loop's starting state, gives the iterate
    and termination state the written-out loop has after one segment."""
    settings = dataclasses.replace(BASE, max_iter=BASE.check_interval)
    qp, w0 = mini_qp
    s, w, y = _scaled_start(qp, w0, settings)
    nb = s.sh.shape[0]
    factorize, backsolve = tbq._backend(settings)
    rho_b = torch.full((nb,), settings.rho, dtype=s.sh.dtype)
    rho_g = tbq._rho_rows(settings, rho_b, s)
    fac = factorize(*tbq._assemble_blocks(s, rho_g, settings.sigma))
    i32 = dict(dtype=torch.int32)
    inf = torch.full((nb,), float("inf"), dtype=s.sh.dtype)
    done = torch.zeros(nb, dtype=torch.bool)
    st = tbq._LoopState(
        w=w, z=tbq._apply_A(s, w), y=y, wb=w, yb=y, pb=inf, db=inf,
        it=torch.zeros(nb, **i32), prim=inf, dual=inf, done=done,
        status=torch.zeros(nb, **i32), stall=torch.zeros(nb, **i32),
        rho_b=rho_b, frozen=done, run_on=None)
    out = tbq._segment(s, settings, backsolve, rho_g, fac, st)
    w_ref, y_ref, _, it, prim, dual, status, _, _ = _written_out_loop(
        s, w, y, settings)
    _assert_same((out.w, out.y, out.it, out.prim, out.dual, out.status),
                 (w_ref, y_ref, it, prim, dual, status))
    assert out.frozen.all() and out.run_on is None


def test_no_graph_on_the_cpu(mini_qp):
    """CPU tensors run eagerly: no capture, no replay, nothing cached."""
    qp, w0 = mini_qp
    before = _counters()
    sol = tbq.solve_block_qp(qp, VARIANTS["cond"], w0=w0)
    after = _counters()
    assert int(sol.iterations.max()) > 0
    assert after["admm.segments"] > before["admm.segments"]
    for k in ("admm.graph_captures", "admm.graph_replays"):
        assert after[k] == before[k] == 0, k
    assert not tbq._SEGMENT_GRAPHS


def _changed(value):
    """Another value of a setting's type."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value * 2 + 1
    return value + "_"


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(QPSettings)])
def test_graph_key_follows_every_setting(mini_qp, field):
    """The cache key holds the whole settings (the backend among them), so
    a changed setting gives a new capture; equal settings and buffers of
    the same shapes give the same key, another batch size another."""
    qp, w0 = mini_qp
    s, w, y = _scaled_start(qp, w0, BASE)
    st = tbq._LoopState(*([w, tbq._apply_A(s, w), y]
                          + [s.c] * 12 + [None]))
    rho_g = tbq._rho_rows(BASE, s.c, s)

    def key(settings, lanes=3):
        bufs = map_tensors(lambda a: a[:lanes], (s, rho_g, (s.Px,), st))
        return tbq._graph_key(bufs[0], settings, *bufs[1:])
    changed = dataclasses.replace(
        BASE, **{field: _changed(getattr(BASE, field))})
    assert key(changed) != key(BASE)
    assert key(dataclasses.replace(BASE)) == key(BASE)
    assert key(BASE, lanes=2) != key(BASE)


def test_graph_cache_keeps_the_newest(monkeypatch):
    """The cache keeps the most recently returned graphs, up to its cap,
    and drops the oldest."""
    cache = tbq.collections.OrderedDict()
    monkeypatch.setattr(tbq, "_SEGMENT_GRAPHS", cache)
    n = tbq._SEGMENT_GRAPHS_KEPT
    for k in range(n + 2):
        tbq._keep_graph(k, f"graph {k}")
    assert list(cache) == list(range(2, n + 2))
    tbq._keep_graph(3, "graph 3")             # a key used again is newest
    assert list(cache)[-1] == 3 and len(cache) == n


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD = {"trot": presets.SOLO12_TROT_N50, "bolt": presets.BOLT_PACE,
        "talos": presets.TALOS_PACE}
CARD_SETTINGS = {
    "fixed": QPSettings(eps_abs=5e-4, eps_rel=5e-4, max_iter=4000,
                        adaptive_rho=False, check_interval=10, polish=True,
                        stall_segments=30),
    "cond": QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=2000,
                       adaptive_rho=True, adaptive_rho_mode="cond",
                       check_interval=10, polish=False),
    "assoc": QPSettings(eps_abs=5e-4, eps_rel=5e-4, max_iter=4000,
                        adaptive_rho=False, check_interval=10, polish=True,
                        sweep_method="assoc"),
    "thomas": QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=2000,
                         adaptive_rho=True, adaptive_rho_mode="always",
                         check_interval=10, polish=False,
                         factor_method="thomas"),
}
# (robot, settings, dtype): both kernel builds (V=22, V=16) with fixed
# and 'cond' rho, the 'assoc' sweep, the block-Thomas factor in float64
# with 'always' rho (the pipeline's mode; its refactors copy into the
# graph's factor), and a biped's wrench contacts (talos: other
# constraint widths, another key)
CARD_CASES = [("trot", "fixed", torch.float32),
              ("trot", "cond", torch.float32),
              ("bolt", "fixed", torch.float32),
              ("bolt", "cond", torch.float32),
              ("trot", "assoc", torch.float32),
              ("trot", "thomas", torch.float64),
              ("talos", "fixed", torch.float32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def eager(monkeypatch):
    """A context in which the loop runs its segments eagerly on the card."""
    def segments(s, settings, backsolve, rho_g, fac, st):
        return tbq._EagerSegments(s, settings, backsolve, rho_g, fac, st), None

    class Eager:
        def __enter__(self):
            monkeypatch.setattr(tbq, "_segments", segments)

        def __exit__(self, *exc):
            monkeypatch.undo()
    return Eager()


def _solve(qp, w0, settings):
    """One solve: (solution, counter deltas)."""
    before = _counters()
    sol = tbq.solve_block_qp(qp, settings, w0=w0)
    torch.cuda.synchronize()
    after = _counters()
    return sol, {k: after[k] - before[k] for k in after}


def _assert_close(got, want):
    """Iterations and statuses exactly; X, U, t and y to round-off of
    their magnitude (1e-5 in float32, 1e-12 in float64)."""
    for k in ("iterations", "status", "converged", "refactors"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    rel = {torch.float32: 1e-5, torch.float64: 1e-12}[want.X.dtype]
    for k in ("X", "U", "t", "prim_res", "dual_res", "rho"):
        a, b = getattr(got, k), getattr(want, k)
        tol = rel * float(b.abs().max()) + 1e-30
        assert float((a - b).abs().max()) <= tol, k
    for a, b in zip(got.y, want.y):
        tol = rel * float(b.abs().max()) + 1e-30
        assert float((a - b).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("robot,rho,dtype", CARD_CASES)
def test_replay_matches_eager(cuda, eager, robot, rho, dtype):
    qp, w0 = _block_qp(CARD[robot], 16, cuda, dtype)
    settings = CARD_SETTINGS[rho]
    with eager:
        want, d_eager = _solve(qp, w0, settings)
    got, d_graph = _solve(qp, w0, settings)
    _assert_close(got, want)
    if settings.adaptive_rho:
        assert int(got.refactors.sum()) > 0
    # the counters of both paths agree but for the graph's own
    assert d_graph["admm.graph_replays"] == d_graph["admm.segments"] > 0
    assert d_eager["admm.graph_replays"] == d_eager["admm.graph_captures"] == 0
    for k in d_eager:
        if not k.startswith("admm.graph_"):
            assert d_graph[k] == d_eager[k], k


@pytest.mark.cuda
def test_two_problems_through_one_graph(cuda, eager):
    """Two problems of one shape, back to back through the same cached
    graph, each equal to its own eager solve; the first again after the
    second equals itself (no input of an earlier solve is read)."""
    settings = CARD_SETTINGS["fixed"]
    qp_a, w_a = _block_qp(CARD["trot"], 16, cuda, torch.float32)
    qp_b, w_b = _block_qp(CARD["trot"], 16, cuda, torch.float32)
    qp_b = dataclasses.replace(qp_b, r_dyn=qp_b.r_dyn * 1.05,
                               x_init=qp_b.x_init + 0.002)
    with eager:
        want_a, _ = _solve(qp_a, w_a, settings)
        want_b, _ = _solve(qp_b, w_b, settings)
    got_a, d_a = _solve(qp_a, w_a, settings)
    got_b, d_b = _solve(qp_b, w_b, settings)
    again_a, d_again = _solve(qp_a, w_a, settings)
    assert not torch.equal(want_a.X, want_b.X)
    _assert_close(got_a, want_a)
    _assert_close(got_b, want_b)
    _assert_close(again_a, want_a)
    assert d_b["admm.graph_captures"] == d_again["admm.graph_captures"] == 0
    assert d_b["admm.graph_replays"] > 0


@pytest.mark.cuda
def test_replay_reads_the_refactored_factor(cuda, eager):
    """A 'cond' solve at B=1 (the MPC tick's shape) that refactors: the
    replays after a refactor read the new factor and step sizes, so the
    iterates follow the eager loop's."""
    settings = CARD_SETTINGS["cond"]
    qp, w0 = _block_qp(CARD["trot"], 1, cuda, torch.float32)
    with eager:
        want, d_eager = _solve(qp, w0, settings)
    got, d_graph = _solve(qp, w0, settings)
    assert int(want.refactors.sum()) > 0 and d_eager["admm.refactor_calls"] > 0
    assert d_graph["admm.refactor_calls"] == d_eager["admm.refactor_calls"]
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["trot165_b128", "bolt_pace_b128",
                                  "talos_pace_b128"])
def test_replay_is_bit_equal_at_the_cells_shapes(cuda, eager, cell):
    """One batch of a benchmark cell (its configuration, B=128, its
    perturbed inputs) through `batched_solve`: the replayed loop gives the
    eager loop's X, U, K, success and QP iterations bit for bit."""
    from scpbench.harness import BatchLoop, Cell, build_program
    from scpbench.traffic import Scenarios
    c = Cell.find(cell)
    loop = BatchLoop(c, build_program(c, cuda), cuda)
    dx = Scenarios(2**31 + 12345, c.workload["perturb_std"]).draw(
        loop.B, zero_first=True)
    with eager:
        want = loop.unit(dx)
    got = loop.unit(dx)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_trace_shows_every_counted_sweep(cuda):
    """In a profiler trace of a replayed solve, the device ops of the sweep
    kernels number what `block_tridiag.launches` grew by: the counters
    each replay adds match the graph's kernel nodes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    qp, w0 = _block_qp(CARD["trot"], 16, cuda, torch.float32)
    settings = CARD_SETTINGS["fixed"]
    _solve(qp, w0, settings)                 # captures outside the trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, delta = _solve(qp, w0, settings)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert delta["admm.graph_replays"] == delta["admm.segments"] > 0
    assert delta["admm.graph_captures"] == 0
    for k in ("tridiag_fwd", "tridiag_bwd"):
        assert sum(f"{k}_kernel" in n for n in names) == delta[k] > 0, k


@pytest.mark.cuda
def test_capture_beside_another_threads_work(cuda, eager, monkeypatch):
    """A capture while another thread allocates, launches and reads back on
    the card (as the server's control loop does beside its solver
    thread): the capture succeeds, the other thread's work too, and the
    replayed solve equals the eager one.  The other thread draws no random
    numbers from the card's default generator: PyTorch registers that
    generator with every capture and refuses its use outside it."""
    import threading
    qp, w0 = _block_qp(CARD["trot"], 16, cuda, torch.float32)
    settings = CARD_SETTINGS["fixed"]
    with eager:
        want, _ = _solve(qp, w0, settings)
    monkeypatch.setattr(tbq, "_SEGMENT_GRAPHS", tbq.collections.OrderedDict())
    stop, ran, errors = threading.Event(), [0], []

    def other():
        try:
            n = 1 << 10
            while not stop.is_set():
                a = torch.arange(n, device=cuda, dtype=torch.float32)
                assert float((a * a).sum()) > 0
                n = n * 2 if n < 1 << 24 else 1 << 10
                ran[0] += 1
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
    th = threading.Thread(target=other)
    th.start()
    while not ran[0] and th.is_alive():
        stop.wait(0.001)
    try:
        got, d = _solve(qp, w0, settings)
    finally:
        stop.set()
        th.join()
    assert not errors, errors
    assert ran[0] > 0 and d["admm.graph_captures"] == 1
    _assert_close(got, want)
