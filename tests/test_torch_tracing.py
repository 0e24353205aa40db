"""The program's own tracing (utils/profiling.span and .counters) on a
small batch of the solo12_trot_mini problem, through both QP backends:
the spans appear only inside a profiler session and nest in `scp.solve`,
the counters agree with the spans and with the solver's own iteration
counts, and the kernel wrappers' launch counters are kept as they were.
The `cuda` case holds the sync counters to every synchronizing call that
PyTorch reports on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""
import dataclasses
import warnings

import pytest
import torch

from centroidal_mpc_tpu_torch.config import presets
from centroidal_mpc_tpu_torch.ops import admm, block_tridiag, lqr_kernel
from centroidal_mpc_tpu_torch.parallel.batch import (batched_solve,
                                                     tile_ocp_config)
from centroidal_mpc_tpu_torch.utils import profiling

SPANS = ("scp.solve", "scp.linearize", "qp.build", "qp.scale",
         "admm.factor", "admm.segment", "qp.polish", "scp.accept",
         "sync.scp", "sync.admm", "sync.refactor")
SYNCS = ("sync.scp", "sync.admm", "sync.refactor")


def _settings(prob, backend: str):
    """The preset's SCP at a loose QP tolerance, adaptive rho on; the
    block backend with its polish.  The dense solver's lanes need
    different iteration counts only below eps 1e-5."""
    eps = 1e-5 if backend == "block" else 3e-6
    qp = dataclasses.replace(prob.scp.qp, eps_abs=eps, eps_rel=eps,
                             check_interval=10,
                             polish=backend == "block")
    return dataclasses.replace(prob.scp, qp_backend=backend, qp=qp)


def _problem(device="cpu", dtype=torch.float64):
    return presets.build_problem(presets.SOLO12_TROT_MINI, dtype=dtype,
                                 device=device)


def _inputs(prob, batch: int):
    """`batch` lanes, lane 0 as planned and the others' CoM x/y moved by
    5 mm N(0, 1): (cfg, X0, U0)."""
    gen = torch.Generator().manual_seed(7)
    d = torch.zeros(batch, 9, dtype=torch.float64)
    d[1:, :2] = 0.005 * torch.randn(batch - 1, 2, generator=gen,
                                    dtype=torch.float64)
    X0 = prob.X0[None] + d.to(prob.X0)[:, None, :]
    U0 = prob.U0.expand((batch,) + prob.U0.shape)
    return tile_ocp_config(prob.ocp, X0[:, 0], X0[:, -1], X0), X0, U0


def _solve(prob, settings, inputs):
    """One batched solve: (solution, counter deltas)."""
    before = profiling.counters()
    sol = batched_solve(prob.model, prob.plan.schedule, *inputs, settings)
    after = profiling.counters()
    return sol, {k: after[k] - before[k] for k in after}


@pytest.fixture(scope="module")
def prob():
    return _problem()


def test_span_records_nothing_without_a_profiler():
    assert profiling.span("admm.segment") is profiling.span("scp.solve")
    with profiling.span("admm.segment") as inside:
        assert inside is None


@pytest.mark.parametrize("backend", ["block", "dense"])
def test_spans_appear_and_nest_in_a_trace(prob, backend, tmp_path):
    settings = _settings(prob, backend)
    with profiling.trace(str(tmp_path)) as prof:
        sol, delta = _solve(prob, settings, _inputs(prob, 4))
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("cmpc.")]
    names = {n for n, _, _ in spans}
    want = {"cmpc." + s for s in SPANS}
    if backend == "dense":
        want.discard("cmpc.qp.polish")
    assert names == want
    solves = [(a, b) for n, a, b in spans if n == "cmpc.scp.solve"]
    segments = [(a, b) for n, a, b in spans if n == "cmpc.admm.segment"]
    assert len(solves) == 1
    assert len(segments) == delta["admm.segments"] > 0
    assert all(solves[0][0] <= a <= b <= solves[0][1] for a, b in segments)
    for name in SYNCS:
        assert sum(n == "cmpc." + name for n, _, _ in spans) == delta[name]
    assert "cmpc.admm.segment" in (tmp_path / "trace.json").read_text()


@pytest.mark.parametrize("backend", ["block", "dense"])
def test_counters_count_the_loops(prob, backend):
    settings = _settings(prob, backend)
    sol, delta = _solve(prob, settings, _inputs(prob, 4))
    passes = delta["scp.iterations"]
    assert passes == int(sol.iterations.max()) > 0
    assert delta["sync.scp"] == passes + 1
    assert (delta["admm.iterations"]
            == delta["admm.segments"] * settings.qp.check_interval)
    # the end-of-loop test: one a segment, and the last one of each QP
    assert delta["sync.admm"] == delta["admm.segments"] + passes
    assert delta["sync.refactor"] == delta["admm.segments"]
    assert delta["admm.refactor_calls"] <= delta["admm.segments"]


@pytest.mark.parametrize("backend", ["block", "dense"])
def test_lane_occupancy(prob, backend):
    """Useful lane-iterations over the iterations the batch ran: all of
    them for one lane, fewer when lanes need different counts."""
    settings = _settings(prob, backend)
    for batch, full in ((1, True), (4, False)):
        sol, delta = _solve(prob, settings, _inputs(prob, batch))
        useful = int(sol.qp_iterations.sum())
        ran = batch * delta["admm.iterations"]
        assert (useful == ran) if full else (0 < useful < ran)


def test_counters_keep_the_launch_dicts(prob):
    launches = (block_tridiag.launches, lqr_kernel.launches)
    ids = [id(d) for d in launches]
    _solve(prob, _settings(prob, "block"), _inputs(prob, 1))
    snap = profiling.counters()
    assert [id(d) for d in (block_tridiag.launches,
                            lqr_kernel.launches)] == ids
    assert set(block_tridiag.launches) == {"tridiag_factor", "tridiag_fwd",
                                           "tridiag_bwd",
                                           "tridiag_factor_lanes"}
    assert set(lqr_kernel.launches) == {"dare_lqr"}
    for d in launches + (admm.counts,):
        assert {k: snap[k] for k in d} == d
    snap["admm.segments"] += 1               # a snapshot, not the counters
    assert snap["admm.segments"] != admm.counts["admm.segments"]


def test_counters_read_the_one_tuple_of_counter_dicts():
    """`counters()` and the CUDA graph's replay accounting read one tuple,
    `counter_dicts()`: the modules' own dicts, the constraint operator's
    launches among them."""
    from centroidal_mpc_tpu_torch.ops import constraint_apply
    from centroidal_mpc_tpu_torch.solver import scp
    owners = (block_tridiag.launches, lqr_kernel.launches,
              constraint_apply.launches, admm.counts, scp.counts)
    assert all(a is b for a, b in zip(profiling.counter_dicts(), owners))
    assert len(profiling.counter_dicts()) == len(owners)
    snap = profiling.counters()
    assert {"constraint_apply", "constraint_apply_T"} <= set(snap)
    assert set(snap) == set().union(*owners)


def test_counters_list_the_graph_counters(prob):
    """The block loop's CUDA graph counters are among the program's
    counters, the ADMM module says what they count, and a CPU solve
    leaves both where they were."""
    names = ("admm.graph_captures", "admm.graph_replays")
    _, delta = _solve(prob, _settings(prob, "block"), _inputs(prob, 2))
    for name in names:
        assert name in profiling.counters() and name in admm.counts
        assert f"`{name}`" in admm.__doc__
        assert delta[name] == 0


@pytest.mark.cuda
def test_sync_counters_find_every_sync_on_the_card():
    """Every call that PyTorch reports as synchronizing the card inside a
    solve is one that the program counts under `sync.*`.  The trust
    region's norm is the benchmark's 'power': the exact 'svd' norm
    synchronizes inside `torch.linalg.svdvals`, which is not counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prob = _problem("cuda", torch.float32)
    settings = dataclasses.replace(_settings(prob, "block"),
                                   norm_method="power")
    inputs = _inputs(prob, 8)
    _solve(prob, settings, inputs)           # builds and loads the kernels
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, delta = _solve(prob, settings, inputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    where = sorted({f"{w.filename}:{w.lineno}" for w in syncs})
    assert delta["sync.refactor"] > 0
    assert len(syncs) == sum(delta[k] for k in SYNCS), where
