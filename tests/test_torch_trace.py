"""utils/trace on the CPU: tracing leaves the closed loop bit for bit as
it was, the spans of a cycle nest as utils/trace says, self time is
duration less children, spans share the profiler's clock, and the
counter registry."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from intent_mpc_torch.benchmark.capture import fused
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import trace
from intent_mpc_torch.utils.config import small_config
from intent_mpc_torch.utils.trace import Span

CYCLES = 5
STAGES = ["perceive", "predict", "plan", "ticks"]


def _cfg(path):
    cfg = small_config(num_obstacles=4, horizon=8, max_obstacles=4, hist=8)
    return fused(cfg) if path == "fused" else cfg


def _fly(cfg, traced):
    """CYCLES cycles of two worlds; (carry after each cycle, spans)."""
    scen = sh.stack_scenarios(cfg, [0, 1], device="cpu")
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5)
    carry = cl.init_carry(cfg, scen, device="cpu")
    carries = []
    if traced:
        trace.start()
    try:
        for i in range(CYCLES):
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0],
                                       empty_grid(), carry, i)
            carries.append(carry)
    finally:
        spans = trace.stop()
    return carries, spans


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for t in tree:
            yield from _leaves(t)


@pytest.fixture(scope="module", params=["default", "fused"])
def flights(request):
    cfg = _cfg(request.param)
    return request.param, cfg, _fly(cfg, False), _fly(cfg, True)


def test_tracing_leaves_the_carries_bit_identical(flights):
    """Every leaf of every cycle's carry has the same bits with tracing on
    and off; off, no span is recorded."""
    _, _, (off, off_spans), (on, _) = flights
    assert off_spans == []
    for i, (a, b) in enumerate(zip(off, on)):
        la, lb = list(_leaves(a)), list(_leaves(b))
        assert len(la) == len(lb) > 20
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape, i
            assert x.numpy().tobytes() == y.numpy().tobytes(), i


def test_off_returns_one_shared_context():
    assert trace.span("cycle", 3) is trace.span("plan")
    with trace.span("cycle", 3) as got:
        assert got is None
    assert trace.stop() == []


def test_cycle_spans_nest(flights):
    """One `cycle` span per cycle, carrying its index, with perceive,
    predict, plan and ticks as children in that order; solve inside
    plan; factor inside solve on the default path's refresh cycles and on
    every fused cycle, nowhere else; every span inside its parent."""
    path, cfg, _, (_, spans) = flights
    cycles = [i for i, s in enumerate(spans) if s.name == "cycle"]
    assert [spans[i].cycle for i in cycles] == list(range(CYCLES))
    every = cfg.planner.solver.factor_reuse_cycles
    for c in cycles:
        s = spans[c]
        assert s.parent == -1
        kids = [k for k in spans if k.parent == c]
        assert [k.name for k in kids] == STAGES
        plan = spans.index(kids[2])
        solve = [k for k in spans if k.parent == plan]
        assert [k.name for k in solve] == ["solve"]
        factor = [k for k in spans if k.parent == spans.index(solve[0])]
        refresh = path == "fused" or s.cycle % every == 0
        assert [k.name for k in factor] == (["factor"] if refresh else [])
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.cycle == p.cycle
    assert len(spans) <= 8 * CYCLES


def test_self_time_arithmetic():
    """Self time is the span's duration less its children's, per cycle;
    the stages' self times sum to the cycle spans' total."""
    spans = [Span("cycle", -1, 0, 0, 100_000_000),
             Span("perceive", 0, 0, 10_000_000, 20_000_000),
             Span("plan", 0, 0, 30_000_000, 80_000_000),
             Span("solve", 2, 0, 40_000_000, 70_000_000),
             Span("factor", 3, 0, 45_000_000, 55_000_000),
             Span("ticks", 0, 0, 85_000_000, 95_000_000),
             Span("cycle", -1, 1, 200_000_000, 220_000_000),
             Span("plan", 6, 1, 205_000_000, 215_000_000)]
    got = trace.self_ms(spans)
    assert got == pytest.approx({"cycle": (30 + 10) / 2, "perceive": 5,
                                 "plan": (20 + 10) / 2, "solve": 10,
                                 "factor": 5, "ticks": 5})
    assert sum(got.values()) == pytest.approx((100 + 20) / 2)


def test_spans_share_the_profilers_clock():
    """Under torch.profiler with the CPU activity, a span brackets the
    kineto events of the torch op run inside it."""
    a = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.start()
        try:
            with trace.span("op"):
                torch.mm(a, a)
        finally:
            spans = trace.stop()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(events) == 1 and len(spans) == 1
    e, s = events[0], spans[0]
    assert s.start_ns <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= s.end_ns


def test_counter_registry():
    """count adds under a name, counters reads a copy, reset zeroes the
    named counters or all of them."""
    trace.reset()
    trace.count("a.launches")
    trace.count("a.launches", 3)
    trace.count("b.host_reads")
    got = trace.counters()
    assert got == {"a.launches": 4, "b.host_reads": 1}
    got["a.launches"] = 0
    assert trace.counters()["a.launches"] == 4
    trace.reset("a.launches")
    assert trace.counters() == {"b.host_reads": 1}
    trace.reset()
    assert trace.counters() == {}
