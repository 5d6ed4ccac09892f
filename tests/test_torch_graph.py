"""engine/graph.py on the CPU: the engagement rule and the variant key as
pure functions, the cycle's clock as the one input a replay changes, and
the replay machinery (static inputs, fresh outputs, the launch counters'
bookkeeping) with a stand-in for torch.cuda.CUDAGraph
that re-runs the captured cycle. The graphs themselves run on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from intent_mpc_torch.benchmark.capture import fused
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.engine import graph
from intent_mpc_torch.models import mpc as mpclib
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import trace
from intent_mpc_torch.utils.config import small_config
from intent_mpc_torch.utils.tree import flatten, unflatten

COUNTERS = ("closed_loop.graph_captures", "closed_loop.graph_replays",
            "closed_loop.graph_eager")


def _cfg(path="default"):
    cfg = small_config(num_obstacles=4, horizon=8, max_obstacles=4, hist=8)
    return fused(cfg) if path == "fused" else cfg


def _setup(cfg, seeds=(0, 1)):
    scen = sh.stack_scenarios(cfg, list(seeds), device="cpu")
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5)
    return scen, ref, cl.init_carry(cfg, scen, device="cpu")


def _leaves(tree):
    return [t for t in flatten(tree) if isinstance(t, torch.Tensor)]


def _bits(tree):
    return [(t.dtype, tuple(t.shape), t.numpy().tobytes())
            for t in _leaves(tree)]


def _graph_counts():
    c = trace.counters()
    return tuple(c.get(k, 0) for k in COUNTERS)


class ReplayStub:
    """Stands in for graph.CudaGraph on the CPU. `capture(fn)` runs fn once
    and keeps its outputs; `replay()` runs fn again on the same static
    inputs and copies the results into those outputs, as a graph writes
    its static outputs, with the registry's counters put back as they
    were (a replay runs no Python)."""

    def __init__(self, device):
        self.fn = self.out = None

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        saved = trace.counters()
        new = self.fn()
        trace.reset()
        for k, n in saved.items():
            trace.count(k, n)
        for dst, src in zip(_leaves(self.out), _leaves(new)):
            if dst is not src:
                dst.copy_(src)


@pytest.fixture
def stub(monkeypatch):
    """The rule engaged on the CPU, graphs replaced by ReplayStub, an empty
    variant cache and zeroed graph counters."""
    monkeypatch.setattr(graph, "CudaGraph", ReplayStub)
    monkeypatch.setattr(graph, "engages",
                        lambda dev, spans_on, over: not spans_on
                        and over is None)
    graph.clear()
    trace.reset(*COUNTERS)
    yield
    graph.clear()
    trace.reset(*COUNTERS)


# ---------------------------------------------------------------------------
# the rule and the key as pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,spans_on,override,want", [
    ("cuda", False, None, True),
    ("cpu", False, None, False),
    ("meta", False, None, False),
    ("cuda", True, None, False),
    ("cuda", False, lambda qps, warm: None, False),
])
def test_engages_on_cuda_with_spans_off_and_no_override(device, spans_on,
                                                        override, want):
    assert graph.engages(torch.device(device), spans_on, override) is want


@pytest.mark.parametrize("name,want", [
    ("closed_loop.host_reads", True), ("admm.host_reads", True),
    ("clustering.host_reads", True), ("ew_chain.launches", False),
    ("clustering.rounds", False)])
def test_reads_host_by_the_host_read_counters(name, want):
    before = {"ew_chain.launches": 100, name: 2}
    after = dict(before)
    after[name] += 1
    assert graph.reads_host(before, after) is want
    assert graph.reads_host(before, dict(before)) is False
    assert graph.reads_host({}, {name: 1}) is want


@pytest.mark.parametrize("k,cycles,want", [
    (4, (0, 4, 8, 400), True), (4, (1, 2, 3, 5, 399), False),
    (1, (0, 1, 2, 3), True), (4, (None,), True)])
def test_refresh_cycle(k, cycles, want):
    cfg = _cfg().planner
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, factor_reuse_cycles=k))
    assert all(mpclib.refresh_cycle(cfg, i) is want for i in cycles)


@pytest.mark.parametrize("solver", [
    dict(fused_solve=True), dict(woodbury_candidates=True),
    dict(shared_factor=False)])
def test_refresh_cycle_is_every_cycle_off_the_shared_factor_path(solver):
    """The fused, Woodbury and per-candidate paths factor every cycle and
    never take _shared_factor's reuse, so every cycle is a refresh cycle
    there: one graph variant, not two."""
    cfg = _cfg().planner
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, factor_reuse_cycles=4, **solver))
    assert all(mpclib.refresh_cycle(cfg, i) for i in range(9))


def test_variant_key_by_value_and_by_structure():
    """Equal configurations (a copy) and equal structures give one key;
    the refresh branch, a None leaf, a shape, a dtype, a stride, a Python
    value and cuBLAS's TF32 setting each give another. The tensors come
    back in order."""
    cfg = _cfg()
    scen, ref, carry = _setup(cfg)
    occ = empty_grid()

    def key(c=cfg, refresh=True, carry=carry, traj_len=ref.shape[0],
            scen=scen):
        return graph.variant_key((c, None, refresh),
                                 (scen, ref, traj_len, occ, carry, None,
                                  None))[0]
    k0 = key()
    assert key(c=dataclasses.replace(cfg)) == k0
    assert hash(key(c=dataclasses.replace(cfg))) == hash(k0)
    other = cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                max_iter=31)))
    assert key(c=other) != k0
    assert key(refresh=False) != k0
    assert key(carry=carry._replace(
        stall_cycles=torch.zeros((2,), dtype=torch.int32))) != k0
    assert key(carry=carry._replace(pos=torch.zeros((2, 4)))) != k0
    assert key(carry=carry._replace(
        pos=carry.pos.to(torch.float64))) != k0
    assert key(carry=carry._replace(pos=carry.pos.t().contiguous().t())) \
        != k0
    assert key(traj_len=ref.shape[0] - 1) != k0
    assert key(traj_len=float(ref.shape[0])) != k0
    _, _, carry3 = _setup(cfg, seeds=(0, 1, 2))
    assert key(carry=carry3) != k0
    mm = torch.backends.cuda.matmul
    tf32 = mm.allow_tf32
    try:
        mm.allow_tf32 = not tf32
        assert key() != k0
    finally:
        mm.allow_tf32 = tf32
    assert key() == k0

    tree = (scen, ref, 5, occ, carry, None, None)
    leaves = graph.variant_key(None, tree)[1]
    assert leaves == flatten(tree) and leaves[len(flatten(scen)) + 1] == 5


def test_tree_round_trip_keeps_tuples_values_and_none():
    """utils/tree over a cycle's arguments: plain tuples come back as
    tuples, NamedTuples as their own type, a None field as None and a
    value that is not a tensor as itself, every leaf in its place."""
    cfg = _cfg()
    scen, ref, carry = _setup(cfg)
    tree = (scen, ref, 5, empty_grid(), carry, None, (None, 2.5))
    leaves = flatten(tree)
    back = unflatten(tree, leaves)
    assert type(back) is tuple and type(back[4]) is cl.EngineCarry
    assert back[2] == 5 and back[5] is None and back[6] == (None, 2.5)
    assert [id(x) for x in flatten(back)] == [id(x) for x in leaves]
    with pytest.raises(ValueError):
        unflatten(tree, leaves + [1])


def test_clock_is_the_cycle_as_float32():
    for i in (0, 7, 199, 2 ** 20 + 1):
        c = graph.clock(i, "cpu")
        assert c.dtype == torch.float32 and c.shape == ()
        assert torch.equal(c, torch.full((), float(i), dtype=torch.float32))


# ---------------------------------------------------------------------------
# the clock: the one per-cycle input a replay writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,captured,later", [
    ("default", 1, 9), ("default", 4, 8), ("fused", 1, 6)])
def test_a_cycle_run_under_another_index_with_its_clock_is_bit_equal(
        path, captured, later):
    """The cycle that a graph captured at cycle `captured` replays at cycle
    `later` (same refresh branch) is the eager cycle `later`: the clock
    carries the index into the arithmetic, cycle_idx only the branch."""
    cfg = _cfg(path)
    scen, ref, carry = _setup(cfg)
    occ = empty_grid()
    for i in range(later):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry,
                                   i)
    want = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, later)
    assert mpclib.refresh_cycle(cfg.planner, captured) == \
        mpclib.refresh_cycle(cfg.planner, later)
    got = cl._cycle(cfg, scen, ref, ref.shape[0], occ, carry, captured,
                    graph.clock(later, "cpu"), None, None, None, None)
    assert _bits(got) == _bits(want)


# ---------------------------------------------------------------------------
# the replay machinery, with ReplayStub in the graph's place
# ---------------------------------------------------------------------------

def _fly(cfg, cycles, flight=None):
    """`cycles` cycles from init_carry, a new flight (init_carry again) at
    cycle `flight`: the carries returned, each input's bits before its
    cycle, and snapshots of each returned carry."""
    scen, ref, carry = _setup(cfg)
    occ = empty_grid()
    out, before, snaps = [], [], []
    i = 0
    for n in range(cycles):
        if n == flight:
            carry, i = cl.init_carry(cfg, scen, device="cpu"), 0
        before.append((carry, _bits(carry)))
        carry, pos = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                     carry, i)
        assert pos is carry.pos
        out.append(carry)
        snaps.append(_bits(carry))
        i += 1
    return out, before, snaps


@pytest.mark.parametrize("path", ["default", "fused"])
def test_replayed_cycles_are_the_eager_cycles(stub, path):
    """12 cycles over a refresh, reuse cycles and a new flight, through
    graph.run with ReplayStub: every carry has the eager cycle's bits,
    every input carry is left as it was, every returned carry still holds
    its bits 8 and more cycles later, and each cycle counts once as
    eager, captured or replayed."""
    cfg = _cfg(path)
    graph.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "engages", lambda *a: False)
        plain, _, _ = _fly(cfg, 12, flight=9)
    assert _graph_counts() == (0, 0, 0)     # the CPU counts nothing
    got, before, snaps = _fly(cfg, 12, flight=9)
    for i, (a, b) in enumerate(zip(plain, got)):
        assert _bits(a) == _bits(b), i
    for i, (carry, bits) in enumerate(before):
        assert _bits(carry) == bits, i
    for i, (carry, bits) in enumerate(zip(got, snaps)):
        assert _bits(carry) == bits, i
    captures, replays, eager = _graph_counts()
    assert captures + replays + eager == 12
    if path == "default":
        # refresh at 0, 4, 8 and the new flight's 0 (cycle 9); reuse else
        assert (captures, eager) == (2, 2)
    else:
        # the fused path factors every cycle: one variant
        assert (captures, eager) == (1, 1)


def test_unchanged_leaves_are_the_callers_own(stub):
    """A leaf the cycle returns unchanged (repeats_left without path
    repetition, the fused path's carried factor) is the caller's own
    tensor on a replay, as it is on an eager cycle; every other leaf
    shares no memory with the caller's carry."""
    cfg = _cfg("fused")
    scen, ref, carry = _setup(cfg)
    occ = empty_grid()
    same = []
    for i in range(4):
        new, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i)
        pairs = list(zip(_leaves(new), _leaves(carry)))
        same.append([a is b for a, b in pairs])
        mine = {b.data_ptr() for b in _leaves(carry)}
        assert all(a.data_ptr() not in mine for a, b in pairs if a is not b)
        assert new.repeats_left is carry.repeats_left
        carry = new
    # cycle 0 ran eagerly, 1 was captured, 2 and 3 replayed
    assert _graph_counts() == (1, 2, 1)
    assert same[1] == same[2] == same[3] and any(same[1])
    assert not all(same[1])


def test_replays_count_the_captured_kernels_apart(stub):
    """The launch counters count the host's own launches: a capture
    records the registry's change over the captured cycle and takes it
    back (capture executes nothing); a replay adds nothing to them, and
    adds the captured change to "<name>.replayed" instead."""
    names = ("ew_chain.launches", "fleet_admm.launches")
    trace.reset(*names, *(k + ".replayed" for k in names))

    def fn(tree, clock):
        trace.count("ew_chain.launches", 100)
        trace.count("fleet_admm.launches")
        return (tree[0] * clock, tree[1])
    x, y = torch.arange(3.0), torch.ones(2)
    for i in range(5):
        out = graph.run(("k",), (x, y), i, fn)
        assert torch.equal(out[0], x * i) and out[1] is y
        c = trace.counters()
        assert (c["ew_chain.launches"], c["fleet_admm.launches"]) == (100, 1)
        assert (c.get("ew_chain.launches.replayed", 0),
                c.get("fleet_admm.launches.replayed", 0)) == (100 * i, i)
    assert _graph_counts() == (1, 3, 1)


def test_a_variant_that_reads_the_host_stays_eager(stub):
    """A variant whose first run counted a host read runs eagerly ever
    after and is never captured."""
    runs = []

    def fn(tree, clock):
        runs.append(float(clock))
        trace.count("admm.host_reads")
        return (tree[0] + clock,)
    x = torch.zeros(2)
    for i in range(4):
        assert torch.equal(graph.run(("r",), (x,), i, fn)[0], x + i)
    assert runs == [0.0, 1.0, 2.0, 3.0]
    assert _graph_counts() == (0, 0, 4)


def test_spans_on_keep_the_cycle_eager(stub):
    """Recording spans keeps every cycle eager (no variant is remembered)
    and records a cycle span for each."""
    cfg = _cfg()
    scen, ref, carry = _setup(cfg)
    trace.start()
    try:
        for i in range(3):
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0],
                                       empty_grid(), carry, i)
    finally:
        spans = trace.stop()
    assert [s.cycle for s in spans if s.name == "cycle"] == [0, 1, 2]
    assert _graph_counts() == (0, 0, 0) and len(graph._variants) == 0
