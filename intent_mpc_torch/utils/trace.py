"""The port's tracing: spans at the stage boundaries of a replan cycle, and
one registry of counters.

Spans. `span(name)` is a context manager. Tracing is off by default: then
`span` returns one shared no-op context, allocates nothing, calls no CUDA
API and never synchronizes. A caller turns it on with `start()` and takes
the spans with `stop()`. While it is on, each span appends a record

    (name, parent, cycle, start_ns, end_ns)

to an in-memory list: `parent` is the list index of the span that was
open when it opened (-1 for none), `cycle` the cycle index given to the
enclosing `span("cycle", cycle)` (-1 outside a cycle). Times are
`time.time_ns()`, the clock of `torch.profiler`'s kineto events (its
device events included), so spans and a device trace share one timeline.
An end time is the host's: the work a span enqueued may still run on the
device after it closes.

The spans of `engine/closed_loop.episode_step`, at most 8 per cycle:

    cycle     the whole of episode_step
    perceive  detector update and history query, monitor, goal-mode and
              static rows, goal relax
    predict   models/predictor.predict
    plan      models/mpc.make_plan_with_pred / make_plan: assembly,
              scoring, choice and state update around
    solve     the candidate solve: fleet_admm, or the (shared) factor and
              admm_solve
    factor    ops/admm.admm_factor, inside solve
    ticks     the control ticks: trajectory sampling, controller, plant,
              history pushes, monitor

A stage's self time is its span's duration less its children's (`self_ms`).

Counters. `count(name, n)` adds to one process-wide registry, always on;
`counters()` reads it and `reset()` clears it. The names:

    ew_chain.launches       ops/ew_chain kernel launches by the host
    fleet_admm.launches     ops/fleet kernel launches by the host
    dense_loop.launches     ops/dense_loop kernel launches by the host
    constraint_op.launches  ops/constraint_op kernel launches by the host
                            (admm_solve: 5 per default-path iteration and
                            1 for its first z)
    admm.host_reads         all-done flag reads of truncation="osqp" solves
    closed_loop.host_reads  the composed goal modes' build-flag reads
    clustering.host_reads   DBSCAN changed-flag reads
    clustering.rounds       DBSCAN label-propagation rounds
    closed_loop.graph_captures  cycles captured into a CUDA graph
    closed_loop.graph_replays   cycles replayed from one
    closed_loop.graph_eager     cycles on a CUDA device run eagerly
                                (engine/graph.py says when)
    <name>.replayed         a counter's change over a cycle captured into a
                            CUDA graph, once per replay of it (the kernels
                            the replays held; the device record sees them
                            run, and <name> counts none of them)
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple


class Span(NamedTuple):
    name: str
    parent: int
    cycle: int
    start_ns: int
    end_ns: int


_on = False
_spans: List[list] = []     # [name, parent, cycle, start_ns, end_ns]
_open: List[int] = []       # indices of the open spans, innermost last
_counts: Dict[str, int] = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "cycle")

    def __init__(self, name: str, cycle):
        self.name, self.cycle = name, cycle

    def __enter__(self):
        parent = _open[-1] if _open else -1
        cycle = self.cycle
        if cycle is None:
            cycle = _spans[parent][2] if parent >= 0 else -1
        _open.append(len(_spans))
        _spans.append([self.name, parent, cycle, time.time_ns(), 0])
        return None

    def __exit__(self, *exc):
        _spans[_open.pop()][4] = time.time_ns()
        return False


def span(name: str, cycle=None):
    """A context that records one span while tracing is on; `cycle` marks a
    cycle's outermost span, whose index its children take."""
    if not _on:
        return _OFF
    return _On(name, cycle)


def recording() -> bool:
    """Whether spans are being recorded (between `start()` and `stop()`)."""
    return _on


def start() -> None:
    """Clear the spans and turn tracing on."""
    global _on
    _spans.clear()
    _open.clear()
    _on = True


def stop() -> List[Span]:
    """Turn tracing off and return the spans recorded since `start()`."""
    global _on
    _on = False
    out = [Span(*s) for s in _spans]
    _spans.clear()
    _open.clear()
    return out


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the registry: every counter counted since its last reset."""
    return dict(_counts)


def reset(*names: str) -> None:
    """Zero the named counters, or every counter when none is named."""
    if not names:
        _counts.clear()
    for n in names:
        _counts.pop(n, None)


def self_ms(spans: List[Span]) -> Dict[str, float]:
    """Each span name's self time in ms per cycle (its spans' durations
    less the durations of their children, summed, over the number of
    `cycle` spans)."""
    own = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.end_ns - s.start_ns
    total: Dict[str, float] = {}
    for s, ns in zip(spans, own):
        total[s.name] = total.get(s.name, 0.0) + ns
    cycles = sum(1 for s in spans if s.name == "cycle") or 1
    return {k: v / cycles / 1e6 for k, v in total.items()}
