"""The program's own spans of a replan cycle (intent_mpc_torch/utils/trace)
set beside the device trace of a cell: each stage's host self time, the
device idle that falls while the host was in the stage, and the
launches the stage made.

    python3 mpcbench/spans.py --workload <name> --seed <n> --seconds <s>

runs the cell's set-up (run.Prepared), a warm window, then four windows
of `--seconds` as the traffic's mode sends them, tracing off, on, on,
off (the cost of tracing when it is on: the mean host ms per cycle for
episode_step to return, each window; the host ns of one span, off and
on; and each stage's self ms per cycle in the windows with spans, where
no profiler runs), then the harness's traced sub-window (a refresh cycle
on, the traffic's trace_cycles, torch.profiler's CUDA activity) with the
spans on, and the same cycles from the same state again with them off,
and prints one JSON line. It needs a card, like run.py. The profiler's
CUDA activity adds host time to every launch, so the traced split
weighs launch-heavy stages more than the windows' split does.

Arithmetic (`stages`), over the traced sub-window:
- a span's self intervals are its interval less its children's; each
  stage's are the union over its spans, so the stages' self intervals,
  `cycle` (the glue between the stages) among them, partition the cycles;
- self ms per cycle: the length of the stage's self intervals over the
  number of `cycle` spans;
- idle ms per cycle: the window's device idle (the window less the union
  of the device operations' intervals) inside the stage's self
  intervals, so each idle gap is put down to what the host was doing;
  `outside_idle_ms` is the idle outside every span, and the stages' idle
  plus it is the window's idle;
- launches per cycle: the CUDA runtime's launch, copy and memset events of
  the record whose host start lies in the stage's self intervals; None
  when the record holds no runtime event.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


def union(intervals):
    """Sorted, disjoint (start, end) pairs covering the given ones."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def minus(a, b):
    """The parts of sorted disjoint intervals `a` outside sorted disjoint
    intervals `b`."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    tot, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def length(a) -> int:
    return sum(e - s for s, e in a)


def self_intervals(spans):
    """{stage: its self intervals} from (name, parent, cycle, start_ns,
    end_ns) records (utils/trace's)."""
    kids = {}
    for s in spans:
        if s[1] >= 0:
            kids.setdefault(s[1], []).append((s[3], s[4]))
    by = {}
    for i, s in enumerate(spans):
        own = minus([(s[3], s[4])], union(kids.get(i, [])))
        by.setdefault(s[0], []).extend(own)
    return {k: union(v) for k, v in by.items()}


def stages(spans, ops, window, runtime=None) -> dict:
    """The split of a traced window: `spans` utils/trace's records, `ops`
    (start_ns, duration_ns, name) device operations, `window` (start_ns,
    end_ns), `runtime` the host start times of the runtime's launch, copy
    and memset events (None or empty: launches are None)."""
    cycles = sum(1 for s in spans if s[0] == "cycle")
    if not cycles:
        return None
    win = [tuple(window)]
    busy = union((s, s + d) for s, d, _ in ops)
    idle = minus(win, busy)
    starts = sorted(runtime or [])

    def launches(iv):
        if not starts:
            return None
        return sum(bisect.bisect_left(starts, e)
                   - bisect.bisect_left(starts, s) for s, e in iv) / cycles
    out = {name: {"self_ms": length(iv) / cycles / 1e6,
                  "idle_ms": overlap(idle, iv) / cycles / 1e6,
                  "launches": launches(iv)}
           for name, iv in self_intervals(spans).items()}
    roots = union((s[3], s[4]) for s in spans if s[1] < 0)
    return {"cycles": cycles,
            "cycle_ms": length(roots) / cycles / 1e6,
            "idle_ms": length(idle) / cycles / 1e6,
            "outside_idle_ms": length(minus(idle, roots)) / cycles / 1e6,
            "outside_launches": None if not starts else
            len(starts) / cycles - launches(roots),
            "stages": out}


def span_ns(n: int = 100_000) -> dict:
    """Host ns of one empty `with span(...)` block, tracing off and on."""
    from intent_mpc_torch.utils import trace
    out = {}
    for on in (False, True):
        if on:
            trace.start()
        t = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("x"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t) / n
        trace.stop()
    return out


def measure(c: dict, seed: int, seconds: float, dev) -> dict:
    """The cell's windows with tracing off and on, and the split of its
    traced sub-window (see the module's docstring)."""
    from mpcbench import harness as hz
    from mpcbench import run as R
    from intent_mpc_torch.utils import trace

    traffic = c["traffic"]
    pre = R.Prepared(c, seed, dev)
    flights = pre.flights()
    flights.sync()
    pre.mode.window(flights, seconds, traffic)      # warm, not kept
    windows = []
    for on in (False, True, True, False):
        if on:
            trace.start()
        w = pre.mode.window(flights, seconds, traffic)
        spans = trace.stop()
        e = w["enqueue_s"]
        windows.append({"spans": on, "cycles": w["cycles"],
                        "enqueue_ms": 1e3 * sum(e) / len(e),
                        "metrics": w["metrics"],
                        "self_ms": trace.self_ms(spans) if on else None})
    ms = {on: [w["enqueue_ms"] for w in windows if w["spans"] == on]
          for on in (False, True)}
    off, on_ = sum(ms[False]) / 2, sum(ms[True]) / 2
    # the traced sub-window twice from the same state, spans on then off
    while flights.i % pre.every != 0:
        flights.step()
    state = flights.b, flights.i, flights.carry
    tr = hz.traced(flights, pre.mode, traffic["trace_cycles"], pre.every,
                   spans=True)
    flights.b, flights.i, flights.carry = state
    again = hz.traced(flights, pre.mode, traffic["trace_cycles"], pre.every)
    split = stages(tr["spans"], tr["ops"], tr["window"], tr["runtime"])
    cyc = tr["cycles"]
    w0, w1 = tr["window"]
    roots = union((s[3], s[4]) for s in tr["spans"] if s[1] < 0)
    # the clocks agree when the device operations lie in the window and
    # the runtime's events in the cycles (a fetch between cycles aside)
    clock = {"ops_in_window_pct": 100.0 * sum(
                 w0 <= t < w1 for t, _, _ in tr["ops"])
             / max(len(tr["ops"]), 1),
             "runtime_in_cycles_pct": 100.0 * sum(
                 any(s <= t < e for s, e in roots) for t in tr["runtime"])
             / max(len(tr["runtime"]), 1)}
    return {"workload": c["workload"]["name"], "seed": seed,
            "device": hz.card(dev), "power": hz.power_limit(),
            "windows": windows,
            "tracing_cost_pct": 100.0 * (on_ / off - 1.0),
            "span_ns": span_ns(),
            "window_ms": (tr["window"][1] - tr["window"][0]) / cyc / 1e6,
            # the runtime's calls, counted on the host: CUPTI can drop
            # device activity records, so the device events are not exact
            "launches_per_cycle": {"spans_on": len(tr["runtime"]) / cyc,
                                   "spans_off": len(again["runtime"]) / cyc},
            "device_ops_per_cycle": {"spans_on": len(tr["ops"]) / cyc,
                                     "spans_off": len(again["ops"]) / cyc},
            "clock": clock, "split": split}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    from mpcbench import harness as hz
    if not torch.cuda.is_available():
        print("mpcbench: spans.py needs a CUDA device", file=sys.stderr)
        sys.exit(3)
    c = hz.cell(hz.load_json(os.path.join(hz.ROOT, "BENCHMARK.json")),
                args.workload)
    print(json.dumps(measure(c, args.seed, args.seconds,
                             torch.device("cuda"))))


if __name__ == "__main__":
    main()
