"""The benchmark harness's pieces: the cell's files found by name, the
configuration applied to the program, the flights of a window, the
traced sub-window and its reading.

Everything of one configuration, traffic mix or per-layer metric sits
in a file of its own, found by the names in BENCHMARK.json:

    configs/<config>.json     the configuration as it is run; its "maps"
                              and "stages" name the files below
    traffic/<traffic>.json    the traffic mix; its "mode" names
    modes/<mode>.py           the window's loop and its end-to-end metrics
    maps/<maps>.py            each block's static maps (default "empty")
    stages/<stage>.py         one stage of the check of `correct` (default
                              check.GT_STAGES)
    metrics/<metric>.py       one reader per per-layer metric
    counts/<kernel>.py        a kernel's operations and bytes

A reader's `read(rec)` takes the traced run's record (run.run_cell) and
returns a number, or None where it finds nothing to read. The record:
the traced sub-window's device operations `ops` (start_ns, duration_ns,
name), `busy_s`, `window_s`, `window` (start and end ns on the spans'
clock), `traced_cycles`, the runtime's launch, copy and memset host
starts `runtime`, `counters` (utils/trace's registry, its change over
the traced cycles), `spans` (utils/trace's records, where the traffic or
configuration file sets "spans": true, else None; spans keep a cycle
eager), the window's `enqueue_s`, `scenarios`, `candidates`, `config`,
`peaks`, and `counts(kernel)` and `kernel_time(pattern)`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """mpcbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError("no %s file %s" % (kind, path))
    spec = importlib.util.spec_from_file_location(
        "mpcbench_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic and per-layer metrics."""
    ws = {w["name"]: w for w in bench["workloads"]}
    if workload not in ws:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    w = ws[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    conf = cfgs[w["config"]]
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per_layer = [m for m in bench["per_layer"] if mine(m)]
    return dict(workload=w, config=cfg, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def program_config(cfg: dict):
    """The program's IntentMPCConfig with each of its sections (the fields
    that hold a dataclass) set field by field from the file; a section or
    field that the program lacks, or that the file leaves out, is an
    error."""
    from intent_mpc_torch.utils.config import IntentMPCConfig

    def build(dc, values: dict):
        names = {f.name for f in dataclasses.fields(dc)}
        if set(values) != names:
            raise KeyError("configuration fields differ from %s: %s"
                           % (type(dc).__name__, sorted(set(values) ^ names)))
        kw = {}
        for f in dataclasses.fields(dc):
            v = values[f.name]
            cur = getattr(dc, f.name)
            if dataclasses.is_dataclass(cur):
                v = build(cur, v)
            elif isinstance(cur, tuple):
                v = tuple(v)
            kw[f.name] = v
        return dataclasses.replace(dc, **kw)

    base = IntentMPCConfig()
    sections = [f.name for f in dataclasses.fields(base)
                if dataclasses.is_dataclass(getattr(base, f.name))]
    missing = [s for s in sections if s not in cfg]
    if missing:
        raise KeyError("configuration lacks the sections %s" % missing)
    kw = {s: build(getattr(base, s), cfg[s]) for s in sections}
    return base.replace(start=tuple(cfg["start"]), goal=tuple(cfg["goal"]), **kw)


def maps(cfg: dict, blocks_np, device) -> list:
    """Each block's (occ, veto_occ) as the program takes them, built by
    maps/<name>.py (the file's "maps", default "empty") from the block's
    seeded worlds."""
    from intent_mpc_torch.models.occupancy import OccupancyGrid
    mod = load_module("maps", cfg.get("maps", "empty"))

    def grid(g):
        return None if g is None else OccupancyGrid(**g)
    return [tuple(grid(g) for g in mod.build(cfg, b, device)) for b in blocks_np]


class Flights:
    """The window's flights: blocks of seeded worlds flown for
    `episode_cycles` cycles each, the next block when one ends (back to
    the first after the last), each on its block's maps ((occ,
    veto_occ) pairs). `sampler` sees every cycle."""

    def __init__(self, pcfg, blocks, ref, maps, episode_cycles: int,
                 sampler=None):
        from intent_mpc_torch.engine import closed_loop as cl
        self.cl, self.cfg = cl, pcfg
        self.blocks, self.ref, self.maps = blocks, ref, maps
        self.episode = episode_cycles
        self.sampler = sampler
        self.b, self.i = 0, 0
        self.carry = cl.init_carry(pcfg, blocks[0], device=ref.device)
        self.sums = []          # device counters of finished flights

    def sync(self):
        """Wait for the device (a no-op on the CPU, where the tests run)."""
        import torch
        if self.ref.device.type == "cuda":
            torch.cuda.synchronize()

    def step(self):
        """Enqueue one cycle; returns the new carry."""
        b, i, carry = self.b, self.i, self.carry
        if self.sampler is not None:
            self.sampler.before(b, i, carry)
        occ, veto = self.maps[b]
        new, _ = self.cl.episode_step(self.cfg, self.blocks[b], self.ref,
                                      self.ref.shape[0], occ, carry, i,
                                      veto_occ=veto)
        if self.sampler is not None:
            self.sampler.after(b, i, carry, new)
        self.carry, self.i = new, i + 1
        if self.i == self.episode:
            self._count()
            self.b = (b + 1) % len(self.blocks)
            self.i = 0
            self.carry = self.cl.init_carry(self.cfg, self.blocks[self.b],
                                            device=self.ref.device)
        return new

    def _count(self):
        import torch
        m = self.carry.metrics
        self.sums.append(torch.stack([m.solve_attempts.sum(),
                                      m.solve_successes.sum()]))

    def counters(self, start):
        """(attempted, failed) replans since `start` (this object's
        counters when the window began: a (2,) host list)."""
        import torch
        m = self.carry.metrics
        cur = torch.stack([m.solve_attempts.sum(), m.solve_successes.sum()])
        tot = (torch.stack(self.sums).sum(0) + cur) if self.sums else cur
        a, s = (int(v) for v in tot.cpu())
        a, s = a - start[0], s - start[1]
        return a, a - s

    def mark(self):
        """The counters now, for `counters`."""
        self.sums = []
        m = self.carry.metrics
        return [int(m.solve_attempts.sum()), int(m.solve_successes.sum())]


# the runtime API calls that put work on the device
RUNTIME = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")


def traced(flights: Flights, mode, cycles: int, every: int,
           spans: bool = False) -> dict:
    """Continue the flights to a factor-refresh cycle, then run `cycles`
    cycles as the traffic's mode sends them (`mode.cycle`) under
    torch.profiler's CUDA activity, read in memory, with the program's
    spans recorded when `spans` (they keep a cycle eager). Returns the
    device operations (start_ns, duration_ns, name), the host start
    times of the runtime's launch, copy and memset events, the window
    on the spans' clock (`window`, ns) and its seconds (`window_s`), the
    spans (None when off) and the change of utils/trace's counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from intent_mpc_torch.utils import trace

    while flights.i % every != 0:
        flights.step()
    flights.sync()
    acts = [ProfilerActivity.CUDA if flights.ref.device.type == "cuda"
            else ProfilerActivity.CPU]
    before = trace.counters()
    with profile(activities=acts) as prof:
        if spans:
            trace.start()
        w0 = time.time_ns()
        t0 = time.perf_counter()
        for _ in range(cycles):
            mode.cycle(flights)
        flights.sync()
        window = time.perf_counter() - t0
        w1 = time.time_ns()
        got = trace.stop() if spans else None
    counters = {k: v - before.get(k, 0) for k, v in trace.counters().items()
                if v != before.get(k, 0)}
    cuda = torch.autograd.DeviceType.CUDA
    ops, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ops.append((e.start_ns(), e.duration_ns(), e.name()))
        elif RUNTIME.match(e.name()):
            runtime.append(e.start_ns())
    return dict(ops=sorted(ops), runtime=runtime, window=(w0, w1),
                window_s=window, cycles=cycles, spans=got, counters=counters)


def busy_seconds(ops) -> float:
    """Seconds in which some device operation ran (the union of their
    intervals)."""
    busy, end = 0, None
    for s, d, _ in ops:
        e = s + d
        if end is None or s >= end:
            busy += d
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def breakdown(ops, top: int = 10) -> dict:
    """The device operations with the most time, and the idle gaps summed
    by the operation the device waited for (the host was launching it)."""
    by, gaps = {}, {}
    end = None
    for s, d, n in ops:
        by[n] = by.get(n, 0) + d
        if end is not None and s > end:
            key = "launch of " + n
            gaps[key] = gaps.get(key, 0) + (s - end)
        end = s + d if end is None else max(end, s + d)

    def best(dct):
        return [[k[:120], v / 1e9] for k, v in
                sorted(dct.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(by), "idle_gaps": best(gaps)}


def kernel_time(ops, pattern: str):
    """(launches, mean device seconds) of the operations whose name holds
    `pattern`; None when there are none."""
    ds = [d for _, d, n in ops if pattern in n]
    if not ds:
        return None
    return len(ds), sum(ds) / len(ds) / 1e9


def card(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> Optional[str]:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
