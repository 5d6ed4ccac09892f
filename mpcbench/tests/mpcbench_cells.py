"""Helpers of the benchmark's tests: the repository root on the path and
a tiny version of a cell that the harness can drive on the CPU."""

from __future__ import annotations

import copy
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(workload: str) -> dict:
    """The cell of BENCHMARK.json cut to a size the CPU runs in seconds:
    8 obstacles, horizon 10, 8 slots, 30 iterations, 2 worlds per block,
    5-cycle flights (so a window restarts flights)."""
    from mpcbench import harness as hz
    c = hz.cell(hz.load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)
    c = copy.deepcopy(c)
    cfg = c["config"]
    cfg["world"]["num_obstacles"] = 8
    cfg["detector"]["history_size"] = 12
    cfg["predictor"]["num_pred"] = 10
    cfg["planner"]["horizon"] = 10
    cfg["planner"]["max_obstacles"] = 8
    cfg["planner"]["solver"]["max_iter"] = 30
    c["traffic"].update(scenarios=2, blocks=2, episode_cycles=5, samples=3,
                        reference_chunk=2, trace_cycles=4)
    return c


def tiny_args(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 1.5,
              trace: int = 0, cycles=None):
    """run.py's arguments; `cycles` makes the window that many cycles
    (the CPU's pace varies under parallel workers)."""
    return types.SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                                 trace=trace, cycles=cycles)
