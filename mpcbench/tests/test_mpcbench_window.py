"""Each mode's window at a tiny size on the CPU, the traced sub-window's
reading, and the measuring command's refusal to run without a card."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from mpcbench_cells import ROOT, tiny_args, tiny_cell


def _run(workload, **kw):
    import time
    from mpcbench import run as R
    c = tiny_cell(workload)
    R.T_START = time.perf_counter()     # as a fresh process starts the cell
    return c, R.run_cell(c, tiny_args(workload, **kw), torch.device("cpu"))


def test_batch_window_arithmetic():
    c, (res, rows) = _run("dynus200-default.batch128", cycles=12)
    assert res["correct"] is True, res["checks"]
    S = c["traffic"]["scenarios"]
    sps = res["metrics"]["solves_per_s"]["value"]
    assert set(res["metrics"]) == {"solves_per_s", "setup_s"}
    # attempted replans: every scenario every cycle (none reaches the goal)
    cycles = res["attempted"] // S
    assert res["attempted"] == cycles * S and cycles == 12
    assert res["failed"] == 0
    assert sps == pytest.approx(S * 6 * cycles / (S * 6 * cycles / sps))
    assert 0 < res["metrics"]["setup_s"]["value"] < 120
    assert list(res)[-1] == "checks"
    assert {n for n, _, _ in rows} >= {"plan_state_p50", "plant_m", "detector_pos_m",
                                       "factor_minv_rel", "flag_mismatches"}


def test_replan_window_and_trace():
    c, (res, _) = _run("dynus200-fused.rt32", seconds=1.5, trace=1)
    assert res["correct"] is True, res["checks"]
    # the traced run reports the per-layer metrics it can read (no device
    # operations on the CPU: only the host clock's)
    assert set(res["metrics"]) == {"enqueue_ms.rt"}
    assert res["metrics"]["enqueue_ms.rt"]["value"] > 0
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert "factor_minv_rel" not in res["checks"]       # the fused path carries none


def test_replan_percentiles():
    from mpcbench import harness as hz
    mode = hz.load_module("modes", "replan")

    class Fake:
        def __init__(self):
            self.n = 0

        def mark(self):
            return [0, 0]

        def sync(self):
            pass

        def step(self):
            import time
            self.n += 1
            time.sleep(0.001 * (self.n % 5))
            return type("C", (), {"pos": torch.zeros(2, 3), "vel": torch.zeros(2, 3)})()

        def counters(self, start):
            return self.n * 2, 0
    w = mode.window(Fake(), 0.3, {"scenarios": 2})
    assert w["cycles"] >= 20 and len(w["enqueue_s"]) == w["cycles"]
    assert w["metrics"]["replan_p50_ms"] <= w["metrics"]["replan_p95_ms"] < 10


def test_trace_reading():
    from mpcbench import harness as hz
    ops = [(0, 10, "a"), (5, 10, "b"), (30, 5, "a"), (50, 10, "c")]
    assert hz.busy_seconds(ops) == pytest.approx(30e-9)
    br = hz.breakdown(ops)
    assert br["device_ops"][0] == ["a", 15e-9]
    assert dict(map(tuple, br["idle_gaps"])) == {"launch of a": 15e-9,
                                                 "launch of c": 15e-9}
    assert hz.kernel_time(ops, "a") == (2, 7.5e-9)
    assert hz.kernel_time(ops, "zz") is None


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload",
                          "dynus200-fused.rt32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_command_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to run."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "mpcbench"), tmp_path / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload",
                          "dynus200-fused.rt32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
