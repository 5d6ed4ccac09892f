"""Benchmark analysis utilities: combine runs, recheck collisions, LaTeX
(port of intent_mpc_tpu/benchmark/analyze.py).

Equivalents of scripts/analyze_mpc_benchmark.py (aggregation lives in
harness.aggregate), scripts/combine_benchmark_runs.py and
scripts/postprocess_collisions.py. The reference's rosbag-replay collision
recheck becomes an exact closed-form recheck: the obstacle world is an
analytic function of time (models/world.obstacle_state), so a recorded
flight path can be re-validated against ground truth at any resolution
without any recorded bags.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import List, Sequence

import torch

from intent_mpc_torch.models.world import Scenario, obstacle_state


def load_rows(path: str) -> List[dict]:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        for k, v in r.items():
            try:
                r[k] = json.loads(v.lower()) if v.lower() in ("true", "false") \
                    else float(v) if "." in v or "e" in v else int(v)
            except (ValueError, AttributeError):
                pass
    return rows


def combine_runs(out_dirs: Sequence[str]) -> List[dict]:
    """Merge trial CSVs from multiple runs (combine_benchmark_runs.py),
    re-numbering trial ids."""
    rows: List[dict] = []
    for d in out_dirs:
        for path in sorted(glob.glob(os.path.join(d, "trials.csv"))):
            rows.extend(load_rows(path))
    for i, r in enumerate(rows):
        r["trial_id"] = i
    return rows


def recheck_collisions(scenario: Scenario, path, cycle_dt: float,
                       upsample: int = 10):
    """Post-hoc collision recheck (postprocess_collisions.py): re-evaluate
    the analytic obstacle world along an upsampled recorded path.

    scenario: one scenario's (N, ...) tensors; path (C, 3) per-cycle
    positions (array or tensor). The world is evaluated at every sample
    time at once, on the scenario's device. Returns (collided,
    min_distance)."""
    dev = scenario.origin.device
    path = torch.as_tensor(path, dtype=torch.float32, device=dev)
    C = path.shape[0]
    k = torch.arange(C * upsample, device=dev)
    ts = k.to(torch.float32) * (cycle_dt / upsample)
    fr = (k % upsample).to(torch.float32) / upsample
    i0 = torch.clamp(k // upsample, max=C - 1)
    i1 = torch.clamp(i0 + 1, max=C - 1)
    pts = path[i0] * (1 - fr)[:, None] + path[i1] * fr[:, None]   # (T, 3)
    obs, _ = obstacle_state(scenario, ts[:, None])                # (T, N, 3)
    gap = torch.clamp(torch.abs(pts[:, None, :] - obs) - scenario.bbox / 2.0,
                      min=0.0)
    dmin = torch.amin(torch.linalg.vector_norm(gap, dim=-1), dim=-1)
    return bool(torch.any(dmin <= 0.0)), float(torch.min(dmin))


def latex_table(agg: dict) -> str:
    """Summary LaTeX row (analyze_mpc_benchmark.py table output)."""
    return (
        "Success & Collision & Travel [s] & Path eff. & "
        "$v$ viol. & $a$ viol. \\\\\n"
        f"{agg['success_rate']*100:.1f}\\% & "
        f"{agg['collision_rate']*100:.1f}\\% & "
        f"{agg.get('avg_travel_time', 0):.1f} & "
        f"{agg.get('avg_path_efficiency', 0):.3f} & "
        f"{agg.get('vel_violation_rate', 0)*100:.1f}\\% & "
        f"{agg.get('acc_violation_rate', 0)*100:.1f}\\% \\\\")
