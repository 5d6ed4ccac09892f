"""The harness finds a cell's files by name, and a new configuration,
traffic mix or per-layer metric is picked up as new files only."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from mpcbench_cells import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    from mpcbench import harness as hz
    c = hz.cell(BENCH, workload)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    assert hasattr(hz.load_module("modes", c["traffic"]["mode"]), "window")
    for m in c["per_layer"]:
        assert hasattr(hz.load_module("metrics", m["name"]), "read")
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]


def test_program_config_applies_every_field():
    from mpcbench import harness as hz
    cfg = hz.load_json(os.path.join(ROOT, "mpcbench/configs/dynus200-fused.json"))
    p = hz.program_config(cfg)
    assert p.planner.solver.fused_solve and p.planner.max_obstacles == 64
    assert p.real_detector == type(p.real_detector)()     # as the program ships
    mine = json.loads(json.dumps(cfg))
    mine["real_detector"]["max_tracks"] = 16
    assert hz.program_config(mine).real_detector.max_tracks == 16
    bad = json.loads(json.dumps(cfg))
    bad["planner"]["no_such_field"] = 1
    with pytest.raises(KeyError):
        hz.program_config(bad)
    del bad["planner"]["no_such_field"], bad["planner"]["horizon"]
    with pytest.raises(KeyError):
        hz.program_config(bad)
    del mine["real_detector"]
    with pytest.raises(KeyError):
        hz.program_config(mine)


NEW_METRIC = '''
def read(rec):
    return float(len(rec["enqueue_s"]))
'''


def test_new_files_are_picked_up_without_edits(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    per-layer metric as new files and BENCHMARK.json entries; the
    harness finds them and every existing file is byte for byte as it
    was."""
    dst = tmp_path / "mpcbench"
    shutil.copytree(os.path.join(ROOT, "mpcbench"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(dst, p), "rb").read()
              for p in _files(dst)}
    cfg = json.load(open(dst / "configs" / "dynus200-fused.json"))
    cfg["name"] = "dynus200-fused-iters50"
    cfg["planner"]["solver"]["max_iter"] = 50
    json.dump(cfg, open(dst / "configs" / "dynus200-fused-iters50.json", "w"))
    tr = json.load(open(dst / "traffic" / "rt32.json"))
    tr.update(name="rt8", scenarios=8)
    json.dump(tr, open(dst / "traffic" / "rt8.json", "w"))
    (dst / "metrics" / "window_cycles.rt.py").write_text(NEW_METRIC)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][1], name="dynus200-fused-iters50",
                                 file="mpcbench/configs/dynus200-fused-iters50.json"))
    bench["workloads"].append(dict(name="dynus200-fused-iters50.rt8",
                                   config="dynus200-fused-iters50", traffic="rt8",
                                   chips=1, why="test"))
    bench["per_layer"].append(dict(name="window_cycles.rt", unit="cycles",
                                   better="higher", source="host_clock",
                                   layer="engine", moves="replan_p95_ms",
                                   workloads=["dynus200-fused-iters50.rt8"]))
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = ("import json; from mpcbench import harness as hz;"
            "c = hz.cell(hz.load_json('BENCHMARK.json'), 'dynus200-fused-iters50.rt8');"
            "m = hz.load_module('metrics', c['per_layer'][-1]['name']);"
            "print(json.dumps([c['config']['planner']['solver']['max_iter'],"
            " c['traffic']['scenarios'], m.read({'enqueue_s': [1, 2, 3]}),"
            " hz.ROOT]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    it, s, v, root = json.loads(out.stdout)
    assert (it, s, v) == (50, 8, 3.0) and root == str(tmp_path)
    after = {p: open(os.path.join(dst, p), "rb").read() for p in before}
    assert after == before


# a real-perception configuration's own files, as a later configuration
# brings them: maps from each block's worlds, a perception stage reading
# the track table, a per-layer metric reading spans and counters
REAL_MAPS = """
import numpy as np
import torch

RES = 1.0
LO = (0.0, -16.0, 0.0)
SHAPE = (112, 32, 8)


def build(cfg, block, device):
    # each world's static boxes as solid voxels (voxel centres inside)
    c = [LO[a] + RES * (np.arange(SHAPE[a]) + 0.5) for a in range(3)]
    g = np.zeros((block["origin"].shape[0],) + SHAPE, dtype=np.int8)
    for s in range(g.shape[0]):
        for o, b in zip(block["origin"][s][block["is_static"][s]],
                        block["bbox"][s][block["is_static"][s]]):
            m = [np.abs(c[a] - o[a]) <= b[a] / 2 for a in range(3)]
            g[s] |= (m[0][:, None, None] & m[1][None, :, None]
                     & m[2][None, None, :]).astype(np.int8)
    grid = dict(grid=torch.as_tensor(g, device=device),
                origin=torch.tensor(LO, dtype=torch.float32, device=device),
                resolution=torch.tensor(RES, dtype=torch.float32, device=device))
    return grid, grid
"""

REAL_STAGE = """
import torch

READS = dict(track_pos_hist="real_det.pos_hist", track_vel_hist="real_det.vel_hist",
             track_hist_len="real_det.hist_len", track_size="real_det.tracks.size")
NUMBERS = ("real_track_slots", "real_tracks_with_history")


def gaps(c, prog):
    S, T = prog["track_hist_len"].shape
    return {"real_track_slots": [float(T)] * S,
            "real_tracks_with_history": (prog["track_hist_len"] > 0).sum(1).double().tolist()}


def control(c):
    return {}


def obstacles(c, st, cycle):
    robot = torch.tensor(c.cfg["detector"]["robot_size"], dtype=c.prec.dtype,
                         device=c.dev)
    ph = st["track_pos_hist"]
    return dict(pos_hist=ph, vel_hist=st["track_vel_hist"],
                size_hist=(st["track_size"] + robot)[:, :, None].expand(ph.shape),
                hist_len=st["track_hist_len"], visible=st["track_hist_len"] > 0)
"""

REAL_METRIC = """
def read(rec):
    spans = rec["spans"]
    if not spans or not rec["counters"].get("clustering.host_reads"):
        return None
    own = [s for s in spans if s[0] == "perceive"]
    return sum(s[4] - s[3] for s in own) / 1e6 / len(own)
"""

REAL_RUN = """
import json, sys
sys.path.insert(0, "mpcbench/tests")
import torch
from mpcbench_cells import tiny_args, tiny_cell
from mpcbench import run as R
from intent_mpc_torch.engine import closed_loop as cl
seen = []
step = cl.episode_step


def spy(cfg, scen, ref, L, occ, carry, i, *a, **k):
    veto = k.get("veto_occ")
    seen.append([list(occ.grid.shape), int(occ.grid.sum()),
                 None if veto is None else list(veto.grid.shape)])
    return step(cfg, scen, ref, L, occ, carry, i, *a, **k)


cl.episode_step = spy
w = "dynus-real-test.rt32"
res, rows = R.run_cell(tiny_cell(w), tiny_args(w, cycles=6, trace=1),
                       torch.device("cpu"))
print(json.dumps(dict(result=res, seen=seen)))
"""


def test_a_real_perception_configuration_needs_files_only(tmp_path):
    """A copy of the benchmark gains a real-perception configuration (the
    detector on the depth camera, its own real_detector section), a maps
    file, a perception stage and a per-layer metric as new files and
    BENCHMARK.json entries; run_cell flies it on the CPU at a tiny size:
    the maps reach episode_step, the stage sees the track table and hands
    the plan its obstacle input, the metric reads a perceive span, and
    every existing file is byte for byte as it was."""
    dst = tmp_path / "mpcbench"
    shutil.copytree(os.path.join(ROOT, "mpcbench"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(dst, p), "rb").read()
              for p in _files(dst)}
    cfg = json.load(open(dst / "configs" / "dynus200-fused.json"))
    cfg["name"] = "dynus-real-test"
    cfg["engine"]["use_fake_detector"] = False
    cfg["real_detector"].update(im_h=32, im_w=48, fx=40.0, fy=40.0, cx=24.0,
                                cy=16.0, max_tracks=16, max_detections=16,
                                static_map_veto=True)
    cfg.update(maps="test_boxes", stages=["real_tracks", "plan"], spans=True,
               correct_limits={"real_track_slots": 16, "plan_state_p50": 1e9})
    json.dump(cfg, open(dst / "configs" / "dynus-real-test.json", "w"))
    (dst / "maps" / "test_boxes.py").write_text(REAL_MAPS)
    (dst / "stages" / "real_tracks.py").write_text(REAL_STAGE)
    (dst / "metrics" / "perceive_ms.test.py").write_text(REAL_METRIC)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][1], name="dynus-real-test",
                                 file="mpcbench/configs/dynus-real-test.json"))
    bench["workloads"].append(dict(name="dynus-real-test.rt32",
                                   config="dynus-real-test", traffic="rt32",
                                   chips=1, why="test"))
    bench["per_layer"].append(dict(name="perceive_ms.test", unit="ms/cycle",
                                   better="lower", source="program_span",
                                   layer="detector", moves="replan_p95_ms",
                                   workloads=["dynus-real-test.rt32"]))
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    out = subprocess.run([sys.executable, "-c", REAL_RUN], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res, seen = got["result"], got["seen"]
    # every cycle flew on its block's own grid of static boxes, with the veto
    assert seen and all(s[0] == [2, 112, 32, 8] and s[2] == s[0] and s[1] > 0
                        for s in seen)
    assert res["checks"]["real_track_slots"]["value"] == 16.0
    assert res["checks"]["plan_state_p50"]["value"] >= 0
    assert res["metrics"]["perceive_ms.test"]["value"] > 0
    after = {p: open(os.path.join(dst, p), "rb").read() for p in before}
    assert after == before


def _files(d):
    out = []
    for base, _, names in os.walk(d):
        for n in names:
            if "__pycache__" not in base:
                out.append(os.path.relpath(os.path.join(base, n), d))
    return out
