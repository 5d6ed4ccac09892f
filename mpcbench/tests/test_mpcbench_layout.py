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
    bad = json.loads(json.dumps(cfg))
    bad["planner"]["no_such_field"] = 1
    with pytest.raises(KeyError):
        hz.program_config(bad)
    del bad["planner"]["no_such_field"], bad["planner"]["horizon"]
    with pytest.raises(KeyError):
        hz.program_config(bad)


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


def _files(d):
    out = []
    for base, _, names in os.walk(d):
        for n in names:
            if "__pycache__" not in base:
                out.append(os.path.relpath(os.path.join(base, n), d))
    return out
