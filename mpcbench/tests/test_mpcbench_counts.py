"""The kernel counts equal a hand count at S = 128 (production shapes:
horizon 30, W = 29, K = 64 + 1 slots, n = 385, m = 2510)."""

from __future__ import annotations

import json
import os

from mpcbench_cells import ROOT

from mpcbench import harness as hz

CFG = json.load(open(os.path.join(ROOT, "mpcbench/configs/dynus200-fused.json")))
PEAKS = json.load(open(os.path.join(ROOT, "mpcbench/peaks.json")))


def test_qp_shapes():
    from mpcbench.roofline import qp_shapes
    s = qp_shapes(CFG)
    assert (s["n"], s["m"], s["K"]) == (385, 2510, 65)
    # equalities 8 + 29 * (8 + 9 + 8), bounds 240 + 145, obstacles 29 * 65 * 4
    assert s["nnz"] == 733 + 385 + 7540


def test_ew_chain_hand_count():
    b = hz.load_module("counts", "ew_chain").bound(CFG, 128, 6, PEAKS)
    qps = 768
    assert b["bytes"] == qps * 4 * (3 * 385 + 9 * 2510) == 72_944_640
    assert b["flops"] == qps * (3 * 385 + 10 * 2510)
    assert b["bound_by"] == "bytes"
    assert abs(b["seconds"] - 72_944_640 / 3.35e12) < 1e-15


def test_fleet_admm_hand_count():
    b = hz.load_module("counts", "fleet_admm").bound(CFG, 128, 6, PEAKS)
    n, m, nnz = 385, 2510, 8658
    per_iter = 3 * (4 * nnz + 2 * n * n) + 10 * m + 24 * n
    assert b["flops"] == 768 * 100 * per_iter == 78_918_604_800
    assert b["bytes"] == 4 * (128 * (n * n + 2 * n + m)
                              + 768 * (2 * n + 3 * m + 5 * 29 * 65 + n + m))
    assert b["bound_by"] == "operations"
    assert abs(b["seconds"] - 78_918_604_800 / 67e12) < 1e-15
