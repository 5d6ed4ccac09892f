"""mpcbench/spans.py: the split of a traced window by the program's spans,
on hand-made records and on a tiny version of each cell on the CPU."""

from __future__ import annotations

import math

import pytest
import torch

from mpcbench_cells import tiny_cell

STAGES = ("perceive", "predict", "plan", "solve", "factor", "ticks")


def _spans():
    # two cycles: (name, parent, cycle, start_ns, end_ns)
    return [("cycle", -1, 0, 100, 200),
            ("perceive", 0, 0, 105, 120),
            ("predict", 0, 0, 120, 130),
            ("plan", 0, 0, 130, 180),
            ("solve", 3, 0, 140, 170),
            ("factor", 4, 0, 145, 150),
            ("ticks", 0, 0, 182, 198),
            ("cycle", -1, 1, 210, 300),
            ("perceive", 7, 1, 212, 220),
            ("predict", 7, 1, 220, 225),
            ("plan", 7, 1, 225, 280),
            ("solve", 10, 1, 230, 270),
            ("ticks", 7, 1, 281, 299)]


def test_split_adds_up():
    """The stages' idle plus the idle outside every span is the window's
    idle, exactly; the stages' self time (cycle's glue among them) is the
    cycle spans' total; launches fall where the host started them."""
    from mpcbench import spans as sp
    ops = [(90, 20, "a"), (125, 30, "b"), (150, 10, "c"), (205, 40, "d"),
           (290, 30, "e")]
    runtime = [95, 106, 121, 141, 146, 146, 185, 205, 231, 299]
    got = sp.stages(_spans(), ops, (80, 330), runtime)
    st = got["stages"]
    assert set(st) == {"cycle"} | set(STAGES)
    # busy [90,110) [125,160) [205,245) [290,320): idle 250 - 125 = 125
    idle = sum(v["idle_ms"] for v in st.values()) + got["outside_idle_ms"]
    assert idle * 2e6 == pytest.approx(125, abs=1e-9)
    assert got["idle_ms"] * 2e6 == pytest.approx(125, abs=1e-9)
    # idle outside the cycles: [80,90) [200,205) [320,330)
    assert got["outside_idle_ms"] * 2e6 == pytest.approx(10 + 5 + 10)
    assert sum(v["self_ms"] for v in st.values()) == \
        pytest.approx(got["cycle_ms"])
    assert got["cycle_ms"] * 2e6 == pytest.approx(100 + 90)
    # self: plan (130,140)+(170,180) and (225,230)+(270,280)
    assert st["plan"]["self_ms"] * 2e6 == pytest.approx(35)
    assert st["solve"]["self_ms"] * 2e6 == pytest.approx(25 + 40)
    # idle of the factor (145,150): busy by b; of perceive (105,120):
    # idle (110,120) and (212,220) minus busy (205,245): 10
    assert st["factor"]["idle_ms"] == 0
    assert st["perceive"]["idle_ms"] * 2e6 == pytest.approx(10)
    # launches at 106 (perceive), 121 (predict), 141 (solve), 146 x2
    # (factor), 185 (ticks), 231 (solve), 299 (cycle glue: ticks end
    # there); 95 and 205 outside the cycles
    assert st["factor"]["launches"] * 2 == 2
    assert st["solve"]["launches"] * 2 == 2
    assert st["ticks"]["launches"] * 2 == 1
    assert st["cycle"]["launches"] * 2 == 1
    assert got["outside_launches"] * 2 == 2
    total = sum(v["launches"] for v in st.values()) + got["outside_launches"]
    assert total * 2 == len(runtime)


def test_split_without_runtime_events_or_spans():
    from mpcbench import spans as sp
    got = sp.stages(_spans(), [], (100, 300))
    assert all(v["launches"] is None for v in got["stages"].values())
    assert got["outside_launches"] is None
    assert sp.stages([], [(0, 1, "a")], (0, 10)) is None


@pytest.mark.parametrize("workload", ["dynus200-default.batch128",
                                      "dynus200-fused.batch128",
                                      "dynus200-fused.rt32"])
def test_tiny_cell_split(workload):
    """A CPU run of each tiny cell: every stage has a finite non-negative
    self time per cycle, the stages sum to the cycle spans, tracing left
    the same operation count in its sub-window."""
    from mpcbench import spans as sp
    out = sp.measure(tiny_cell(workload), 2 ** 31 + 17, 0.4,
                     torch.device("cpu"))
    split = out["split"]
    assert split["cycles"] == 4
    for name in STAGES + ("cycle",):
        v = split["stages"][name]["self_ms"]
        assert math.isfinite(v) and v >= 0, name
    assert sum(v["self_ms"] for v in split["stages"].values()) == \
        pytest.approx(split["cycle_ms"], rel=1e-9)
    assert [w["self_ms"] is not None for w in out["windows"]] == \
        [False, True, True, False]
    for w in out["windows"][1:3]:
        # a short window may hold no factor refresh of the default path
        assert set(w["self_ms"]) | {"factor"} == set(split["stages"])
    assert math.isfinite(out["tracing_cost_pct"])
    lpc = out["launches_per_cycle"]
    assert lpc["spans_on"] == lpc["spans_off"]
