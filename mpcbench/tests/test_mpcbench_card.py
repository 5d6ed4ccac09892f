"""On the card: a short run of a cell through the harness at its real
size comes out correct, and each control at the cell's size fails: the
reference in the program's place in TF32 and in bfloat16, and the
program with TF32 on.
Skips where there is no CUDA device."""

from __future__ import annotations

import pytest
import torch

from mpcbench_cells import tiny_args

pytestmark = pytest.mark.cuda


def test_short_cell_run_is_correct(card):
    import os
    from mpcbench_cells import ROOT
    from mpcbench import harness as hz
    from mpcbench import run as R
    c = hz.cell(hz.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                "dynus200-fused.rt32")
    res, rows = R.run_cell(c, tiny_args("dynus200-fused.rt32", seed=4242,
                                        seconds=3.0), card)
    assert res["correct"] is True, rows
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert res["metrics"]["replan_p50_ms"]["value"] > 0


@pytest.mark.parametrize("prec", ["tf32", "bf16"])
def test_control_fails_at_the_cells_size(card, prec):
    import os
    from mpcbench_cells import ROOT
    from mpcbench import check
    from mpcbench import harness as hz
    from mpcbench.reference.solve import Precision
    from mpcbench.run import Prepared
    c = hz.cell(hz.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                "dynus200-fused.rt32")
    pre = Prepared(c, 4243, card)
    sampler = pre.sampler()
    pre.mode.window(pre.flights(sampler), 8.0, c["traffic"])
    samples = sampler.take()
    pre.release()
    ctl = pre.numbers(samples, Precision(prec))
    ok, rows = check.judge(ctl, c["config"]["correct_limits"])
    assert not ok, rows


def test_program_with_tf32_fails(card):
    """The program itself with cuBLAS's TF32 on, its sampled cycles held
    against the reference, is not correct."""
    import os
    from mpcbench_cells import ROOT
    from mpcbench import check, control
    from mpcbench import harness as hz
    c = hz.cell(hz.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                "dynus200-fused.rt32")
    with control.program_tf32():
        pre, _, samples = control.sampled_window(c, 4244, card, 8.0)
    assert not torch.backends.cuda.matmul.allow_tf32
    ok, rows = check.judge(pre.numbers(samples), c["config"]["correct_limits"])
    assert not ok, rows
