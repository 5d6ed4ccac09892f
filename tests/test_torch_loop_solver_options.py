"""Port parity: the closed loop with the solver options of slice 9 (the
flat iteration, stationary refinement, the drift-aware factor refresh),
per cycle against the JAX package from identical carries, as
tests/test_torch_loop_options.py holds the engine options; and the
drift-aware refresh's per-scenario decision."""

import pytest
import torch

from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.models.occupancy import empty_grid

from test_torch_loop_options import (CYCLES, SOLVER_CASES, _torch_setup,
                                     check_case)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_option_episode_steps_match_jax(case, tmp_path):
    """test_torch_loop_options.check_case on the solver options' cases:
    3 cycles against JAX, positions and velocities within 1e-4 (the
    stationary case 1e-4 + 1e-4 |x|), equal solve counts."""
    check_case(case, tmp_path)


def test_drift_refresh_decides_per_scenario():
    """With factor_drift_refresh the refresh is decided per scenario on
    the device. From the drift_refresh case's carry: cycle 0 refreshes
    every factor (the every-4th rule), cycle 1 too (the snapshot taken at
    cycle 0, with no obstacle rows, is empty), and at cycle 2 DRIFT_T
    splits the scenarios (relative drifts 0.022 and 0.014 in the port):
    scenario 0 refreshes, scenario 1 keeps its carried factor. The carried
    gradient snapshot moves exactly where a factor was refreshed from
    cycle 1 on."""
    from intent_mpc_torch.models import mpc as mpclib
    tcfg, tsc, tref, tc = _torch_setup("drift_refresh")
    seen = []
    plan = mpclib.make_plan_with_pred

    def record(*a, **k):
        out = plan(*a, **k)
        seen.append(out.refreshed)
        return out
    mpclib.make_plan_with_pred = record
    try:
        for i in range(CYCLES):
            before = tc
            tc, _ = tcl.episode_step(tcfg, tsc, tref, int(tref.shape[0]),
                                     empty_grid(), tc, i)
            moved = (tc.planner.fac_gref
                     != before.planner.fac_gref).flatten(1).any(1)
            if i > 0:
                ran = seen[-1] & ~before.done & ~before.stopping
                assert torch.equal(moved, ran), (i, moved, seen[-1])
            unchanged = ~seen[-1]
            assert torch.equal(tc.planner.fac_minv[unchanged],
                               before.planner.fac_minv[unchanged]), i
    finally:
        mpclib.make_plan_with_pred = plan
    assert [r.tolist() for r in seen] == [[True, True], [True, True],
                                          [True, False]], seen
