"""Drive the DYNUS closed loop, capture the candidate QPs a cycle hands to
its solver, and time device work with CUDA events.

`chip_smoke.py`, `benchmark/fleet_phases.py` and the card tests share
these; nothing here runs at import time.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models import mpc as mpclib
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh


def cuda_time_ms(fn, reps=50):
    """Median of `reps` CUDA-event timings of fn() (after one warm-up).

    Each timing starts behind a ~2 ms device-side spin, so the host has
    enqueued fn()'s launches before the device reaches them and the events
    time device work, not host launch overhead."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def fused(cfg):
    """The config with the fleet-fused solve, as bench.py --fused sets it."""
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                fused_solve=True)))


def run_loop(cfg, S, cycles, device):
    """Drive the closed loop through the public entry points; returns
    (carry, per-cycle seconds with a synchronize after each cycle,
    per-cycle positions on the CPU)."""
    scen = sh.stack_scenarios(cfg, range(S), device=device)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5,
                                 device=device)
    occ = empty_grid(device)
    carry = cl.init_carry(cfg, scen, device=device)
    secs, positions = [], []
    for i in range(cycles):
        t0 = time.perf_counter()
        carry, pos = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        positions.append(pos.detach().cpu())
    return carry, secs, positions


def capture_fused_qps(cfg, S, cycle, device):
    """The candidate QPs that the planner hands to fleet_admm at `cycle` of
    the fused DYNUS loop (cycles 0..cycle run from a fresh carry): a
    recorder stands in for mpc.fleet_admm during this run only."""
    solve = mpclib.fleet_admm
    seen = []

    def record(cfg_, qps, warm, max_iter=None, **kw):
        seen.append((qps, warm, kw.get("rho_override")))
        return solve(cfg_, qps, warm, max_iter, **kw)
    mpclib.fleet_admm = record
    try:
        run_loop(fused(cfg), S, cycle + 1, device)
    finally:
        mpclib.fleet_admm = solve
    return seen[cycle]


def capture_default_qps(cfg, S, cycle, device):
    """The candidate QPs and warm starts that the planner hands to
    admm_solve at `cycle` of the default DYNUS loop (cycles 0..cycle run
    from a fresh carry): a recorder stands in for mpc.admm_solve during
    this run only."""
    solve = mpclib.admm_solve
    seen = []

    def record(cfg_, qps, x0=None, max_iter=None, **kw):
        seen.append((qps, x0))
        return solve(cfg_, qps, x0, max_iter, **kw)
    mpclib.admm_solve = record
    try:
        run_loop(cfg, S, cycle + 1, device)
    finally:
        mpclib.admm_solve = solve
    return seen[cycle]
