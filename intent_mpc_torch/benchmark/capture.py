"""Drive the DYNUS closed loop (and its goal-mode protocols), capture the
candidate QPs a cycle hands to its solver, and time device work with CUDA
events.

`chip_smoke.py`, `benchmark/fleet_phases.py` and the card tests share
these; nothing here runs at import time.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import NamedTuple

import torch

from intent_mpc_torch.benchmark import real_loop, ref_modes
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models import mpc as mpclib
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.config import RealDetectorConfig, small_config


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


def _stalled(carry, cfg):
    """The goal-relax stall counter started 30 cycles past its grace, so
    the dynamic-safety anneal is live from the first cycle (away from the
    goal the counter decays by 2 per cycle)."""
    n = cfg.engine.goal_relax_grace + 30
    return carry._replace(stall_cycles=torch.full_like(carry.stall_cycles, n))


# the closed-loop options that the option phases and profiles run by name:
# (engine fields, solver fields, starting-carry change or None)
LOOP_OPTIONS = {
    "quadrotor": (dict(plant="quadrotor"), {}, None),
    "goal_relax": (dict(goal_relax=True), {}, _stalled),
    "use_fov": (dict(use_fov=True), {}, None),
    "no_predictor": (dict(use_predictor=False), {}, None),
    "flat_iter": ({}, dict(flat_iter=True), None),
    "stationary": ({}, dict(shared_refine_mode="stationary"), None),
    "drift_refresh": ({}, dict(factor_drift_refresh=0.05), None),
    "predictor_stale": (dict(predictor_stale_hist=True), {}, None),
}


# the real-perception DYNUS configuration of results/real_dynus4 and
# results/real_dynus28 (the flags of `real_loop --dynus`)
REAL_DYNUS_FLAGS = ("--dynus", "--obstacles", "200", "--timeout", "60",
                    "--max-obstacles", "64", "--max-tracks", "16")


def real_dynus_config():
    """The real-perception mode of `real_loop` at REAL_DYNUS_FLAGS: the
    rendered-depth detector, static clustering of each seed's prebuilt
    static map, the sampled predictor on it."""
    args = real_loop.parse_args(list(REAL_DYNUS_FLAGS))
    return real_loop.real_cfg_of(real_loop.build_cfg(args), args)


def real_small_config(world: str, fused_solve: bool = False):
    """A small real-perception config for card-against-CPU checks: "micro"
    (four dynamic obstacles in a corridor, real_loop's default world) or
    "dynus" (24 obstacles, 65% dynamic, the statics through each seed's
    prebuilt map and per-cycle clustering rows, as real_loop --dynus), at
    horizon 8, 4 QP slots and 4 tracks."""
    cfg = small_config(num_obstacles=24 if world == "dynus" else 4,
                       horizon=8, timeout=0.5, max_obstacles=4, hist=8)
    rd = RealDetectorConfig(max_tracks=4, max_detections=4)
    if world == "dynus":
        cfg = cfg.replace(
            world=dataclasses.replace(cfg.world, x_range=(3.0, 14.0),
                                      y_range=(-4.0, 4.0)),
            goal=(12.0, 0.0, 2.0), real_detector=rd,
            planner=dataclasses.replace(cfg.planner, static_clustering=True),
            engine=dataclasses.replace(cfg.engine, use_fake_detector=False,
                                       render_static_grid=False))
    else:
        cfg = cfg.replace(
            world=dataclasses.replace(cfg.world, dynamic_ratio=1.0,
                                      x_range=(3.0, 8.0), y_range=(-2.0, 2.0),
                                      z_range=(1.0, 2.0)),
            real_detector=rd, start=(0.0, 0.0, 1.5), goal=(8.0, 0.0, 1.5),
            engine=dataclasses.replace(cfg.engine, use_fake_detector=False))
    return fused(cfg) if fused_solve else cfg


def with_option(cfg, name):
    """cfg with the LOOP_OPTIONS entry `name` set."""
    engine, solver, _ = LOOP_OPTIONS[name]
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, **engine))
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                **solver)))


def option_start(name):
    """The starting-carry change of LOOP_OPTIONS entry `name` (a function
    of (carry, cfg)), or None."""
    return LOOP_OPTIONS[name][2]


def run_loop(cfg, S, cycles, device, start=None):
    """Drive the closed loop through the public entry points (with the
    static maps the config reads, real_loop.static_maps); returns (carry,
    per-cycle seconds with a synchronize after each cycle, per-cycle
    positions on the CPU). `start(carry, cfg)` changes the fresh carry
    before the first cycle."""
    scen = sh.stack_scenarios(cfg, range(S), device=device)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5,
                                 device=device)
    occ, veto = real_loop.static_maps(cfg, range(S), device)
    carry = cl.init_carry(cfg, scen, device=device)
    if start is not None:
        carry = start(carry, cfg)
    secs, positions = [], []
    for i in range(cycles):
        t0 = time.perf_counter()
        carry, pos = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry,
                                     i, veto_occ=veto)
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


class GoalRun(NamedTuple):
    """What a goal-mode episode_step call takes beyond the config."""
    scen: object
    occ: object
    ref: torch.Tensor      # (L, 3): only its length, the allocation, is read
    key: torch.Tensor      # (S, 2): PRNGKey(1000 + seed) per scenario


def goal_keys(seeds, device):
    return prng.prng_key(torch.tensor([1000 + int(s) for s in seeds]),
                         device)


def goal_dynus(ref_mode, S, device, fused_solve=False):
    """The DYNUS goal-mode protocol of `ref_modes --dynus` (200 obstacles,
    each seed's prebuilt static map, 105 m, L = 384) for seeds 0..S-1:
    (config, GoalRun)."""
    cfg = ref_modes.dynus_cfg(ref_mode, 200, 100.0)
    cfg = fused(cfg) if fused_solve else cfg
    seeds = list(range(S))
    scen, occ = ref_modes.dynus_batch(cfg, seeds, device)
    ref = torch.zeros((ref_modes.DYNUS_L, 3), device=device)
    return cfg, GoalRun(scen, occ, ref, goal_keys(seeds, device))


def goal_step(cfg, run: GoalRun, carry, i):
    return cl.episode_step(cfg, run.scen, run.ref, run.ref.shape[0], run.occ,
                           carry, i, ref_key=run.key)


def goal_init(cfg, run: GoalRun, device):
    return cl.init_carry(cfg, run.scen, device=device,
                         ref_len=run.ref.shape[0])


def rearm_build(carry):
    """The carry with every scenario's input trajectory due for a rebuild,
    as a stop+replan leaves it (composed goal modes)."""
    return carry._replace(need_ref=torch.ones_like(carry.need_ref))


def wall_start(carry, cfg):
    """The wall world's goal-mode test start: 1.5 m before the wall at
    x = 4, holding a committed trajectory straight through it, so the first
    cycle stops and replans and the composed modes build on the second."""
    H = cfg.planner.horizon
    pos = torch.tensor([1.5, 0.0, 2.0], device=carry.pos.device
                       ).expand_as(carry.pos).contiguous()
    ss = carry.planner.states_sol.clone()
    ss[:, :, 0] = 1.5 + 0.5 * torch.arange(H, dtype=torch.float32,
                                           device=ss.device)
    ss[:, :, 1] = 0.0
    ss[:, :, 2] = 2.0
    yes = torch.ones_like(carry.traj_ready)
    return carry._replace(
        pos=pos, stop_pos=pos.clone(), ref_anchor=pos.clone(),
        quad=carry.quad._replace(pos=pos.clone()), traj_ready=yes,
        planner=carry.planner._replace(states_sol=ss, has_solution=yes,
                                       first_time=~yes))


def goal_wall_loop(ref_mode, seeds, cycles, device, poly_iters):
    """The wall world in goal mode from wall_start for `cycles` cycles at
    ref_poly_iters `poly_iters`: (final carry, per-cycle positions on the
    CPU, per-cycle (ref_len, stop_replans) on the CPU or None)."""
    cfg = ref_modes.wall_cfg(ref_mode, 2.0)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 ref_poly_iters=poly_iters))
    scen, occ, _ = ref_modes.wall_batch(seeds, device)
    L = ref_modes.WALL_L
    run = GoalRun(scen, occ, torch.zeros((L, 3), device=device),
                  goal_keys(seeds, device))
    carry = wall_start(goal_init(cfg, run, device), cfg)
    positions, counts = [], []
    for i in range(cycles):
        carry, pos = goal_step(cfg, run, carry, i)
        positions.append(pos.detach().cpu())
        counts.append((None if carry.ref_len is None
                       else carry.ref_len.detach().cpu(),
                       carry.metrics.stop_replans.detach().cpu()))
    return carry, positions, counts
