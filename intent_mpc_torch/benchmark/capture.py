"""Drive the DYNUS closed loop (and its goal-mode protocols), capture the
candidate QPs a cycle hands to its solver, render the camera frames the
mapping and perception-fusion stages read, and time device work with CUDA
events.

`chip_smoke.py`, `benchmark/fleet_phases.py` and the card tests share
these; nothing here runs at import time.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch

from intent_mpc_torch.benchmark import real_loop, ref_modes
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models import mpc as mpclib
from intent_mpc_torch.models import perception, real_detector, sensor
from intent_mpc_torch.models.world import (obstacle_state,
                                           straight_line_ref_traj)
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import prng, trace
from intent_mpc_torch.utils.config import RealDetectorConfig, small_config
from intent_mpc_torch.utils.device import resolve_device


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


def recorded_loop(cfg, S, cycles, device):
    """run_loop with utils/trace's spans recording: engine/graph.py then
    replays no CUDA graph (a replay calls no Python), so a recorder that
    stands in for a function inside the cycle sees every cycle's call."""
    trace.start()
    try:
        return run_loop(cfg, S, cycles, device)
    finally:
        trace.stop()


def capture_fused_qps(cfg, S, cycle, device):
    """The candidate QPs that the planner hands to fleet_admm at `cycle` of
    the fused DYNUS loop (cycles 0..cycle run from a fresh carry, eagerly:
    recorded_loop): a recorder stands in for mpc.fleet_admm during this
    run only."""
    solve = mpclib.fleet_admm
    seen = []

    def record(cfg_, qps, warm, max_iter=None, **kw):
        seen.append((qps, warm, kw.get("rho_override")))
        return solve(cfg_, qps, warm, max_iter, **kw)
    mpclib.fleet_admm = record
    try:
        recorded_loop(fused(cfg), S, cycle + 1, device)
    finally:
        mpclib.fleet_admm = solve
    return seen[cycle]


def capture_default_qps(cfg, S, cycle, device):
    """The candidate QPs and warm starts that the planner hands to
    admm_solve at `cycle` of the default DYNUS loop (cycles 0..cycle run
    from a fresh carry, eagerly: recorded_loop): a recorder stands in for
    mpc.admm_solve during this run only."""
    solve = mpclib.admm_solve
    seen = []

    def record(cfg_, qps, x0=None, max_iter=None, **kw):
        seen.append((qps, x0))
        return solve(cfg_, qps, x0, max_iter, **kw)
    mpclib.admm_solve = record
    try:
        recorded_loop(cfg, S, cycle + 1, device)
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


class CameraFrames(NamedTuple):
    """F depth frames of S scenarios from a level camera facing +x."""
    cam_pos: torch.Tensor    # (F, S, 3)
    rot: torch.Tensor        # (S, 3, 3) optical -> world
    depth: torch.Tensor      # (F, S, H, W) raw depth
    pts: torch.Tensor        # (F, S, P, 3) world points
    valid: torch.Tensor      # (F, S, P)
    obs_pos: torch.Tensor    # (F, S, O, 3) box centers at each frame
    obs_size: torch.Tensor   # (S, O, 3)
    dynamic: torch.Tensor    # (S, O) bool


def render_frames(rd: RealDetectorConfig, cam_pos: torch.Tensor,
                  obs_pos: torch.Tensor, obs_size: torch.Tensor,
                  dynamic: torch.Tensor) -> CameraFrames:
    """Render and project the frames of cameras at cam_pos (F, S, 3)
    facing +x, seeing boxes at obs_pos (F, S, O, 3) of sizes (S, O, 3)."""
    intr = real_detector.intrinsics(rd)
    F, S, _ = cam_pos.shape
    rot = sensor.yaw_camera_rotation(torch.zeros((S,), device=cam_pos.device))
    active = torch.ones(obs_size.shape[:2], dtype=torch.bool,
                        device=cam_pos.device)
    depth, pts, valid = [], [], []
    for f in range(F):
        d = sensor.render_depth(intr, rd.im_h, rd.im_w, cam_pos[f], rot,
                                obs_pos[f], obs_size, active,
                                max_depth=rd.depth_max)
        p, v = perception.project_depth(intr, d, cam_pos[f], rot)
        depth.append(d)
        pts.append(p)
        valid.append(v)
    return CameraFrames(cam_pos, rot, torch.stack(depth), torch.stack(pts),
                        torch.stack(valid), obs_pos, obs_size, dynamic)


CAMERA_SPEED = 5.0      # m/s along the start-to-goal line (ref_vel)
CAMERA_RATE = 30.0      # frames per second
SMALL_SEEDS = (0, 1)
SMALL_FRAMES = 6
SMALL_BOXES = 5


def dynus_frames(seeds, frames: int, device) -> CameraFrames:
    """The real-perception camera (real_dynus_config) flown at CAMERA_SPEED
    along the DYNUS start-to-goal line, facing +x, `frames` frames at
    CAMERA_RATE; each seed's 200 obstacles placed at the frame's time
    (models/world.obstacle_state)."""
    cfg = real_dynus_config()
    scen = sh.stack_scenarios(cfg, seeds, device=device)
    S = len(seeds)
    start = torch.tensor(cfg.start, dtype=torch.float32, device=device)
    goal = torch.tensor(cfg.goal, dtype=torch.float32, device=device)
    heading = (goal - start) / torch.linalg.vector_norm(goal - start)
    cams, obs = [], []
    for f in range(frames):
        t = f / CAMERA_RATE
        cams.append((start + heading * (CAMERA_SPEED * t)).expand(S, 3))
        obs.append(obstacle_state(scen, torch.tensor(t, device=device))[0])
    return render_frames(cfg.real_detector, torch.stack(cams),
                         torch.stack(obs), scen.bbox, ~scen.is_static)


def small_frames(device=None) -> CameraFrames:
    """A small world per seed of SMALL_SEEDS for card-against-CPU checks:
    SMALL_BOXES seeded static boxes in front of a camera stepping 0.3 m
    along x from (0.5, 3, 1.5) for SMALL_FRAMES frames, inside a
    10 x 6 x 3 m map at the origin."""
    rd = RealDetectorConfig()
    device = resolve_device(device)
    S, F, B = len(SMALL_SEEDS), SMALL_FRAMES, SMALL_BOXES
    cen, size = [], []
    for s in SMALL_SEEDS:
        rng = np.random.default_rng(s)
        cen.append(rng.uniform([4.0, 0.5, 0.5], [9.0, 5.5, 2.5], (B, 3)))
        size.append(rng.uniform(0.4, 1.2, (B, 3)))
    cen = torch.tensor(np.array(cen), dtype=torch.float32, device=device)
    size = torch.tensor(np.array(size), dtype=torch.float32, device=device)
    cams = torch.tensor([[[0.5 + 0.3 * f, 3.0, 1.5]] * S for f in range(F)],
                        dtype=torch.float32, device=device)
    return render_frames(rd, cams, cen.expand(F, S, B, 3), size,
                         torch.zeros((S, B), dtype=torch.bool, device=device))
