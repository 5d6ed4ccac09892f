"""Closed-loop simulation engine: world -> detector -> predictor -> MPC ->
controller -> dynamics (port of intent_mpc_tpu/engine/closed_loop.py).

A batch of S scenarios steps together:

  outer loop: 10 Hz MPC cycles (mpcCB, mpcNavigation.cpp:222-370)
  inner 10 ticks: 100 Hz trajectory execution (trajExeCB :499-567), PID
    tracking control (acceleration mode), the plant (double integrator,
    or the rigid-body quadrotor of models/quad_plant.py), ~30 Hz detector
    history pushes (ticks 0/3/6), and the benchmark monitor's per-sample
    metric updates (run_mpc_benchmark.py:224-385).

The port runs the ground-truth fake detector or the real perception
stack (use_fake_detector=False: a depth frame rendered at each sense
tick, DBSCAN detections, KF tracks, models/real_detector.py), static
clustering of the occupancy map into rotated-box MPC rows, and the
engine options: the predictor or the constant-obstacle MPC, either plant
or perfect tracking, the camera-FOV rows, the stale predictor history,
the committed-trajectory monitor on or off, path repetition, look-ahead
or velocity-heading yaw, and the goal-approach relaxation.

Goal mode (EngineConfig.goal_mode, the interactive-goal navigation of
mpcNavigation.cpp:239-290, 460-494) flies to the goal without a prebuilt
path: the committed-trajectory monitor stops and replans, a statically
occupied goal region stops the flight, and the MPC's input trajectory is
either the straight line from the last replan anchor, rebuilt every cycle
(ref_mode "linspace"), or a composed trajectory (engine/ref_builder.py:
"minsnap", or "global" with an RRT route first) built once per
stop+replan and kept per scenario in the carry. A composed build runs for
the whole batch on the cycles where some scenario needs one; deciding
that is the composed modes' one host read per cycle
("closed_loop.host_reads" in utils/trace).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from intent_mpc_torch.engine import graph
from intent_mpc_torch.engine.ref_builder import build_goal_ref, linspace
from intent_mpc_torch.models import clustering as clus
from intent_mpc_torch.models import detector as det
from intent_mpc_torch.models import mpc as mpclib
from intent_mpc_torch.models import predictor as predlib
from intent_mpc_torch.models import real_detector as rdet
from intent_mpc_torch.models.controller import (ControllerState, acc_command,
                                                init_controller)
from intent_mpc_torch.models.occupancy import (OccupancyGrid, empty_grid,
                                               is_occupied,
                                               local_occupied_points)
from intent_mpc_torch.models.quad_plant import (QuadPlantConfig, QuadState,
                                                quad_init, quad_step)
from intent_mpc_torch.models.world import Scenario, obstacle_state
from intent_mpc_torch.ops.admm import check_supported as check_solver
from intent_mpc_torch.utils import prng, trace
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import constant, resolve_device


class Metrics(NamedTuple):
    goal_reached: torch.Tensor
    travel_time: torch.Tensor
    collision: torch.Tensor
    collision_count: torch.Tensor
    min_obstacle_dist: torch.Tensor
    path_length: torch.Tensor
    vel_violations: torch.Tensor
    acc_violations: torch.Tensor
    jerk_violations: torch.Tensor
    samples: torch.Tensor
    jerk_samples: torch.Tensor
    max_velocity: torch.Tensor
    max_acceleration: torch.Tensor
    sum_velocity: torch.Tensor
    n_vel_valid: torch.Tensor
    jerk_sq_sum: torch.Tensor
    jerk_abs_sum: torch.Tensor
    solve_attempts: torch.Tensor
    solve_successes: torch.Tensor
    prim_res_sum: torch.Tensor     # accumulated chosen-candidate residuals
    prim_res_max: torch.Tensor
    traj_collision_cycles: torch.Tensor  # replanCheckCB monitor hits
    stop_replans: torch.Tensor     # goal-mode stop+replan events (:474-480)


def init_metrics(batch: int, device="cpu") -> Metrics:
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    zi = torch.zeros((batch,), dtype=torch.int32, device=device)
    zb = torch.zeros((batch,), dtype=torch.bool, device=device)
    return Metrics(
        goal_reached=zb, travel_time=z,
        collision=zb, collision_count=zi,
        min_obstacle_dist=torch.full((batch,), float("inf"), device=device),
        path_length=z,
        vel_violations=zi, acc_violations=zi, jerk_violations=zi,
        samples=zi, jerk_samples=zi,
        max_velocity=z, max_acceleration=z, sum_velocity=z, n_vel_valid=zi,
        jerk_sq_sum=z, jerk_abs_sum=z,
        solve_attempts=zi, solve_successes=zi,
        prim_res_sum=z, prim_res_max=z,
        traj_collision_cycles=zi, stop_replans=zi)


class EngineCarry(NamedTuple):
    pos: torch.Tensor             # (S, 3)
    vel: torch.Tensor             # (S, 3)
    detector: det.DetectorState
    planner: mpclib.PlannerState
    controller: ControllerState
    traj_age: torch.Tensor        # (S,) cycles since the executing solution's start
    traj_ready: torch.Tensor      # (S,) bool (mpcTrajectoryReady_)
    prev_target_acc: torch.Tensor
    has_prev_target: torch.Tensor
    stopping: torch.Tensor        # replanCheck goal-stop triggered
    stop_pos: torch.Tensor
    repeats_left: torch.Tensor    # int32 path repetitions remaining
    tracking_start: torch.Tensor  # time the current tracking round began
    yaw: torch.Tensor             # heading (look-ahead yaw, trajExeCB
                                  # :536-553); feeds the FOV rows
    ref_anchor: torch.Tensor      # (S, 3) goal-mode reference start: reset
                                  # to the held position on stop+replan
    quad: QuadState               # rigid-body plant state (used with
                                  # plant="quadrotor"; pos/vel mirror it)
    done: torch.Tensor            # monitor goal criterion met
    metrics: Metrics
    # composed goal modes (ref_mode "minsnap" / "global"; None otherwise):
    # the committed input trajectory, built on a refTrajReady_ = false pass
    # (mpcNavigation.cpp:239-290) and kept until the next stop+replan
    ref_traj: Optional[torch.Tensor] = None   # (S, L, 3)
    ref_len: Optional[torch.Tensor] = None    # (S,) int32 valid waypoints
    need_ref: Optional[torch.Tensor] = None   # (S,) bool (refTrajReady_ false)
    # real perception (use_fake_detector=False): the depth-camera track
    # table and per-track history rings; None on the GT path
    real_det: Optional[rdet.RealDetectorState] = None
    # goal-approach relaxation (EngineConfig.goal_relax): (S,) int32
    # consecutive stalled-near-goal cycles driving the dynamic-safety
    # anneal; None when the option is off
    stall_cycles: Optional[torch.Tensor] = None


def check_supported(cfg: IntentMPCConfig) -> None:
    """Raise for the engine and solver options this port does not run."""
    e, p = cfg.engine, cfg.planner
    if e.plant not in ("double_integrator", "quadrotor"):
        raise ValueError("plant must be 'double_integrator' or "
                         "'quadrotor', got %r" % (e.plant,))
    if e.goal_mode and e.ref_mode not in ("linspace", "minsnap", "global"):
        raise ValueError("ref_mode must be 'linspace', 'minsnap' or "
                         "'global', got %r" % (e.ref_mode,))
    check_solver(p.solver)


def tree_where(cond: torch.Tensor, new, old):
    """Per-scenario select over matching NamedTuples of (S, ...) tensors."""
    if new is None:
        return None
    if isinstance(new, tuple):
        return type(new)(*(tree_where(cond, a, b) for a, b in zip(new, old)))
    c = cond.reshape(cond.shape + (1,) * (new.dim() - cond.dim()))
    return torch.where(c, new, old)


def composed(cfg: IntentMPCConfig) -> bool:
    """Goal mode with a composed input trajectory (built, then kept)."""
    return cfg.engine.goal_mode and cfg.engine.ref_mode != "linspace"


def init_carry(cfg: IntentMPCConfig, scenario: Scenario,
               device=None, ref_len: Optional[int] = None) -> EngineCarry:
    """Initial carry for a batch of scenarios (leading axis S). Runs on
    the GPU unless `device` names another device. ref_len: the input-
    trajectory allocation L, which the composed goal modes need."""
    check_supported(cfg)
    if composed(cfg) and ref_len is None:
        raise ValueError("goal mode with ref_mode %r needs init_carry's "
                         "ref_len (the input-trajectory array length)"
                         % cfg.engine.ref_mode)
    dev = resolve_device(device)
    scenario = Scenario(*(a.to(dev) for a in scenario))
    S = scenario.origin.shape[0]
    pos0, _ = obstacle_state(scenario, torch.zeros((), device=dev))
    start = torch.tensor(cfg.start, dtype=torch.float32,
                         device=dev).expand(S, 3).contiguous()
    kw = dict(dtype=torch.float32, device=dev)
    return EngineCarry(
        pos=start.clone(), vel=torch.zeros((S, 3), **kw),
        detector=det.init_detector(scenario.origin.shape[1], cfg.detector, pos0),
        planner=mpclib.init_planner_state(cfg.planner, S, dev),
        controller=init_controller((S,), dev),
        traj_age=torch.zeros((S,), dtype=torch.int32, device=dev),
        traj_ready=torch.zeros((S,), dtype=torch.bool, device=dev),
        prev_target_acc=torch.zeros((S, 3), **kw),
        has_prev_target=torch.zeros((S,), dtype=torch.bool, device=dev),
        stopping=torch.zeros((S,), dtype=torch.bool, device=dev),
        stop_pos=start.clone(),
        repeats_left=torch.full((S,), cfg.engine.repeat_path,
                                dtype=torch.int32, device=dev),
        tracking_start=torch.zeros((S,), **kw),
        yaw=torch.zeros((S,), **kw),
        ref_anchor=start.clone(),
        quad=quad_init(start.clone()),
        done=torch.zeros((S,), dtype=torch.bool, device=dev),
        metrics=init_metrics(S, dev),
        ref_traj=(torch.zeros((S, ref_len, 3), **kw) if composed(cfg)
                  else None),
        ref_len=(torch.full((S,), 2, dtype=torch.int32, device=dev)
                 if composed(cfg) else None),
        need_ref=(torch.ones((S,), dtype=torch.bool, device=dev)
                  if composed(cfg) else None),
        real_det=(None if cfg.engine.use_fake_detector else
                  rdet.init_real_detector(cfg.real_detector, cfg.detector,
                                          S, dev)),
        stall_cycles=(torch.zeros((S,), dtype=torch.int32, device=dev)
                      if cfg.engine.goal_relax else None))


def _aabb_distance(p: torch.Tensor, centers: torch.Tensor,
                   bbox: torch.Tensor) -> torch.Tensor:
    """Distance from p (S, 3) to each box surface (S, N) (0 inside):
    run_mpc_benchmark.py:352-381 check_collisions."""
    gap = torch.clamp(torch.abs(p[:, None, :] - centers) - bbox / 2.0, min=0.0)
    return torch.linalg.vector_norm(gap, dim=-1)


def committed_collision(cfg: IntentMPCConfig, planner: mpclib.PlannerState,
                        occ: OccupancyGrid, elapsed: torch.Tensor,
                        obs_pos: torch.Tensor, obs_size: torch.Tensor,
                        visible: torch.Tensor) -> torch.Tensor:
    """replanCheckCB's committed-trajectory monitor.

    mpcHasCollision (mpcNavigation.cpp:631-656): sample the executing
    solution at ts steps from startTime = min(1, elapsed) to
    min(startTime + 2, horizon*ts) against the static inflated map.
    hasDynamicCollision (:669-700): the same sweep over a 1 s window
    against the detector's current obstacle boxes. Returns (S,) bool."""
    p = cfg.planner
    ts = p.ts
    t_start = torch.clamp(elapsed, max=1.0)                       # (S,)
    t_end = p.horizon * ts
    ar = torch.arange(p.horizon + 1, dtype=torch.float32, device=elapsed.device)
    tj = t_start[:, None] + ts * ar                               # (S, H+1)
    pj = mpclib.sample_pos(p, planner.states_sol, tj)             # (S, H+1, 3)
    static_m = tj <= torch.clamp(t_start + 2.0, max=t_end)[:, None]
    dyn_m = tj <= torch.clamp(t_start + 1.0, max=t_end)[:, None]
    occ_hit = is_occupied(occ, pj)
    static_hit = torch.any(occ_hit & static_m, dim=-1)
    lo = obs_pos - obs_size / 2.0
    hi = obs_pos + obs_size / 2.0
    pjb = pj[:, :, None, :]
    inside = torch.all((pjb >= lo[:, None]) & (pjb <= hi[:, None]), dim=-1)
    dyn_hit = torch.any(inside & visible[:, None, :] & dyn_m[:, :, None],
                        dim=(-2, -1))
    return static_hit | dyn_hit


# goalHasCollision's probe offsets: +-0.5 m at 0.1 m steps per axis
_GOAL_OFF = np.arange(-0.5, 0.5 + 1e-6, 0.1, dtype=np.float32)
_GOAL_PROBE = tuple(map(tuple, np.stack(
    [a.ravel() for a in np.meshgrid(_GOAL_OFF, _GOAL_OFF, _GOAL_OFF,
                                    indexing="ij")], axis=-1).tolist()))


def goal_region_occupied(occ: OccupancyGrid, goal: torch.Tensor,
                         batch: int) -> torch.Tensor:
    """goalHasCollision (mpcNavigation.cpp:612-629): a dense +-0.5 m grid
    at 0.1 m steps around the goal (3,) against the static inflated map
    (shared or one per scenario). Returns (batch,) bool."""
    pts = goal + constant(_GOAL_PROBE, goal.device)               # (P, 3)
    return torch.any(is_occupied(occ, pts.expand(batch, *pts.shape)), dim=-1)


def _build_ref(cfg: IntentMPCConfig, occ: OccupancyGrid, carry: EngineCarry,
               goal: torch.Tensor, build: torch.Tensor, ref_key, cycle_idx):
    """The composed goal modes' build pass (mpcNavigation.cpp:239-290):
    where `build` (S,) holds, [RRT ->] corridor min-snap from the current
    position to the goal, committed where the RRT found a route (a build
    without one is retried next cycle with a fresh fold of the key).
    Returns (ref_traj, ref_len, committed (S,) bool). The build runs for
    the whole batch when any scenario needs it: that decision is a host
    read, counted as "closed_loop.host_reads" in utils/trace."""
    trace.count("closed_loop.host_reads")
    if not bool(torch.any(build)):
        return carry.ref_traj, carry.ref_len, build
    S, L = carry.ref_traj.shape[:2]
    if ref_key is None:
        # PRNGKey(0), as in JAX
        ref_key = torch.zeros((S, 2), dtype=torch.int64,
                              device=carry.pos.device)
    key = prng.fold_in(ref_key, cycle_idx)
    r, n, _, route_ok = build_goal_ref(cfg.engine, occ, carry.pos, goal, key,
                                       L, dt=cfg.planner.ts)
    committed = build & route_ok
    return (tree_where(committed, r, carry.ref_traj),
            torch.where(committed, n, carry.ref_len), committed)


def _lookahead_yaw(cfg: IntentMPCConfig, planner: mpclib.PlannerState,
                   t_traj: torch.Tensor, cur_yaw: torch.Tensor,
                   update_ok: torch.Tensor) -> torch.Tensor:
    """trajExeCB yaw smoothing (mpcNavigation.cpp:536-553): target yaw
    points at the first stored-reference point >= yaw_lookahead metres
    from getRef(t); hold yaw if none within the horizon."""
    p = cfg.planner
    dist = cfg.engine.yaw_lookahead
    ref0 = mpclib.sample_ref(p, planner.xref, t_traj)             # (S, 3)
    ar = torch.arange(p.horizon + 1, dtype=torch.float32, device=t_traj.device)
    tj = t_traj[:, None] + p.ts * ar
    pj = mpclib.sample_ref(p, planner.xref, tj)                   # (S, H+1, 3)
    far = (torch.linalg.vector_norm(pj - ref0[:, None], dim=-1) >= dist) \
        & (tj <= p.horizon * p.ts)
    j = torch.argmax(far.to(torch.int32), dim=-1)                 # first True
    tgt = mpclib._rows(pj, j)
    yaw_new = torch.atan2(tgt[:, 1] - ref0[:, 1], tgt[:, 0] - ref0[:, 0])
    return torch.where(update_ok & torch.any(far, dim=-1), yaw_new, cur_yaw)


def _velocity_yaw(tv: torch.Tensor, cur_yaw: torch.Tensor,
                  update_ok: torch.Tensor) -> torch.Tensor:
    """The velocity-heading yaw (yaw_lookahead <= 0, the JAX package's
    round-2 behavior): the target velocity's heading where it moves faster
    than 0.1 m/s in the plane, else hold."""
    speed_xy = torch.linalg.vector_norm(tv[:, 0:2], dim=-1)
    return torch.where(update_ok & (speed_xy > 0.1),
                       torch.atan2(tv[:, 1], tv[:, 0]), cur_yaw)


def _goal_relax(cfg: IntentMPCConfig, carry: EngineCarry,
                goal: torch.Tensor, active: torch.Tensor):
    """Goal-approach safety relaxation (EngineConfig.goal_relax, the JAX
    package's opt-in beyond-reference option): count consecutive cycles
    stalled near the goal (within goal_relax_radius, outside the goal
    criterion, slower than goal_relax_speed), decaying by 2 instead of
    resetting when the stall clears, and anneal each scenario's QP
    dynamic safety distance by goal_relax_rate per cycle past the grace,
    down to goal_relax_floor. Returns (stall counts (S,), safety (S,))."""
    ecfg = cfg.engine
    dist_goal = torch.linalg.vector_norm(carry.pos - goal, dim=-1)
    speed = torch.linalg.vector_norm(carry.vel, dim=-1)
    stalled = active & (dist_goal < ecfg.goal_relax_radius) \
        & (dist_goal > ecfg.goal_dist_threshold) \
        & (speed < ecfg.goal_relax_speed)
    stall = torch.where(stalled, carry.stall_cycles + 1,
                        torch.clamp(carry.stall_cycles - 2, min=0))
    dsd = cfg.planner.dynamic_safety_dist
    relax = torch.clamp(
        (stall - ecfg.goal_relax_grace).to(torch.float32)
        * ecfg.goal_relax_rate, 0.0, dsd - ecfg.goal_relax_floor)
    return stall, dsd - relax


def _static_rows(cfg: IntentMPCConfig, occ: OccupancyGrid,
                 pos: torch.Tensor):
    """Local static clustering (getStaticObstacles; the real-perception
    composition, where statics reach the MPC through the static map ->
    obstacleClustering -> rotated-box rows, mpcPlanner.cpp:191-193 +
    updateObstacleParam :1186-1195): the nearest occupied voxels around
    each scenario's position, clustered into cluster_slots boxes."""
    p = cfg.planner
    pts, valid = local_occupied_points(occ, pos, p.cluster_window,
                                       p.cluster_points)
    so = clus.cluster_obstacles(
        clus.ClusteringConfig(max_clusters=4, tree_level=2, min_pts=8),
        pts, valid)
    if so.centroid.shape[1] != p.cluster_slots:
        raise ValueError("cluster_slots %d, the clustering gives %d"
                         % (p.cluster_slots, so.centroid.shape[1]))
    return so.centroid, so.size, so.yaw, so.active


def _sense(cfg: IntentMPCConfig, rd, scenario: Scenario, pos, yaw, obs_pos,
           cam_occ, veto_occ):
    """One real-perception tick: the camera images every box of the
    scenario (the GT scene), the stack tracks what it sees."""
    obs_all = torch.ones(obs_pos.shape[:2], dtype=torch.bool,
                         device=obs_pos.device)
    return rdet.sense_and_track(cfg.real_detector, cfg.detector, rd, pos,
                                yaw, obs_pos, scenario.bbox, obs_all, cam_occ,
                                obs_dynamic=~scenario.is_static,
                                static_occ=veto_occ)


def episode_step(cfg: IntentMPCConfig, scenario: Scenario,
                 ref_traj: torch.Tensor, traj_len: int,
                 occ: OccupancyGrid, carry: EngineCarry, cycle_idx: int,
                 solver_iters: Optional[int] = None,
                 veto_occ: Optional[OccupancyGrid] = None,
                 ref_key: Optional[torch.Tensor] = None,
                 solve_override=None
                 ) -> Tuple[EngineCarry, torch.Tensor]:
    """One 10 Hz MPC cycle + its 10 control ticks for S scenarios.

    scenario (S, N, ...); ref_traj (L, 3) shared; traj_len its valid
    length; occ the static map, shared or one per scenario; cycle_idx
    the Python cycle counter. veto_occ: the grid of the real detector's
    static-map veto (RealDetectorConfig.static_map_veto), the solid
    static volume; with the veto on and none given, occ. In goal mode the
    content of ref_traj is not read, only its length L (the allocation);
    ref_key (S, 2): each scenario's key of the goal-mode RRT (ref_mode
    "global"; utils/prng.prng_key(0) when None, as in JAX).
    solve_override: `(qps, warm6) -> ADMMResult` in place of the batched
    ADMM of the predictor path's plan (models/mpc.make_plan_with_pred;
    oracle-in-the-loop runs). Returns (carry, pos (S, 3)).

    The cycle runs inside the span "cycle" of utils/trace, its stages
    inside "perceive", "predict", "plan" and "ticks". On a CUDA device it
    is replayed from a CUDA graph where engine/graph.py's rule allows
    (spans on, a solve_override, or a cycle that reads the host keep it
    eager): the same kernels and bits, and a new carry either way, with
    `carry` left as it was."""
    tree = (scenario, ref_traj, traj_len, occ, carry, veto_occ, ref_key)

    def cycle(t, clock):
        return _cycle(cfg, *t[:5], cycle_idx, clock, solver_iters, *t[5:],
                      solve_override)
    dev = carry.pos.device
    if graph.engages(dev, trace.recording(), solve_override):
        key = (cfg, solver_iters, mpclib.refresh_cycle(cfg.planner, cycle_idx))
        return graph.run(key, tree, cycle_idx, cycle)
    if dev.type == "cuda":
        trace.count("closed_loop.graph_eager")
    with trace.span("cycle", cycle_idx):
        return cycle(tree, graph.clock(cycle_idx, dev))


def _cycle(cfg: IntentMPCConfig, scenario: Scenario, ref_traj: torch.Tensor,
           traj_len: int, occ: OccupancyGrid, carry: EngineCarry,
           cycle_idx: int, clock: torch.Tensor, solver_iters: Optional[int],
           veto_occ: Optional[OccupancyGrid], ref_key: Optional[torch.Tensor],
           solve_override) -> Tuple[EngineCarry, torch.Tensor]:
    """episode_step's body. `clock` holds cycle_idx as a float32 scalar on
    the device, the cycle's time read from it; a graph's replays write
    their own cycle into it. cycle_idx itself steers the shared factor's
    refresh, part of a graph's variant key, and a goal-mode build's RRT
    key, whose cycles read the host and stay eager."""
    ecfg = cfg.engine
    dev = carry.pos.device
    S = carry.pos.shape[0]
    cycle_dt = ecfg.control_dt * ecfg.ticks_per_cycle
    dt = ecfg.control_dt
    t0 = clock * cycle_dt
    goal = constant(tuple(cfg.goal), dev)
    active = ~carry.done

    with trace.span("perceive"):
        # ---- detector updates at cycle start ----
        obs_pos0, _ = obstacle_state(scenario, t0)
        rd = carry.real_det
        if ecfg.use_fake_detector:
            d = det.fd_update(cfg.detector, carry.detector, obs_pos0, t0)
            d = det.hist_push(d, obs_pos0)
            # predictor_stale_hist: the predictor and the MPC read the history
            # as of the previous cycle's last 30 Hz tick (the reference's 30 Hz
            # predictor-timer staleness bound); by default the fresh push
            d_query = carry.detector if ecfg.predictor_stale_hist else d
            pos_h, vel_h, acc_h, size_h, hist_len, visible = det.query_history(
                cfg.detector, d_query, scenario.bbox, carry.pos)
        else:
            # real perception (use_fake_detector=false, mpcNavigation.cpp:
            # 129-136): render a depth frame at the drone's pose, run the
            # detect/track/classify stack and query track histories
            d = carry.detector
            cam_occ = occ if ecfg.render_static_grid else None
            if not cfg.real_detector.static_map_veto:
                veto_occ = None
            elif veto_occ is None:
                veto_occ = occ
            rd = _sense(cfg, rd, scenario, carry.pos, carry.yaw, obs_pos0,
                        cam_occ, veto_occ)
            pos_h, vel_h, acc_h, size_h, hist_len, visible = rdet.query_history(
                cfg.real_detector, cfg.detector, rd, carry.pos,
                static_occ=veto_occ)

        # ---- replan-check collision monitor (replanCheckCB :414-422); in
        # predefined-goal mode it only counts: the engine replans every cycle
        if ecfg.replan_check:
            elapsed = (carry.traj_age.to(torch.float32) + 1.0) * cycle_dt
            traj_hit = carry.traj_ready & active & committed_collision(
                cfg, carry.planner, occ, elapsed, pos_h[:, :, 0],
                size_h[:, :, 0], visible)
        else:
            traj_hit = torch.zeros((S,), dtype=torch.bool, device=dev)
        planner_in = carry.planner
        ref_anchor = carry.ref_anchor
        stop_replan = goal_invalid = build = committed = None
        if ecfg.goal_mode:
            # goal mode: a collision in the committed trajectory stops it,
            # discards it and replans from hover (:474-480); a statically
            # occupied goal region is an invalid goal, a permanent stop
            # (:460-471)
            stop_replan = traj_hit
            goal_invalid = active & goal_region_occupied(occ, goal, S)
            fresh = mpclib.init_planner_state(cfg.planner, S, dev)
            planner_in = tree_where(stop_replan, fresh, planner_in)
            ref_anchor = tree_where(stop_replan, carry.pos, carry.ref_anchor)
            L = ref_traj.shape[0]
            if ecfg.ref_mode == "linspace":
                # the straight input trajectory from the anchor, rebuilt every
                # cycle (valid only over an empty corridor)
                ref_traj = linspace(ref_anchor, goal.expand(S, 3), L)
                traj_len = torch.full((S,), L, dtype=torch.int32, device=dev)
            else:
                # stop pass -> build pass -> solve pass, like the reference's
                # refTrajReady_ handshake: the build pass does not solve the
                # MPC, and updatePath resets the planner's warm state
                build = carry.need_ref & ~stop_replan & active
                ref_traj, traj_len, committed = _build_ref(
                    cfg, occ, carry, goal, build, ref_key, cycle_idx)
                planner_in = tree_where(committed, fresh, planner_in)

        static_obs = (_static_rows(cfg, occ, carry.pos)
                      if cfg.planner.static_clustering else None)

        dyn_safety, stall_new = None, carry.stall_cycles
        if ecfg.goal_relax:
            stall_new, dyn_safety = _goal_relax(cfg, carry, goal, active)

    # ---- predictor + MPC (mpcCB :290-365) ----
    if ecfg.use_predictor:
        with trace.span("predict"):
            prediction = predlib.predict(cfg.predictor, pos_h, vel_h, acc_h,
                                         size_h, hist_len, occ)
        with trace.span("plan"):
            plan_out = mpclib.make_plan_with_pred(
                cfg.planner, planner_in, carry.pos, carry.vel, ref_traj,
                traj_len, prediction, visible, solver_iters,
                cycle_idx=cycle_idx,
                curr_yaw=carry.yaw if ecfg.use_fov else None,
                dyn_safety=dyn_safety, static_obs=static_obs,
                solve_override=solve_override)
    else:
        # use_predictor=false: obstacles held constant over the horizon
        # (mpcNavigation.cpp:301-311 + updateDynamicObstacles); as in JAX
        # this path takes no FOV rows
        with trace.span("plan"):
            plan_out = mpclib.make_plan(
                cfg.planner, planner_in, carry.pos, carry.vel, ref_traj,
                traj_len, pos_h[:, :, 0], vel_h[:, :, 0], size_h[:, :, 0],
                visible, solver_iters, static_obs=static_obs,
                dyn_safety=dyn_safety)

    run_mpc = active & ~carry.stopping
    traj_ready = carry.traj_ready
    if ecfg.goal_mode:
        # stop_replan and goal_invalid cycles hold position and commit no
        # plan (stop() + mpcTrajectoryReady_ = false), nor does a build
        run_mpc = run_mpc & ~stop_replan & ~goal_invalid
        if build is not None:
            run_mpc = run_mpc & ~build
        traj_ready = traj_ready & ~stop_replan
    planner = tree_where(run_mpc, plan_out.state, planner_in)
    valid = plan_out.valid & run_mpc
    traj_ready = traj_ready | valid
    traj_age = torch.where(valid, torch.zeros_like(carry.traj_age),
                           carry.traj_age + 1)

    if ecfg.goal_mode and ecfg.replan_check:
        # goal mode also vets the freshly committed plan: the reference's
        # 100 Hz replanCheckCB fires within 10 ms of a commit (:474-480)
        post_hit = valid & committed_collision(
            cfg, planner, occ, torch.full((S,), dt, device=dev),
            pos_h[:, :, 0], size_h[:, :, 0], visible)
        planner = tree_where(post_hit, mpclib.init_planner_state(
            cfg.planner, S, dev), planner)
        traj_ready = traj_ready & ~post_hit
        stop_replan = stop_replan | post_hit
        traj_hit = traj_hit | post_hit

    best_prim = mpclib._rows(plan_out.prim_res, plan_out.best_idx)
    m = carry.metrics
    metrics = m._replace(
        solve_attempts=m.solve_attempts + run_mpc.to(torch.int32),
        solve_successes=m.solve_successes + valid.to(torch.int32),
        prim_res_sum=m.prim_res_sum
        + torch.where(run_mpc, best_prim, torch.zeros_like(best_prim)),
        prim_res_max=torch.where(
            run_mpc, torch.maximum(m.prim_res_max, best_prim), m.prim_res_max),
        traj_collision_cycles=m.traj_collision_cycles
        + traj_hit.to(torch.int32))
    if ecfg.goal_mode:
        metrics = metrics._replace(
            stop_replans=m.stop_replans + stop_replan.to(torch.int32))

    # ---- goal stop / path repeat (replanCheckCB :414-456): after 3 s of
    # tracking in predefined-goal mode, on distance alone in goal mode
    # (:482-494) ----
    near_goal = torch.linalg.vector_norm(carry.pos - goal, dim=-1) \
        <= ecfg.goal_stop_threshold
    if not ecfg.goal_mode:
        near_goal = near_goal & (t0 - carry.tracking_start >= 3.0)
    stop_pos = tree_where(carry.stopping, carry.stop_pos, carry.pos)
    repeats_left, tracking_start = carry.repeats_left, carry.tracking_start
    if ecfg.repeat_path > 1:
        # re-track the same path (updatePath resets the planner state)
        # until the last round's goal stop
        do_repeat = near_goal & active & (carry.repeats_left > 1)
        stopping = carry.stopping \
            | (near_goal & active & (carry.repeats_left <= 1))
        repeats_left = torch.where(do_repeat, carry.repeats_left - 1,
                                   carry.repeats_left)
        tracking_start = torch.where(do_repeat, t0, carry.tracking_start)
        planner = tree_where(do_repeat, mpclib.init_planner_state(
            cfg.planner, S, dev), planner)
        traj_ready = traj_ready & ~do_repeat
    else:
        stopping = carry.stopping | (near_goal & active)
    if ecfg.goal_mode:
        stopping = stopping | goal_invalid

    pos, vel = carry.pos, carry.vel
    quad = carry.quad
    ctrl = carry.controller
    prev_acc = carry.prev_target_acc
    has_prev = carry.has_prev_target
    yaw = carry.yaw
    done = carry.done

    H = cfg.planner.horizon
    end_time = H * cfg.planner.ts
    zero3 = torch.zeros_like(pos)

    with trace.span("ticks"):
        for k in range(ecfg.ticks_per_cycle):
            tk = t0 + k * dt
            t_traj = traj_age.to(torch.float32) * cycle_dt + k * dt   # (S,)

            # ---- target from trajectory (trajExeCB :499-567) ----
            tp = mpclib.sample_pos(cfg.planner, planner.states_sol, t_traj)
            tv = mpclib.sample_vel(cfg.planner, planner.states_sol, t_traj)
            ta = mpclib.sample_acc(cfg.planner, planner.controls_sol, t_traj)
            past_end = t_traj >= end_time
            tv = tree_where(past_end, zero3, tv)
            ta = tree_where(past_end, zero3, ta)
            # stop mode or no trajectory: hold position
            hold = stopping | ~traj_ready
            hold_pos = tree_where(stopping, stop_pos, pos)
            tp = tree_where(hold, hold_pos, tp)
            tv = tree_where(hold, zero3, tv)
            ta = tree_where(hold, zero3, ta)

            # ---- control + dynamics ----
            acc_cmd, ctrl_new = acc_command(cfg.control, ctrl, pos, vel, tp, tv,
                                            ta, dt)
            ctrl = tree_where(active, ctrl_new, ctrl)
            if ecfg.perfect_tracking:
                new_pos, new_vel = tp, tv
            elif ecfg.plant == "quadrotor":
                # rigid-body plant (quadcopterPlugin acc-control mode): the
                # controller's world-acc command and the trajectory heading
                # drive the PID -> force/torque cascade
                quad = tree_where(active, quad_step(QuadPlantConfig(), quad,
                                                    acc_cmd, yaw, dt), quad)
                new_pos, new_vel = quad.pos, quad.vel
            else:
                new_vel = vel + acc_cmd * dt
                new_pos = pos + vel * dt + 0.5 * acc_cmd * dt ** 2
            step_len = torch.linalg.vector_norm(new_pos - pos, dim=-1)
            pos = tree_where(active, new_pos, pos)
            vel = tree_where(active, new_vel, vel)

            # ---- world state at this tick ----
            obs_pos_t, _ = obstacle_state(scenario, tk + dt)
            # ~30 Hz history pushes; tick 0's push is the cycle-start push above
            if k in ecfg.hist_ticks and k != 0:
                if ecfg.use_fake_detector:
                    d2 = det.fd_update(cfg.detector, d, obs_pos_t, tk + dt)
                    d = det.hist_push(d2, obs_pos_t)
                else:
                    rd = _sense(cfg, rd, scenario, pos, yaw, obs_pos_t, cam_occ,
                                veto_occ)

            # ---- monitor updates (masked once done) ----
            dist_boxes = _aabb_distance(pos, obs_pos_t, scenario.bbox)
            min_d = torch.amin(dist_boxes, dim=-1)
            hit = torch.any(dist_boxes <= 0.0, dim=-1)
            tol = ecfg.violation_tol
            v_viol = torch.any(torch.abs(tv) > ecfg.vel_limit + tol, dim=-1)
            a_viol = torch.any(torch.abs(ta) > ecfg.acc_limit + tol, dim=-1)
            jerk = (ta - prev_acc) / dt
            j_viol = torch.any(torch.abs(jerk) > ecfg.jerk_limit + tol,
                               dim=-1) & has_prev
            jmag = torch.linalg.vector_norm(jerk, dim=-1)
            vmag = torch.linalg.vector_norm(tv, dim=-1)
            amag = torch.linalg.vector_norm(ta, dim=-1)

            upd = active
            ui = upd.to(torch.int32)
            zf = torch.zeros_like(vmag)
            m = metrics
            metrics = m._replace(
                min_obstacle_dist=torch.where(
                    upd, torch.minimum(m.min_obstacle_dist, min_d),
                    m.min_obstacle_dist),
                collision=m.collision | (hit & upd),
                collision_count=m.collision_count + (hit & upd).to(torch.int32),
                path_length=m.path_length + torch.where(upd, step_len, zf),
                vel_violations=m.vel_violations + (v_viol & upd).to(torch.int32),
                acc_violations=m.acc_violations + (a_viol & upd).to(torch.int32),
                jerk_violations=m.jerk_violations + (j_viol & upd).to(torch.int32),
                samples=m.samples + ui,
                jerk_samples=m.jerk_samples + (has_prev & upd).to(torch.int32),
                max_velocity=torch.where(upd, torch.maximum(m.max_velocity, vmag),
                                         m.max_velocity),
                max_acceleration=torch.where(
                    upd, torch.maximum(m.max_acceleration, amag),
                    m.max_acceleration),
                sum_velocity=m.sum_velocity
                + torch.where(upd & (vmag > 0.01), vmag, zf),
                n_vel_valid=m.n_vel_valid + (upd & (vmag > 0.01)).to(torch.int32),
                jerk_sq_sum=m.jerk_sq_sum
                + torch.where(upd & has_prev, jmag ** 2, zf),
                jerk_abs_sum=m.jerk_abs_sum
                + torch.where(upd & has_prev, jmag, zf),
            )
            prev_acc = tree_where(active, ta, prev_acc)
            has_prev = has_prev | active
            if ecfg.yaw_lookahead > 0.0:
                yaw = _lookahead_yaw(cfg, planner, t_traj, yaw,
                                     active & traj_ready & ~hold & ~past_end)
            else:
                yaw = _velocity_yaw(tv, yaw, active)

            # goal criterion (run_mpc_benchmark.py:268-276); with repeat_path
            # the trial completes only once the last round's goal stop fired
            reached = (torch.linalg.vector_norm(pos - goal, dim=-1)
                       < ecfg.goal_dist_threshold) \
                & (torch.linalg.vector_norm(vel, dim=-1) < ecfg.goal_vel_threshold) \
                & active
            if ecfg.repeat_path > 1:
                reached = reached & stopping
            metrics = metrics._replace(
                goal_reached=metrics.goal_reached | reached,
                travel_time=torch.where(reached & ~done, tk + dt,
                                        metrics.travel_time))
            done = done | reached
            active = ~done

    new_carry = EngineCarry(
        pos=pos, vel=vel, detector=d, planner=planner, controller=ctrl,
        traj_age=traj_age, traj_ready=traj_ready,
        prev_target_acc=prev_acc, has_prev_target=has_prev,
        stopping=stopping, stop_pos=stop_pos, repeats_left=repeats_left,
        tracking_start=tracking_start, yaw=yaw,
        ref_anchor=ref_anchor, quad=quad, done=done, metrics=metrics,
        real_det=rd, stall_cycles=stall_new)
    if ecfg.goal_mode:
        # after a stop+replan the next cycle's reference re-anchors at the
        # held position (mpcCB :268-288)
        new_carry = new_carry._replace(
            ref_anchor=tree_where(stop_replan, pos, ref_anchor))
    if committed is not None:
        # the built trajectory is committed and refTrajReady_ flips true;
        # any stop+replan this cycle (the post-commit vet included) re-arms
        # the builder for the next cycle
        new_carry = new_carry._replace(
            ref_traj=ref_traj, ref_len=traj_len,
            need_ref=(carry.need_ref & ~committed) | stop_replan)
    return new_carry, pos


def run_episode(cfg: IntentMPCConfig, scenario: Scenario,
                ref_traj: torch.Tensor, traj_len,
                occ: Optional[OccupancyGrid] = None,
                solver_iters: Optional[int] = None,
                num_cycles: Optional[int] = None,
                record_path: bool = False,
                device=None,
                veto_occ: Optional[OccupancyGrid] = None,
                ref_key: Optional[torch.Tensor] = None,
                solve_override=None):
    """Run a batch of episodes (scenario axis S) on `device` (the GPU by
    default); occ, veto_occ, ref_key (one key per scenario) and
    solve_override as episode_step takes them. Returns (final EngineCarry,
    path (S, C, 3) or None)."""
    dev = resolve_device(device)
    scenario = Scenario(*(a.to(dev) for a in scenario))
    ref_traj = ref_traj.to(dev)
    occ = occ if occ is not None else empty_grid(dev)
    n = num_cycles if num_cycles is not None else cfg.engine.num_cycles
    carry = init_carry(cfg, scenario, device=dev, ref_len=ref_traj.shape[0])
    traj_len = int(traj_len)
    if ref_key is not None:
        ref_key = ref_key.to(dev)
    paths = []
    for i in range(n):
        carry, p = episode_step(cfg, scenario, ref_traj, traj_len, occ, carry,
                                i, solver_iters, veto_occ=veto_occ,
                                ref_key=ref_key,
                                solve_override=solve_override)
        if record_path:
            paths.append(p)
    return carry, (torch.stack(paths, dim=1) if record_path else None)


def summarize(cfg: IntentMPCConfig, carry: EngineCarry) -> list:
    """Host-side metric summary per scenario (BenchmarkMetrics fields)."""
    m = Metrics(*(a.detach().cpu() for a in carry.metrics))
    straight = float(torch.linalg.vector_norm(
        torch.tensor(cfg.goal) - torch.tensor(cfg.start)))
    dt = cfg.engine.control_dt
    out = []
    for i in range(m.goal_reached.shape[0]):
        pl = float(m.path_length[i])
        n_j = max(int(m.jerk_samples[i]), 1)
        out.append({
            "goal_reached": bool(m.goal_reached[i]),
            "timeout_reached": not bool(m.goal_reached[i]),
            "collision": bool(m.collision[i]),
            "collision_count": int(m.collision_count[i]),
            "flight_travel_time": float(m.travel_time[i]),
            "path_length": pl,
            "straight_line_distance": straight,
            "path_efficiency": pl / straight if straight > 0 else 0.0,
            "min_distance_to_obstacles": float(m.min_obstacle_dist[i]),
            "vel_violation_count": int(m.vel_violations[i]),
            "acc_violation_count": int(m.acc_violations[i]),
            "jerk_violation_count": int(m.jerk_violations[i]),
            "vel_total_samples": int(m.samples[i]),
            "acc_total_samples": int(m.samples[i]),
            "jerk_total_samples": int(m.jerk_samples[i]),
            "max_velocity": float(m.max_velocity[i]),
            "max_acceleration": float(m.max_acceleration[i]),
            "avg_velocity": float(m.sum_velocity[i])
            / max(int(m.n_vel_valid[i]), 1),
            "jerk_rms": float(torch.sqrt(m.jerk_sq_sum[i] / n_j)),
            "jerk_integral": float(m.jerk_abs_sum[i]) * dt,
            "mpc_solve_count": int(m.solve_attempts[i]),
            "mpc_solve_successes": int(m.solve_successes[i]),
            "mpc_prim_res_avg": float(m.prim_res_sum[i])
            / max(int(m.solve_attempts[i]), 1),
            "mpc_prim_res_max": float(m.prim_res_max[i]),
            "traj_collision_cycles": int(m.traj_collision_cycles[i]),
            "stop_replans": int(m.stop_replans[i]),
        })
    return out


def perception_summary(carry: EngineCarry) -> list:
    """Track-vs-GT perception quality of real-detector episodes, one dict
    per scenario (models/real_detector.PerceptionStats); [] on the GT
    path."""
    if carry.real_det is None:
        return []
    st = rdet.PerceptionStats(*(a.detach().cpu()
                                for a in carry.real_det.stats))
    out = []
    for i in range(st.err_n.shape[0]):
        err_n = max(int(st.err_n[i]), 1)
        out.append({
            "track_pos_rmse": float(math.sqrt(float(st.err_sq_sum[i])
                                              / err_n)),
            "track_matches": int(st.err_n[i]),
            "missed_rate": float(st.missed_sum[i])
            / max(int(st.gt_in_fov_sum[i]), 1),
            "missed_count": int(st.missed_sum[i]),
            "gt_in_fov_ticks": int(st.gt_in_fov_sum[i]),
            "spurious_rate": float(st.spurious_sum[i])
            / max(int(st.track_ticks_sum[i]), 1),
            "spurious_count": int(st.spurious_sum[i]),
            "dyn_track_ticks": int(st.track_ticks_sum[i]),
            "track_births": int(st.births_sum[i]),
        })
    return out
