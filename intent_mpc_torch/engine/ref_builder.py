"""Goal-mode MPC input-trajectory builder: [RRT ->] corridor-constrained
min-snap -> dt-sampled reference (port of
intent_mpc_tpu/engine/ref_builder.py).

Rebuild of the reference's goal-mode trajectory composition
(mpcNavigation.cpp:239-290): when `refTrajReady_` is false the reference
never hands the MPC a raw straight line. It either

  * routes through the static map with the goal-biased RRT first
    (useGlobalPlanner_, :240-265: rrtPlanner_->makePlan -> waypoints), or
  * takes the 2-waypoint [odom, goal] path (:267-289),

then builds a corridor-constrained min-snap polynomial over those
waypoints with zero start/end vel/acc (polyTraj_->updatePath + makePlan(),
the corridor-shrink loop of polyTrajOccMap.cpp:252-335) and samples it at
dt = 0.1 (getTrajectory(0.1)) as the MPC input trajectory
(mpc_->updatePath).

Deviations kept from the JAX package: the RRT's variable-length waypoint
list is resampled to `ref_waypoints` points at uniform arc length (a static
QP shape); the RRT sampling box is the start/goal pair plus a margin; on
RRT failure the builder falls back to the straight path and reports
route_ok False (the engine then retries). Every function takes a batch of
S problems, one per scenario.
"""

from __future__ import annotations

from typing import Tuple

import torch

from intent_mpc_torch.models import poly_planner, poly_traj
from intent_mpc_torch.models.global_planner import RRTConfig, rrt_plan
from intent_mpc_torch.models.occupancy import OccupancyGrid
from intent_mpc_torch.utils.rounding import fma


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int
             ) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` for points (S, 3) -> (S, num, 3),
    rounded as the JAX package's compiled CPU program rounds it: step
    i * (1 / (num - 1)), start (1 - step) + stop step with the product
    start (1 - step) fused into the add, the stop itself last."""
    if num == 1:
        return start[:, None]
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=start.device) \
        * torch.tensor(1.0 / div, dtype=torch.float32)
    step = step[:, None]
    out = fma(start[:, None], 1.0 - step, stop[:, None] * step)
    return torch.cat([out, stop[:, None]], dim=1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[s, idx[s]] for x (S, N, ...) and idx (S,)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def resample_path(path: torch.Tensor, n: torch.Tensor, num_out: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample padded polylines (S, Lp, 3) with `n` (S,) valid points to
    `num_out` points at uniform arc length. Returns (points (S, num_out,
    3), total length (S,))."""
    S, Lp, _ = path.shape
    dev = path.device
    seg = path[:, 1:] - path[:, :-1]
    seglen = torch.linalg.vector_norm(seg, dim=-1)
    seglen = torch.where(torch.arange(Lp - 1, device=dev) < (n - 1)[:, None],
                         seglen, torch.zeros_like(seglen))
    cum = torch.cat([torch.zeros_like(seglen[:, :1]),
                     torch.cumsum(seglen, dim=1)], dim=1)        # (S, Lp)
    last = torch.clamp(n - 1, 0, Lp - 1).to(torch.int64)
    total = _rows(cum, last)
    zero, one = torch.zeros((S, 1), device=dev), torch.ones((S, 1), device=dev)
    s = linspace(zero, one, num_out)[..., 0] * total[:, None]
    idx = torch.clamp(torch.searchsorted(cum, s.contiguous(), right=True) - 1,
                      0, Lp - 2)
    frac = (s - torch.gather(cum, 1, idx)) \
        / torch.clamp(torch.gather(seglen, 1, idx), min=1e-9)
    ix3 = idx[..., None].expand(S, num_out, 3)
    pts = torch.gather(path, 1, ix3) \
        + torch.gather(seg, 1, ix3) * torch.clamp(frac, 0.0, 1.0)[..., None]
    pts = torch.cat([path[:, :1], pts[:, 1:-1], _rows(path, last)[:, None]],
                    dim=1)
    return pts, total


def build_goal_ref(ecfg, occ: OccupancyGrid, start: torch.Tensor,
                   goal: torch.Tensor, key: torch.Tensor, length: int,
                   dt: float = 0.1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The MPC input trajectories of a batch in goal mode.

    ecfg: EngineConfig (ref_mode "minsnap" | "global" and its knobs);
    start, goal (S, 3); key (S, 2) (the RRT's, ref_mode "global").
    Returns (ref_traj (S, length, 3), traj_len (S,) int32, poly_ok (S,)
    bool, route_ok (S,) bool): poly_ok = a corridor-constrained polynomial
    was found (False = the pwl failsafe is in effect); route_ok = the RRT
    found a route (always True outside "global"); the engine retries the
    build next cycle where it is False."""
    S = start.shape[0]
    dev = start.device
    start = start.to(torch.float32)
    goal = goal.to(torch.float32).expand(S, 3)
    route_ok = torch.ones((S,), dtype=torch.bool, device=dev)

    if ecfg.ref_mode == "global":
        m = ecfg.ref_bounds_margin
        lo = torch.minimum(start, goal) - m
        hi = torch.maximum(start, goal) + m
        lo = torch.cat([lo[:, :2], torch.clamp(lo[:, 2:], min=ecfg.ref_z_min)],
                       dim=1)
        rrt = rrt_plan(occ, start, goal, lo, hi, key,
                       RRTConfig(max_iters=ecfg.ref_rrt_iters,
                                 incremental_dist=ecfg.ref_rrt_step,
                                 goal_reach_dist=max(0.4, ecfg.ref_rrt_step),
                                 max_shortcut_dist=ecfg.ref_rrt_shortcut))
        # the RRT ends at a node within goal_reach_dist; the goal itself is
        # appended as the last waypoint (rrtBase backtracking pushes the
        # goal onto the plan) before the arc-length resampling
        Lp = rrt.path.shape[1]
        gi = torch.clamp(rrt.length, 0, Lp - 1).to(torch.int64)
        path = rrt.path.clone()
        path[torch.arange(S, device=dev), gi] = goal
        wps, _ = resample_path(path, torch.clamp(rrt.length + 1, max=Lp),
                               ecfg.ref_waypoints)
        straight = linspace(start, goal, ecfg.ref_waypoints)
        wps = torch.where(rrt.success[:, None, None], wps, straight)
        route_ok = rrt.success
    elif ecfg.ref_mode == "minsnap":
        wps = torch.stack([start, goal], dim=1)
    else:
        raise ValueError("build_goal_ref: bad ref_mode %r" % (ecfg.ref_mode,))

    ppcfg = poly_planner.PolyPlanConfig(
        initial_radius=ecfg.ref_corridor_radius,
        angular_vel=ecfg.ref_angular_vel,
        poly=poly_traj.PolyTrajConfig(max_iter=ecfg.ref_poly_iters))
    res = poly_planner.plan(ppcfg, wps, ecfg.ref_vel, occ)

    total_t = torch.where(res.valid, res.traj.times[:, -1],
                          res.failsafe.duration)
    idx = torch.arange(length, device=dev)
    tt = torch.minimum(idx.to(torch.float32)[None] * dt, total_t[:, None])
    ref = poly_planner.sample(res, tt)
    traj_len = torch.clamp(torch.ceil(total_t / dt).to(torch.int64) + 1,
                           2, length)

    # endpoint guarantee (the JAX package's protocol-scale fix): the
    # reference solves its per-axis min-snap QPs with converged OSQP, so its
    # input trajectory starts at odom and ends at the goal; the budgeted
    # dense ADMM can leave a metre-scale sag at both ends on long
    # ill-conditioned routes. Restore both by construction: a linearly
    # decaying correction at the head, and a ref_vel-paced straight walk
    # from the sampled end to the goal at the tail.
    step = max(ecfg.ref_vel * dt, 1e-6)
    head_err = start - ref[:, 0]
    head_gap = torch.linalg.vector_norm(head_err, dim=-1)
    n_head = torch.clamp(torch.ceil(head_gap / step).to(torch.int64),
                         1, length)
    decay = torch.clamp(1.0 - idx / n_head[:, None], 0.0, 1.0)
    ref = torch.where((head_gap > 0.05)[:, None, None],
                      ref + decay[..., None] * head_err[:, None], ref)

    end = _rows(ref, torch.clamp(traj_len - 1, 0, length - 1))
    gap = torch.linalg.vector_norm(goal - end, dim=-1)
    n_tail = torch.clamp(torch.ceil(gap / step).to(torch.int64), 1, length)
    frac = torch.clamp((idx - (traj_len - 1)[:, None]) / n_tail[:, None],
                       0.0, 1.0)
    need_tail = gap > 0.05
    tail = need_tail[:, None] & (idx >= (traj_len - 1)[:, None])
    ref = torch.where(tail[..., None],
                      end[:, None] + frac[..., None] * (goal - end)[:, None],
                      ref)
    traj_len = torch.where(need_tail,
                           torch.clamp(traj_len + n_tail, max=length),
                           traj_len)

    # degenerate guard: already at the goal -> hold it
    tiny = torch.linalg.vector_norm(goal - start, dim=-1) < 0.05
    ref = torch.where(tiny[:, None, None], goal[:, None], ref)
    traj_len = torch.where(tiny, torch.full_like(traj_len, 2), traj_len)
    return (ref, traj_len.to(torch.int32), res.valid | tiny,
            route_ok | tiny)
