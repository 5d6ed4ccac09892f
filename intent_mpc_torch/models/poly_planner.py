"""Occupancy-aware min-snap planning loop with corridor shrink and the
piecewise-linear failsafe (port of intent_mpc_tpu/models/poly_planner.py).

Rebuild of trajPlanner::polyTrajOccMap (trajectory_planner/polyTrajOccMap.cpp
:252-335): solve the corridor-constrained min-snap QP, check the sampled
trajectory against the occupancy map, shrink the corridor of colliding
segments by `shrinking_factor` (adjustCorridorSize :565-569), and fall back
to the piecewise-linear trajectory when no collision-free polynomial is
found within `max_iterations`.

The reference's wall-clock timeout becomes the fixed iteration budget
(`maximum_iteration_num`, planner_param.yaml: 10): every round runs, for a
batch of S planning problems at once, and the best-so-far trajectory is
kept per problem.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intent_mpc_torch.models import poly_traj, pwl_traj
from intent_mpc_torch.models.global_planner import occupied_at
from intent_mpc_torch.models.occupancy import OccupancyGrid


class PolyPlanConfig(NamedTuple):
    initial_radius: float = 0.5      # poly_traj/initial_radius
    shrinking_factor: float = 0.5    # poly_traj/shrinking_factor
    max_iterations: int = 10         # poly_traj/maximum_iteration_num
    sample_dt: float = 0.1           # poly_traj/sample_delta_time
    samples_per_check: int = 10      # collision samples per segment
    angular_vel: float = 1.0         # pwl-failsafe desired_angular_vel
                                     # (the rotate-in-place hold rate)
    poly: poly_traj.PolyTrajConfig = poly_traj.PolyTrajConfig()


class PolyPlanResult(NamedTuple):
    traj: poly_traj.PolyTrajectory
    valid: torch.Tensor              # (S,) bool: collision-free polynomial found
    used_failsafe: torch.Tensor      # (S,) bool
    failsafe: pwl_traj.PWLTrajectory


def _segment_collisions(cfg: PolyPlanConfig, tr: poly_traj.PolyTrajectory,
                        occ: OccupancyGrid) -> torch.Tensor:
    """Per-segment collision flags from sampled positions
    (checkCollisionTraj semantics). Returns (S, nseg) bool."""
    S, nseg = tr.coeffs.shape[:2]
    K = cfg.samples_per_check
    fr = (torch.arange(K, dtype=torch.float32, device=tr.times.device)
          + 0.5) / K
    t0, t1 = tr.times[:, :-1, None], tr.times[:, 1:, None]
    ts = t0 + (t1 - t0) * fr                                   # (S, nseg, K)
    pts = poly_traj.sample(tr, ts.reshape(S, nseg * K))
    return torch.any(occupied_at(occ, pts).reshape(S, nseg, K), dim=-1)


def _keep(cond: torch.Tensor, new: poly_traj.PolyTrajectory,
          old: poly_traj.PolyTrajectory) -> poly_traj.PolyTrajectory:
    """Per-problem select between two batches (the basis is shared)."""
    return new._replace(
        coeffs=torch.where(cond[:, None, None, None], new.coeffs, old.coeffs),
        times=torch.where(cond[:, None], new.times, old.times),
        prim_res=torch.where(cond[:, None], new.prim_res, old.prim_res))


def plan(cfg: PolyPlanConfig, waypoints: torch.Tensor, desired_vel: float,
         occ: OccupancyGrid) -> PolyPlanResult:
    """The corridor-shrink loop over a fixed iteration budget, for
    waypoints (S, N, 3)."""
    S, N, _ = waypoints.shape
    r = torch.full((S, N - 1), cfg.initial_radius, dtype=torch.float32,
                   device=waypoints.device)
    best, have_valid = None, None
    for _ in range(cfg.max_iterations):
        tr = poly_traj.plan(waypoints, desired_vel, cfg.poly, corridor_r=r)
        hits = _segment_collisions(cfg, tr, occ)
        valid = ~torch.any(hits, dim=-1)
        if best is None:
            best, have_valid = tr, valid
        else:
            # keep the first valid trajectory (the reference exits the loop)
            best = _keep(valid & ~have_valid, tr, best)
            have_valid = have_valid | valid
        r = torch.where(hits, r * cfg.shrinking_factor, r)

    failsafe = pwl_traj.plan(waypoints, desired_vel,
                             desired_angular_vel=cfg.angular_vel)
    return PolyPlanResult(traj=best, valid=have_valid,
                          used_failsafe=~have_valid, failsafe=failsafe)


def sample(res: PolyPlanResult, t: torch.Tensor, order: int = 0
           ) -> torch.Tensor:
    """The plan at times t (S, T): the polynomial where valid, the pwl
    failsafe's position otherwise (use_pwl_failsafe semantics; the
    failsafe has no derivatives). Returns (S, T, 3)."""
    p_poly = poly_traj.sample(res.traj, t, order=order)
    if order == 0:
        p_pwl, _ = pwl_traj.sample(res.failsafe, t)
    else:
        p_pwl = torch.zeros_like(p_poly)
    return torch.where(res.valid[:, None, None], p_poly, p_pwl)
