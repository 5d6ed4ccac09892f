"""Piecewise-linear trajectory: constant-velocity waypoint interpolation
with rotate-then-translate time allocation (port of
intent_mpc_tpu/models/pwl_traj.py).

Rebuild of trajPlanner::pwlTraj (trajectory_planner/piecewiseLinearTraj.cpp).
Each waypoint gets a yaw facing the next waypoint; the time line
alternates rotation segments (yaw interpolated at the desired angular
velocity, position held at the segment's start waypoint, :219-250) and
forward segments (linear position interpolation at the desired velocity,
yaw held). The first segment has no rotation time (:223-232
avgTimeAllocation).

A plan is (knot_times, poses, yaws) tensors with a leading scenario axis S;
`sample` is a batched searchsorted and masked interpolation. Zero-length
segments behave like the reference's < 1e-3 guard.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class PWLTrajectory(NamedTuple):
    waypoints: torch.Tensor  # (S, N, 3)
    yaws: torch.Tensor       # (S, N) facing yaw per waypoint
    knots: torch.Tensor      # (S, 2 (N - 1)) cumulative segment end times
    duration: torch.Tensor   # (S,)


def _yaw_diff_dir(y0: torch.Tensor, y1: torch.Tensor):
    """Shortest rotation magnitude and direction (getPose :225-243)."""
    diff = y1 - y0
    absd = torch.abs(diff)
    over = absd > math.pi
    mag = torch.where(over, 2 * math.pi - absd, absd)
    direction = torch.where(over, -torch.sign(diff), torch.sign(diff))
    direction = torch.where(direction == 0, torch.ones_like(direction),
                            direction)
    return mag, direction


def plan(waypoints: torch.Tensor, desired_vel: float,
         desired_angular_vel: float) -> PWLTrajectory:
    """avgTimeAllocation (piecewiseLinearTraj.cpp:85-121, useYaw=False)
    for waypoints (S, N, 3)."""
    S = waypoints.shape[0]
    seg = waypoints[:, 1:] - waypoints[:, :-1]               # (S, N-1, 3)
    yaw_seg = torch.atan2(seg[..., 1], seg[..., 0])
    yaws = torch.cat([yaw_seg, yaw_seg[:, -1:]], dim=1)
    fwd_t = torch.linalg.vector_norm(seg, dim=-1) / desired_vel
    # the rotation before segment i turns from segment i - 1's yaw to
    # segment i's; the first segment has none
    prev_mag, _ = _yaw_diff_dir(torch.cat([yaws[:, :1], yaws[:, :-2]], dim=1),
                                yaws[:, :-1])
    rot_t = prev_mag / desired_angular_vel
    rot_t = torch.cat([torch.zeros_like(rot_t[:, :1]), rot_t[:, 1:]], dim=1)
    # interleave [rot_0, fwd_0, rot_1, fwd_1, ...] cumulative
    knots = torch.cumsum(torch.stack([rot_t, fwd_t], dim=-1).reshape(S, -1),
                         dim=1)
    return PWLTrajectory(waypoints=waypoints, yaws=yaws, knots=knots,
                         duration=knots[:, -1])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[s, idx[s, t]] for x (S, K, ...) and idx (S, T)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + x.shape[2:]))


def sample(traj: PWLTrajectory, t: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position (S, T, 3) and yaw (S, T) at times t (S, T) (getPose
    :201-278), end-clamped."""
    knots = traj.knots
    K = knots.shape[1]
    N = traj.waypoints.shape[1]
    starts = torch.cat([torch.zeros_like(knots[:, :1]), knots[:, :-1]], dim=1)
    i = torch.clamp(torch.searchsorted(knots, t.contiguous(), right=False),
                    0, K - 1)
    seg_idx = i // 2
    is_rot = (i % 2) == 0            # even interleaved slots are rotations
    t0 = _take(starts, i)
    t1 = _take(knots, i)
    frac = torch.where(t1 - t0 < 1e-3, torch.zeros_like(t),
                       torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9),
                                   0.0, 1.0))
    p_curr = _take(traj.waypoints, seg_idx)
    p_next = _take(traj.waypoints, torch.clamp(seg_idx + 1, max=N - 1))
    y_prev = _take(traj.yaws, torch.clamp(seg_idx - 1, min=0))
    y_curr = _take(traj.yaws, seg_idx)

    # rotation period: hold the segment's start position, turn the yaw
    mag, direction = _yaw_diff_dir(y_prev, y_curr)
    rot_yaw = y_prev + direction * frac * mag
    # forward period: interpolate the position, hold the yaw
    fwd_pos = p_curr + frac[..., None] * (p_next - p_curr)

    past_end = t >= traj.duration[:, None]
    pos = torch.where(past_end[..., None], traj.waypoints[:, -1:],
                      torch.where(is_rot[..., None], p_curr, fwd_pos))
    yaw = torch.where(past_end, traj.yaws[:, -1:],
                      torch.where(is_rot, rot_yaw, y_curr))
    return pos, yaw


def discretize(traj: PWLTrajectory, dt: float, n_steps: int) -> torch.Tensor:
    """makePlan (:163-177): positions (S, n_steps, 3) every dt from 0,
    clamped at the end (callers size n_steps >= duration / dt + 1)."""
    S = traj.knots.shape[0]
    ts = torch.arange(n_steps, dtype=torch.float32,
                      device=traj.knots.device) * dt
    pos, _ = sample(traj, ts.expand(S, n_steps))
    return pos
