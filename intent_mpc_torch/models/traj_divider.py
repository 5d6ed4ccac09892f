"""Trajectory divider: braking-zone segmentation for the time optimizer
(port of intent_mpc_tpu/models/traj_divider.py), batched over a leading
scenario axis S.

Rebuild of time_optimizer/trajectoryDivider.cpp: given sampled
trajectories with timestamps and occupancy grids, find the time intervals
where a trajectory passes close to obstacles in its direction of travel
("braking zones"), merge and filter them with the reference's hysteresis
rules, and report the minimum obstacle distance per zone.
bsplineTimeOptimizer.cpp:36-46 feeds these intervals to the time
optimizer, which lowers the velocity limit inside the zones.

As in the JAX package:
  * the nearest occupied voxel within `safe_dist` comes from a local
    window over the grid per sample ((2 r + 1)^3 lookups, r = window_vox),
    not a KD-tree (buildKDTree / findNearestObstacles :140-193); the
    window's squared distances are the sums of per-axis squares;
  * interval extraction (divideTrajectory :195-287) is a run-length
    encoding of the sample mask, then a merge over the first
    `max_intervals` runs with the reference's duration filter and gap
    merge;
  * the per-zone obstacle distance is the minimum over the zone's samples
    (the reference indexes it by the interval counter, an evident bug).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intent_mpc_torch.models.occupancy import OccupancyGrid, _per_scenario
from intent_mpc_torch.utils.device import f32
from intent_mpc_torch.utils.grid import WIN_X, WIN_Y, WIN_Z
from intent_mpc_torch.utils.rounding import sq_norm3, sqrt32


class DividerParams(NamedTuple):
    max_length: float = 20.0            # trajectoryDivider.h:39
    safe_dist: float = 1.0              # :40
    min_time_interval_ratio: float = 0.1  # :41
    min_time: float = 0.5               # :42
    min_interval_diff_ratio: float = 0.05  # :43
    min_time_diff: float = 0.25         # :44
    max_intervals: int = 8              # fixed-shape zone slots
    window_vox: int = 10                # window radius (>= safe_dist/res)
    close_gap_samples: int = 2          # fill sample-mask gaps up to this
                                        # many samples before run extraction


class DividerResult(NamedTuple):
    in_zone: torch.Tensor        # (S, N) bool: sample inside a kept zone
    t_lo: torch.Tensor           # (S, I) zone start times
    t_hi: torch.Tensor           # (S, I) zone end times
    zone_valid: torch.Tensor     # (S, I) bool
    obstacle_dist: torch.Tensor  # (S, I) min obstacle distance inside zone
    sample_dist: torch.Tensor    # (S, N) distance to nearest forward obstacle
                                 # (inf where none within safe_dist)


def _nearest_in_window(occ: OccupancyGrid, p: torch.Tensor, r: int):
    """Nearest occupied voxel center within the (2r+1)^3 window around each
    point p (S, N, 3) of scenario s's grid (a shared grid, or one per
    scenario). Returns (dist (S, N), direction p_nn - p (S, N, 3)); dist
    is +inf where no voxel of the window is occupied (ties to the first
    window voxel, x-major)."""
    grid4 = _per_scenario(occ)
    dims = grid4.shape[1:]
    dev = p.device
    base = torch.floor((p - occ.origin) / occ.resolution).to(torch.int64)
    off = torch.arange(-r, r + 1, device=dev)
    ax = []
    for a in range(3):
        i = base[..., a, None] + off                          # (S, N, W)
        inb = (i >= 0) & (i < dims[a])
        ic = torch.clamp(i, 0, dims[a] - 1)
        c = occ.origin[a] + (ic.to(torch.float32) + 0.5) * occ.resolution
        ax.append((ic, inb, c - p[..., a, None]))
    (ix, inx, dx), (iy, iny, dy), (iz, inz, dz) = ax
    S = p.shape[0]
    if grid4.shape[0] == 1:
        vals = grid4[0][ix[WIN_X], iy[WIN_Y], iz[WIN_Z]]
    else:
        sc = torch.arange(S, device=dev)[:, None, None, None, None]
        vals = grid4[sc, ix[WIN_X], iy[WIN_Y], iz[WIN_Z]]
    hit = (vals > 0) & inx[WIN_X] & iny[WIN_Y] & inz[WIN_Z]
    d = sqrt32((dx * dx)[WIN_X] + (dy * dy)[WIN_Y] + (dz * dz)[WIN_Z])
    d = torch.where(hit, d, f32(float("inf"), dev)).flatten(-3)
    dist, k = torch.min(d, dim=-1)
    W = 2 * r + 1
    kx, ky, kz = k // (W * W), (k // W) % W, k % W
    direc = torch.stack([torch.gather(dx, -1, kx[..., None])[..., 0],
                         torch.gather(dy, -1, ky[..., None])[..., 0],
                         torch.gather(dz, -1, kz[..., None])[..., 0]], dim=-1)
    return dist, direc


def divide(traj: torch.Tensor, times: torch.Tensor, occ: OccupancyGrid,
           params: DividerParams = DividerParams()) -> DividerResult:
    """Segment sampled trajectories (S, N, 3) with timestamps (S, N) into
    braking zones near obstacles (trajDivider::run)."""
    S, N, _ = traj.shape
    dev = traj.device
    I = params.max_intervals
    inf = f32(float("inf"), dev)
    zero = f32(0.0, dev)

    # ---- max-length cutoff (findRange :71-79) ----
    seg = sqrt32(sq_norm3(traj[:, 1:] - traj[:, :-1]))
    arclen = torch.cat([torch.zeros((S, 1), device=dev),
                        torch.cumsum(seg.double(), dim=1).float()], dim=1)
    within = arclen <= params.max_length

    # ---- nearest forward obstacle per sample (findNearestObstacles) ----
    dist, direc = _nearest_in_window(occ, traj, params.window_vox)
    vel_dir = torch.cat([traj[:, 1:] - traj[:, :-1],
                         torch.zeros((S, 1, 3), device=dev)], dim=1)
    forward = torch.sum(vel_dir * direc, dim=-1) >= 0.0      # angle <= pi/2
    last = torch.arange(N, device=dev) == N - 1
    mask = (dist <= params.safe_dist) & forward & within & ~last
    sample_dist = torch.where(mask, dist, inf)

    # ---- close small gaps (binary closing along time) ----
    g = params.close_gap_samples
    if g > 0:
        left, right = mask, mask
        no = torch.zeros((S, g), dtype=torch.bool, device=dev)
        for k in range(1, g + 1):
            left = left | torch.cat([no[:, :k], mask[:, :-k]], dim=1)
            right = right | torch.cat([mask[:, k:], no[:, :k]], dim=1)
        mask = mask | (left & right)

    # ---- raw runs (divideTrajectory :201-226) ----
    prev = torch.cat([torch.zeros((S, 1), dtype=torch.bool, device=dev),
                      mask[:, :-1]], dim=1)
    starts = mask & ~prev
    run_id = torch.cumsum(starts.to(torch.int64), dim=1) * mask - 1
    ids = torch.arange(N, device=dev)
    inr = run_id[:, None, :] == torch.arange(I, device=dev)[:, None]  # (S,I,N)
    any_r = torch.any(inr, dim=-1)
    i0 = torch.amin(torch.where(inr, ids, N), dim=-1)
    i1 = torch.amax(torch.where(inr, ids, -1), dim=-1)
    t0s = torch.gather(times, 1, torch.clamp(i0, 0, N - 1))
    t1s = torch.gather(times, 1, torch.clamp(i1, 0, N - 1))
    dmins = torch.amin(torch.where(inr, sample_dist[:, None], inf), dim=-1)

    # ---- duration filter + gap merge (:229-256) ----
    T = times[:, -1]
    dur_thresh = torch.clamp(params.min_time_interval_ratio * T,
                             max=params.min_time)
    gap_thresh = torch.clamp(params.min_interval_diff_ratio * T,
                             max=params.min_time_diff)
    ar = torch.arange(S, device=dev)
    lo = torch.zeros((S, I), device=dev)
    hi = torch.zeros((S, I), device=dev)
    dist_z = torch.full((S, I), float("inf"), device=dev)
    valid = torch.zeros((S, I), dtype=torch.bool, device=dev)
    count = torch.zeros((S,), dtype=torch.int64, device=dev)
    prev_end = torch.zeros((S,), device=dev)
    for r in range(I):
        t0, t1, dm = t0s[:, r], t1s[:, r], dmins[:, r]
        keep = any_r[:, r] & ((t1 - t0) > dur_thresh)
        gap_ok = (t0 - prev_end) > gap_thresh
        is_first = count == 0
        # new zone: far enough from the previous kept zone (or first,
        # which merges back to t=0 per the reference's first-zone rule)
        new_idx = torch.clamp(count, 0, I - 1)
        open_new = keep & (gap_ok | is_first)
        t0_eff = torch.where(is_first & ~gap_ok, zero, t0)
        lo[ar, new_idx] = torch.where(open_new, t0_eff, lo[ar, new_idx])
        hi[ar, new_idx] = torch.where(open_new, t1, hi[ar, new_idx])
        dist_z[ar, new_idx] = torch.where(open_new, dm, dist_z[ar, new_idx])
        valid[ar, new_idx] = valid[ar, new_idx] | open_new
        # merge into the previous kept zone
        m_idx = torch.clamp(count - 1, 0, I - 1)
        do_merge = keep & ~gap_ok & ~is_first
        hi[ar, m_idx] = torch.where(do_merge, t1, hi[ar, m_idx])
        dist_z[ar, m_idx] = torch.where(
            do_merge, torch.minimum(dist_z[ar, m_idx], dm), dist_z[ar, m_idx])
        count = count + open_new.to(torch.int64)
        prev_end = torch.where(keep, t1, prev_end)

    in_zone = torch.any((times[:, :, None] >= lo[:, None])
                        & (times[:, :, None] <= hi[:, None])
                        & valid[:, None], dim=-1)
    return DividerResult(in_zone=in_zone, t_lo=lo, t_hi=hi, zone_valid=valid,
                         obstacle_dist=dist_z, sample_dist=sample_dist)


def zone_velocity_limits(res: DividerResult, v_max: float, safe_dist: float,
                         v_floor_ratio: float = 0.3) -> torch.Tensor:
    """Per-sample velocity limits (S, N) for the TOPP stage: inside a
    braking zone the limit scales with the obstacle clearance (the role of
    timeOptimizer::divideData's per-segment velocityLimits,
    timeOptimizer.cpp:42-124), floored at v_floor_ratio * v_max."""
    dev = res.sample_dist.device
    scale = torch.clamp(res.sample_dist / f32(safe_dist, dev),
                        v_floor_ratio, 1.0)
    return torch.where(res.in_zone, v_max * scale, f32(v_max, dev))
