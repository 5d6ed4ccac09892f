"""Real-detector-in-the-loop: the depth-camera perception stack packaged
as an engine-side detector (EngineConfig.use_fake_detector=False); port
of intent_mpc_tpu/models/real_detector.py, batched over a leading
scenario axis S.

The reference selects the full onboard_detector::dynamicDetector over the
GT fake detector with one flag (use_fake_detector, mpcNavigation.cpp:
129-136). One update per ~30 Hz history tick:

  render (models/sensor.render_depth, the Gazebo camera stand-in)
    -> project_depth (occupancyMap.cpp projectDepthImage)
    -> DBSCAN clusters -> fixed-shape AABB extraction
       (dynamicDetector.cpp detectionCB / clusterPointsAndBBoxes)
    -> const-vel KF track table (trackingCB :719-732)
    -> displacement voting (classificationCB :734-914)
    -> per-track history rings in the predictor's
       getDynamicObstaclesHist format (newest first, robot-inflated
       sizes, 2D range gate)

Detections live in `max_detections` padded slots, tracks in `max_tracks`
slots; the cluster extraction keys each cluster on its DBSCAN label (the
minimum member index) and reduces with deterministic integer scatter-add
and float scatter min/max.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from intent_mpc_torch.models import perception as pc
from intent_mpc_torch.models import sensor
from intent_mpc_torch.models.clustering import dbscan
from intent_mpc_torch.models.occupancy import (OccupancyGrid, is_empty,
                                               is_occupied)
from intent_mpc_torch.utils.config import DetectorConfig, RealDetectorConfig
from intent_mpc_torch.utils.device import constant
from intent_mpc_torch.utils.rounding import matmul3, norm2, norm3


class PerceptionStats(NamedTuple):
    """Per-episode track-vs-GT quality accumulators, (S,) each, updated
    once per sense tick against the GT scene the camera images:

      err_sq_sum / err_n : squared track -> nearest-GT-center distance over
          matched live tracks (match gate 2 m) -> position RMSE
      missed_sum         : dynamic GT obstacles inside the camera frustum
          and sensor range with no live track within 1.5 m
      gt_in_fov_sum      : denominator of the miss rate
      spurious_sum       : dynamic-classified live tracks with no dynamic
          GT within 1.5 m
      track_ticks_sum    : denominator of the spurious rate
      births_sum         : track (re)starts
    """

    err_sq_sum: torch.Tensor
    err_n: torch.Tensor
    missed_sum: torch.Tensor
    gt_in_fov_sum: torch.Tensor
    spurious_sum: torch.Tensor
    track_ticks_sum: torch.Tensor
    births_sum: torch.Tensor


def init_perception_stats(batch: int, device="cpu") -> PerceptionStats:
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    zi = torch.zeros((batch,), dtype=torch.int32, device=device)
    return PerceptionStats(err_sq_sum=z, err_n=zi, missed_sum=zi,
                           gt_in_fov_sum=zi, spurious_sum=zi,
                           track_ticks_sum=zi, births_sum=zi)


class RealDetectorState(NamedTuple):
    tracks: pc.Tracks
    pos_hist: torch.Tensor   # (S, T, Hh, 3) filtered positions, newest first
    vel_hist: torch.Tensor   # (S, T, Hh, 3) filtered velocities
    hist_len: torch.Tensor   # (S, T) int32 valid history per track
    stats: PerceptionStats


def intrinsics(rd: RealDetectorConfig) -> pc.CameraIntrinsics:
    return pc.CameraIntrinsics(fx=rd.fx, fy=rd.fy, cx=rd.cx, cy=rd.cy,
                               depth_min=rd.depth_min, depth_max=rd.depth_max,
                               skip=rd.skip)


def init_real_detector(rd: RealDetectorConfig, det: DetectorConfig,
                       batch: int, device="cpu") -> RealDetectorState:
    S, T, Hh = batch, rd.max_tracks, det.history_size
    kw = dict(dtype=torch.float32, device=device)
    return RealDetectorState(
        tracks=pc.init_tracks(S, T, device),
        pos_hist=torch.zeros((S, T, Hh, 3), **kw),
        vel_hist=torch.zeros((S, T, Hh, 3), **kw),
        hist_len=torch.zeros((S, T), dtype=torch.int32, device=device),
        stats=init_perception_stats(S, device))


def extract_detections(rd: RealDetectorConfig, pts: torch.Tensor,
                       labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DBSCAN labels (S, P) -> up to max_detections cluster AABBs per
    scenario (clusterPointsAndBBoxes, dynamicDetector.cpp:1289-1356).

    Per-label counts come from an integer scatter-add and the coordinate
    extrema from scatter amin/amax; the label's own index slot is the
    cluster's representative, and a stable sort of (-count for
    representatives, 1 otherwise) fills the slots with the largest
    clusters, equal counts in index order, as JAX's stable argsort does.
    Returns (pos (S, M, 3), size (S, M, 3), valid (S, M))."""
    S, P = labels.shape
    dev = pts.device
    member = labels >= 0
    lab = torch.where(member, labels, torch.full_like(labels, P)).long()
    counts = torch.zeros((S, P + 1), dtype=torch.int32, device=dev)
    counts = counts.scatter_add(1, lab, torch.ones_like(labels))
    big = 1e9
    lab3 = lab[..., None].expand(S, P, 3)
    m3 = member[..., None]
    lo = torch.full((S, P + 1, 3), big, device=dev).scatter_reduce(
        1, lab3, torch.where(m3, pts, torch.full_like(pts, big)),
        reduce="amin", include_self=True)
    hi = torch.full((S, P + 1, 3), -big, device=dev).scatter_reduce(
        1, lab3, torch.where(m3, pts, torch.full_like(pts, -big)),
        reduce="amax", include_self=True)
    idx = torch.arange(P, dtype=labels.dtype, device=dev)
    cnt = counts[:, :P]
    rep = (labels == idx) & (cnt >= rd.min_cluster_pts)
    key = torch.where(rep, -cnt, torch.ones_like(cnt))
    order = torch.argsort(key, dim=-1, stable=True)[:, :rd.max_detections]
    det_valid = torch.gather(rep, 1, order)
    o3 = order[..., None].expand(S, order.shape[1], 3)
    lo_o, hi_o = torch.gather(lo, 1, o3), torch.gather(hi, 1, o3)
    v3 = det_valid[..., None]
    det_pos = torch.where(v3, (lo_o + hi_o) / 2.0, torch.zeros_like(lo_o))
    det_size = torch.where(v3, torch.clamp(hi_o - lo_o, min=rd.min_box_size),
                           torch.zeros_like(lo_o))
    return det_pos, det_size, det_valid


def _in_frustum(rd: RealDetectorConfig, cam_pos: torch.Tensor,
                cam_rot: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """GT centers (S, O, 3) visible to the camera: inside the image and
    depth within (depth_min, depth_max); occlusion is not modeled."""
    q = matmul3(centers - cam_pos[:, None, :], cam_rot)     # world -> optical
    z = q[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = rd.fx * q[..., 0] / zs + rd.cx
    v = rd.fy * q[..., 1] / zs + rd.cy
    return ((z > rd.depth_min) & (z < rd.depth_max)
            & (u >= 0) & (u < rd.im_w) & (v >= 0) & (v < rd.im_h))


def _dyn_with_veto(rd: RealDetectorConfig, tracks: pc.Tracks,
                   static_occ: Optional[OccupancyGrid]) -> torch.Tensor:
    """Dynamic classification (S, T), optionally vetoed for tracks whose
    center sits inside the prebuilt static map's occupied cells
    (RealDetectorConfig.static_map_veto)."""
    _, _, _, dyn = pc.dynamic_obstacles(tracks,
                                        vote_thresh=rd.dyn_vote_thresh)
    if static_occ is not None and rd.static_map_veto:
        dyn = dyn & ~is_occupied(static_occ, tracks.pos)
    return dyn


def _update_stats(rd: RealDetectorConfig, det: DetectorConfig,
                  stats: PerceptionStats, tracks: pc.Tracks,
                  fresh: torch.Tensor, cam_pos: torch.Tensor,
                  cam_rot: torch.Tensor, drone_pos: torch.Tensor,
                  obs_pos: torch.Tensor, obs_dynamic: torch.Tensor,
                  static_occ: Optional[OccupancyGrid] = None
                  ) -> PerceptionStats:
    live = tracks.live
    dyn = _dyn_with_veto(rd, tracks, static_occ)
    d = norm3(tracks.pos[:, :, None, :] - obs_pos[:, None, :, :])  # (S,T,O)
    big = torch.full_like(d, 1e9)
    nearest_any = torch.amin(d, dim=2)
    matched = live & (nearest_any < 2.0)
    in_rng = norm2(obs_pos[..., 0:2] - drone_pos[:, None, 0:2]) \
        <= det.sensor_range
    gt_vis = obs_dynamic & in_rng & _in_frustum(rd, cam_pos, cam_rot,
                                                obs_pos)
    d_to_live = torch.amin(torch.where(live[:, :, None], d, big), dim=1)
    missed = gt_vis & (d_to_live > 1.5)
    d_dyn_gt = torch.amin(torch.where(obs_dynamic[:, None, :], d, big), dim=2)
    spurious = live & dyn & (d_dyn_gt > 1.5)

    def count(m):
        return torch.sum(m.to(torch.int32), dim=-1, dtype=torch.int32)
    return PerceptionStats(
        err_sq_sum=stats.err_sq_sum + torch.sum(
            torch.where(matched, nearest_any ** 2,
                        torch.zeros_like(nearest_any)), dim=-1),
        err_n=stats.err_n + count(matched),
        missed_sum=stats.missed_sum + count(missed),
        gt_in_fov_sum=stats.gt_in_fov_sum + count(gt_vis),
        spurious_sum=stats.spurious_sum + count(spurious),
        track_ticks_sum=stats.track_ticks_sum + count(live & dyn),
        births_sum=stats.births_sum + count(live & fresh))


def sense_and_track(rd: RealDetectorConfig, det: DetectorConfig,
                    state: RealDetectorState, drone_pos: torch.Tensor,
                    yaw: torch.Tensor, obs_pos: torch.Tensor,
                    obs_size: torch.Tensor, obs_active: torch.Tensor,
                    occ: Optional[OccupancyGrid] = None,
                    obs_dynamic: Optional[torch.Tensor] = None,
                    static_occ: Optional[OccupancyGrid] = None
                    ) -> RealDetectorState:
    """One ~30 Hz perception tick for S scenarios: render a depth frame at
    each drone's pose, detect, associate/track, classify, push the track
    history.

    drone_pos (S, 3), yaw (S,); obs_pos/size (S, O, 3) are the world's
    ground-truth boxes, only the scene the camera images: everything
    downstream sees pixels. occ adds a static voxel grid to the rendered
    scene."""
    intr = intrinsics(rd)
    dev = drone_pos.device
    cam_pos = drone_pos + constant((0.0, 0.0, rd.cam_z_offset), dev)
    R = sensor.yaw_camera_rotation(yaw)
    depth = sensor.render_depth(intr, rd.im_h, rd.im_w, cam_pos, R,
                                obs_pos, obs_size, obs_active,
                                max_depth=rd.depth_max)
    if occ is not None and not is_empty(occ):
        d_grid = sensor.render_depth_grid(intr, rd.im_h, rd.im_w, cam_pos,
                                          R, occ, max_depth=rd.depth_max)
        # nearest return wins; zeros mean no return on that branch
        both = (depth > 0) & (d_grid > 0)
        depth = torch.where(both, torch.minimum(depth, d_grid),
                            torch.maximum(depth, d_grid))
    pts, valid = pc.project_depth(intr, depth, cam_pos, R)
    labels = dbscan(pts, valid, eps=rd.dbscan_eps, min_pts=rd.dbscan_min_pts)
    det_pos, det_size, det_valid = extract_detections(rd, pts, labels)
    tracks = pc.track_step(state.tracks, det_pos, det_size, det_valid,
                           det.history_period,
                           match_max_dist=rd.match_max_dist,
                           dyn_vel_thresh=rd.dyn_vel_thresh,
                           miss_max=rd.miss_max)
    # history rings follow the fake detector's histCB semantics (newest at
    # index 0); a slot that died or was re-opened restarts its history
    fresh = tracks.age <= 1
    f4 = fresh[:, :, None, None]
    ph = torch.cat([tracks.pos[:, :, None], state.pos_hist[:, :, :-1]], dim=2)
    vh = torch.cat([tracks.vel[:, :, None], state.vel_hist[:, :, :-1]], dim=2)
    ph = torch.where(f4, tracks.pos[:, :, None].expand_as(ph), ph)
    vh = torch.where(f4, torch.zeros_like(vh), vh)
    Hh = state.pos_hist.shape[2]
    hist_len = torch.where(
        tracks.live,
        torch.where(fresh, torch.ones_like(state.hist_len),
                    torch.clamp(state.hist_len + 1, max=Hh)),
        torch.zeros_like(state.hist_len))
    if obs_dynamic is None:
        obs_dynamic = obs_active
    stats = _update_stats(rd, det, state.stats, tracks, fresh, cam_pos, R,
                          drone_pos, obs_pos, obs_dynamic & obs_active,
                          static_occ=static_occ)
    return RealDetectorState(tracks=tracks, pos_hist=ph, vel_hist=vh,
                             hist_len=hist_len, stats=stats)


def query_history(rd: RealDetectorConfig, det: DetectorConfig,
                  state: RealDetectorState, robot_pos: torch.Tensor,
                  static_occ: Optional[OccupancyGrid] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    """getDynamicObstaclesHist over the track table: histories,
    robot-inflated sizes and the classification / range gate, as the
    fake detector's query_history tuple (pos, vel, acc, size (S, T, Hh,
    3), hist_len (S, T), visible (S, T))."""
    tr = state.tracks
    robot = constant(tuple(det.robot_size), robot_pos.device)
    base = tr.size + robot
    if rd.kf_size_inflation > 0.0:
        # uncertainty-aware margin: the track's KF position std joins the
        # reported size as the predictor's z-score sample std joins
        # predicted sizes (genTraj, dynamicPredictor.cpp:503-538)
        var = torch.diagonal(tr.P, dim1=-2, dim2=-1)[..., 0:3]
        base = base + 2.0 * rd.kf_size_inflation * torch.sqrt(
            torch.clamp(var, min=0.0))
    size = base[:, :, None, :].expand(state.pos_hist.shape)
    vel = torch.cat([state.vel_hist[..., 0:2],
                     torch.zeros_like(state.vel_hist[..., 2:3])], dim=-1)
    acc = torch.zeros_like(vel)   # the const-vel KF publishes no acceleration
    d2 = norm2(state.pos_hist[:, :, 0, 0:2] - robot_pos[:, None, 0:2])
    dyn = _dyn_with_veto(rd, tr, static_occ)
    visible = dyn & (d2 <= det.sensor_range) & (state.hist_len > 0)
    return state.pos_hist, vel, acc, size, state.hist_len, visible
