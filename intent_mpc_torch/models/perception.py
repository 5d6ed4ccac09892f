"""Depth-camera dynamic-obstacle detection and tracking (port of
intent_mpc_tpu/models/perception.py), batched over a leading scenario
axis S.

Rebuild of onboard_detector's dynamicDetector pipeline (onboard_detector/
dynamicDetector.cpp) and helpers (kalmanFilter.cpp, uvDetector.cpp):

  projectDepthImage (:1240-1279): depth image -> world point cloud
  voxelFilter (:1358-1384): one point per voxel
  kalmanFilter.cpp (:32-48): one linear predict + update step, with the
      constant-velocity and constant-acceleration models
  trackingCB (:719-732) / kalmanFilterAndUpdateHist (:1789-1943):
      linear propagation, greedy nearest association, per-track
      constant-velocity Kalman filters (kalmanFilterMatrixVel
      :1945-1968), coasting, track births into free slots
  classificationCB (:734-914): dynamic-vs-static voting
  uvDetector.cpp: the U-map (depth-bin x column histogram) detector, its
      bird's-eye rectangles (extract_bird_view :518-569) and the
      bird's-eye tracker (UVtracker::check_status :43-155)
  filterBBoxes (:987-1136): mutual-best IOU fusion of U-V and DBSCAN
      boxes, and the external 2D-detection (YOLO) branch

Tracks live in padded (S, T) tables with live masks. The sequential scans
of JAX's track_step and bird_track_step (the greedy picks and the slot
openings) are Python loops over their fixed step counts, vectorised over
S, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intent_mpc_torch.utils.device import constant, f32, resolve_device
from intent_mpc_torch.utils.rounding import (fma, matmul3, norm2, norm3,
                                             recip32)


class KalmanState(NamedTuple):
    x: torch.Tensor   # (..., n)
    P: torch.Tensor   # (..., n, n)


def kalman_estimate(ks: KalmanState, A, B, H, Q, R, z, u) -> KalmanState:
    """One predict+update step (kalman_filter::estimate) over leading
    batch axes of x (..., n), P (..., n, n), z (..., m), u (..., k)."""
    def mv(M, v):
        return torch.matmul(M, v[..., None])[..., 0]
    x = mv(A, ks.x) + mv(B, u)
    P = A @ ks.P @ A.T + Q
    S = R + H @ P @ H.T
    # inv_ex: no host read of LAPACK's info flag (S = R + P is positive
    # definite)
    K = P @ H.T @ torch.linalg.inv_ex(S).inverse
    x = x + mv(K, z - mv(H, x))
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    P = (eye - K @ H) @ P
    return KalmanState(x=x, P=P)


def const_vel_matrices(dt: float, eq: float = 0.33, er: float = 0.1,
                       device="cpu"):
    """Constant-velocity model (kalmanFilterMatrixVel :1945-1968): states
    [x y z vx vy vz], observation [x y z vx vy vz] (position +
    finite-difference velocity)."""
    kw = dict(dtype=torch.float32, device=device)
    A = torch.eye(6, **kw)
    A[0:3, 3:6] = torch.eye(3, **kw) * dt
    B = torch.zeros((6, 1), **kw)
    H = torch.eye(6, **kw)
    Q = torch.eye(6, **kw) * eq
    R = torch.eye(6, **kw) * er
    return A, B, H, Q, R


def const_acc_matrices(dt: float, eq: float = 0.33, er: float = 0.1,
                       device=None):
    """Constant-acceleration model (kalmanFilterMatrixAcc :1970-2000):
    states [p v a] (9), observation [p v] (position + finite-difference
    velocity); acceleration is estimated, not observed. On the card unless
    `device` names another."""
    kw = dict(dtype=torch.float32, device=resolve_device(device))
    I3 = torch.eye(3, **kw)
    A = torch.eye(9, **kw)
    A[0:3, 3:6] = I3 * dt
    A[0:3, 6:9] = I3 * 0.5 * dt * dt
    A[3:6, 6:9] = I3 * dt
    B = torch.zeros((9, 1), **kw)
    H = torch.zeros((6, 9), **kw)
    H[0:6, 0:6] = torch.eye(6, **kw)
    Q = torch.eye(9, **kw) * eq
    R = torch.eye(6, **kw) * er
    return A, B, H, Q, R


class CameraIntrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float = 1000.0
    depth_min: float = 0.5
    depth_max: float = 5.0
    skip: int = 2            # depth_skip_pixel


def project_depth(intr: CameraIntrinsics, depth: torch.Tensor,
                  cam_pos: torch.Tensor, cam_rot: torch.Tensor):
    """depth (S, H, W) raw -> world points (S, (H//skip)*(W//skip), 3) and
    valid (S, ...); cam_pos (S, 3), cam_rot (S, 3, 3)."""
    S, H, W = depth.shape
    s = intr.skip
    dev = depth.device
    d = depth[:, ::s, ::s].to(torch.float32) / intr.depth_scale
    vv, uu = torch.meshgrid(torch.arange(0, H, s, device=dev),
                            torch.arange(0, W, s, device=dev), indexing="ij")
    x = (uu - intr.cx) * d / intr.fx
    y = (vv - intr.cy) * d / intr.fy
    pts_cam = torch.stack([x, y, d], dim=-1).reshape(S, -1, 3)
    valid = ((d >= intr.depth_min) & (d <= intr.depth_max)).reshape(S, -1)
    pts_world = matmul3(pts_cam, cam_rot.transpose(-1, -2)) \
        + cam_pos[:, None, :]
    return pts_world, valid


def voxel_filter(points: torch.Tensor, valid: torch.Tensor, res: float,
                 origin) -> torch.Tensor:
    """Keep one point per voxel (voxelFilter :1358-1384): points (S, P, 3),
    valid (S, P) -> (S, P) bool. Each point's voxel is hashed as the
    reference does, in int32 with wraparound (idx * prime, XOR, abs, where
    abs(INT32_MIN) stays negative, then a floor-mod into 4 P + 1 slots);
    the first point owning a slot (a scatter-min of indices) is kept."""
    S, P, _ = points.shape
    dev = points.device
    org = constant(tuple(float(o) for o in origin), dev)
    idx = torch.floor((points - org) / f32(res, dev)).to(torch.int32)
    key = (idx[..., 0] * 73856093) ^ (idx[..., 1] * 19349663) \
        ^ (idx[..., 2] * 83492791)
    key = torch.remainder(torch.abs(key), 4 * P + 1).to(torch.int64)
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    owner = torch.full((S, 4 * P + 1), P, dtype=torch.int32, device=dev)
    owner = owner.scatter_reduce(
        1, torch.where(valid, key, torch.full_like(key, 4 * P)),
        ar.expand(S, P), "amin")
    return valid & (torch.gather(owner, 1, key) == ar)


KF_AVG_FRAMES = 10   # kfAvgFrames_: velocity-observation FD window


class Tracks(NamedTuple):
    """Padded track table (the detector's boxHist/filters), (S, T, ...)."""
    pos: torch.Tensor        # (S, T, 3) filtered position
    vel: torch.Tensor        # (S, T, 3) filtered velocity
    size: torch.Tensor       # (S, T, 3)
    P: torch.Tensor          # (S, T, 6, 6) KF covariance
    age: torch.Tensor        # (S, T) int32 frames tracked
    dyn_votes: torch.Tensor  # (S, T) dynamic-classification votes
    miss: torch.Tensor       # (S, T) int32 consecutive unmatched frames
    live: torch.Tensor       # (S, T) bool
    pos_hist: torch.Tensor   # (S, T, KF_AVG_FRAMES, 3) filtered-position
                             # ring, newest at index 0


def init_tracks(batch: int, max_tracks: int, device="cpu") -> Tracks:
    S, T = batch, max_tracks
    kw = dict(dtype=torch.float32, device=device)
    return Tracks(pos=torch.zeros((S, T, 3), **kw),
                  vel=torch.zeros((S, T, 3), **kw),
                  size=torch.zeros((S, T, 3), **kw),
                  P=torch.eye(6, **kw).expand(S, T, 6, 6).clone(),
                  age=torch.zeros((S, T), dtype=torch.int32, device=device),
                  dyn_votes=torch.zeros((S, T), **kw),
                  miss=torch.zeros((S, T), dtype=torch.int32, device=device),
                  live=torch.zeros((S, T), dtype=torch.bool, device=device),
                  pos_hist=torch.zeros((S, T, KF_AVG_FRAMES, 3), **kw))


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[s, idx[s, ...]] for (S, N, ...) t and an (S, ...) index."""
    S = t.shape[0]
    ar = torch.arange(S, device=t.device).reshape((S,) + (1,) * (idx.dim() - 1))
    return t[ar, idx]


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with mask (S, T) against (S, T, ...) values."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 2)), a, b)


def track_step(tracks: Tracks, det_pos, det_size, det_valid, dt: float,
               match_max_dist: float = 1.5,
               dyn_vel_thresh: float = 0.3,
               miss_max: int = 10) -> Tracks:
    """One tracking cycle: propagate, associate, KF-update, classify.

    det_pos/size (S, D, 3), det_valid (S, D). Greedy nearest association
    against linearly propagated tracks: min(T, D) times the global best
    pair (row-major first on ties, as argmin over the flat (T, D) matrix)
    within match_max_dist; unmatched detections open tracks in the first
    free slots; unmatched tracks coast on the predict-only KF and die
    after miss_max consecutive misses."""
    S, T = tracks.pos.shape[:2]
    D = det_pos.shape[1]
    dev = tracks.pos.device
    inf = float("inf")
    prop = tracks.pos + tracks.vel * dt                          # (S,T,3)

    d = norm3(prop[:, :, None, :] - det_pos[:, None, :, :])     # (S,T,D)
    d = torch.where(tracks.live[:, :, None] & det_valid[:, None, :], d,
                    torch.full_like(d, inf))

    t_ar = torch.arange(T, device=dev)
    d_ar = torch.arange(D, device=dev)
    t2d = torch.full((S, T), -1, dtype=torch.int64, device=dev)
    dmat = d
    for _ in range(min(T, D)):
        flat = torch.argmin(dmat.reshape(S, T * D), dim=-1)
        ti, di = flat // D, flat % D
        best = torch.gather(dmat.reshape(S, T * D), 1, flat[:, None])[:, 0]
        ok = best <= match_max_dist
        row = t_ar[None, :] == ti[:, None]                       # (S,T)
        col = d_ar[None, :] == di[:, None]                       # (S,D)
        t2d = torch.where(row & ok[:, None], di[:, None], t2d)
        dmat = torch.where(row[:, :, None], torch.full_like(dmat, inf), dmat)
        dmat = torch.where((col & ok[:, None])[:, None, :],
                           torch.full_like(dmat, inf), dmat)
    matched = t2d >= 0
    det_idx = torch.clamp(t2d, 0, D - 1)

    # KF update of matched tracks (const-vel model); the velocity
    # observation differences the detection against the filtered position
    # k frames back over k*dt (getKalmanObservationVel, :1999-2015)
    A, B, H, Q, R = const_vel_matrices(dt, device=dev)
    z_pos = _rows(det_pos, det_idx)                              # (S,T,3)
    k = torch.clamp(tracks.age, 1, KF_AVG_FRAMES).to(torch.int64)
    prev = torch.gather(tracks.pos_hist, 2,
                        (k - 1)[:, :, None, None].expand(S, T, 1, 3))[:, :, 0]
    z_vel = (z_pos - prev) / (dt * k[..., None].to(torch.float32))
    z = torch.cat([z_pos, z_vel], dim=-1)                        # (S,T,6)
    xk = torch.cat([tracks.pos, tracks.vel], dim=-1)
    upd = kalman_estimate(KalmanState(xk, tracks.P), A, B, H, Q, R, z,
                          torch.zeros((S, T, 1), dtype=z.dtype, device=dev))
    # unmatched live tracks coast: predict-only state and covariance
    P_pred = A @ tracks.P @ A.T + Q
    new_pos = _sel(matched, upd.x[..., 0:3], prop)
    new_vel = _sel(matched, upd.x[..., 3:6], tracks.vel)
    new_P = _sel(matched, upd.P, P_pred)
    new_size = _sel(matched, _rows(det_size, det_idx), tracks.size)

    # dynamic classification votes: displacement against propagation
    speed = torch.linalg.vector_norm(new_vel[..., 0:2], dim=-1)
    vote = torch.where(speed > dyn_vel_thresh, torch.full_like(speed, 1.0),
                       torch.full_like(speed, -0.5))
    votes = torch.clamp(tracks.dyn_votes
                        + torch.where(matched, vote, torch.zeros_like(vote)),
                        0.0, 10.0)

    miss = torch.where(matched, torch.zeros_like(tracks.miss), tracks.miss + 1)
    live = tracks.live & (matched | (miss <= miss_max))
    age = torch.where(live, tracks.age + 1, torch.zeros_like(tracks.age))

    # open new tracks for unmatched detections, each in the first dead slot
    det_used = torch.any((t2d[:, :, None] == d_ar[None, None, :])
                         & matched[:, :, None], dim=1)            # (S,D)
    det_new = det_valid & ~det_used
    pos, vel, size, P, votes_o = new_pos, new_vel, new_size, new_P, votes
    eye6 = torch.eye(6, dtype=P.dtype, device=dev)
    for di in range(D):
        free = torch.argmin(live.to(torch.int32), dim=-1)        # (S,)
        slot = t_ar[None, :] == free[:, None]                    # (S,T)
        can = det_new[:, di] & ~torch.any(slot & live, dim=-1)
        put = slot & can[:, None]
        pos = _sel(put, det_pos[:, di, None, :].expand_as(pos), pos)
        vel = _sel(put, torch.zeros_like(vel), vel)
        size = _sel(put, det_size[:, di, None, :].expand_as(size), size)
        P = _sel(put, eye6.expand_as(P), P)
        age = torch.where(put, torch.ones_like(age), age)
        votes_o = torch.where(put, torch.zeros_like(votes_o), votes_o)
        miss = torch.where(put, torch.zeros_like(miss), miss)
        live = live | put
    # push the new filtered position into the per-track history ring;
    # fresh tracks (age 1) seed the whole ring with their first position
    hist = torch.cat([pos[:, :, None, :], tracks.pos_hist[:, :, :-1]], dim=2)
    hist = torch.where((age <= 1)[:, :, None, None], pos[:, :, None, :]
                       .expand_as(hist), hist)
    return Tracks(pos=pos, vel=vel, size=size, P=P, age=age,
                  dyn_votes=votes_o, miss=miss, live=live, pos_hist=hist)


def dynamic_obstacles(tracks: Tracks, vote_thresh: float = 2.0):
    """Tracks classified dynamic (classificationCB voting outcome)."""
    dyn = tracks.live & (tracks.dyn_votes >= vote_thresh)
    return tracks.pos, tracks.vel, tracks.size, dyn


# ---------------------------------------------------------------------------
# U-map detector (uvDetector.cpp: U-map histogram + band extraction)
# ---------------------------------------------------------------------------

def u_map_detect(intr: CameraIntrinsics, depth: torch.Tensor,
                 num_bins: int = 32, min_hits: int = 10,
                 max_boxes: int = 8):
    """Column-depth histogram detector on depth (S, H, W) raw frames: bins
    with enough support become obstacle bands; each depth bin's runs of
    contiguous strong columns (the first 4) become 2D boxes with the bin's
    depth. The max_boxes best-supported boxes are kept, equal support in
    (bin, run) order (a stable sort, as JAX's argsort). Returns (boxes
    (S, max_boxes, 4): [u_min, u_max, depth, height], valid (S,
    max_boxes))."""
    S, H, W = depth.shape
    dev = depth.device
    d = depth.to(torch.float32) * f32(recip32(intr.depth_scale), dev)
    ok = (d >= intr.depth_min) & (d <= intr.depth_max)
    span = recip32(intr.depth_max - intr.depth_min)
    bin_idx = torch.clamp(((d - f32(intr.depth_min, dev))
                           * f32(span, dev) * num_bins).to(torch.int32),
                          0, num_bins - 1)                        # (S,H,W)
    # U-map: (num_bins, W) histogram of depth hits per column, with JAX's
    # dump slot (the last cell) for pixels out of range
    cols = torch.arange(W, device=dev)
    flat = bin_idx.to(torch.int64) * W + cols
    flat = torch.where(ok, flat, torch.full_like(flat, num_bins * W - 1))
    umap = torch.zeros((S, num_bins * W), dtype=torch.float32, device=dev)
    umap = umap.scatter_add(1, flat.reshape(S, -1),
                            ok.reshape(S, -1).to(torch.float32))
    umap = umap.reshape(S, num_bins, W)

    strong = umap >= min_hits                                     # (S,B,W)
    prev = torch.cat([torch.zeros_like(strong[..., :1]), strong[..., :-1]],
                     dim=-1)
    starts = strong & ~prev
    run_id = torch.cumsum(starts.to(torch.int32), dim=-1) * strong - 1
    runs_per_bin = 4
    r_ar = torch.arange(runs_per_bin, device=dev)
    m = run_id[:, :, None, :] == r_ar[:, None]                    # (S,B,R,W)
    any_m = torch.any(m, dim=-1)
    u0 = torch.amin(torch.where(m, cols, torch.full_like(cols, W)), dim=-1)
    u1 = torch.amax(torch.where(m, cols, torch.full_like(cols, -1)), dim=-1)
    b_ar = torch.arange(num_bins, device=dev)
    dep = fma((b_ar.to(torch.float32) + 0.5) * f32(1.0 / num_bins, dev),
              f32(intr.depth_max - intr.depth_min, dev),
              f32(intr.depth_min, dev))                          # (B,)
    # rows of the pixels of bin b inside run r
    in_bin = ok[:, None] & (bin_idx[:, None] == b_ar[:, None, None])  # S,B,H,W
    rows = torch.arange(H, device=dev)
    inb = in_bin[:, :, None] & m[:, :, :, None, :]                # S,B,R,H,W
    row_any = torch.any(inb, dim=-1)                              # S,B,R,H
    v0 = torch.amin(torch.where(row_any, rows, torch.full_like(rows, H)),
                    dim=-1)
    v1 = torch.amax(torch.where(row_any, rows, torch.full_like(rows, -1)),
                    dim=-1)
    support = torch.sum(torch.where(m, umap[:, :, None, :],
                                    torch.zeros_like(umap[:, :, None, :])),
                        dim=-1)
    boxes = torch.stack([u0.to(torch.float32), u1.to(torch.float32),
                         dep[None, :, None].expand_as(support),
                         (v1 - v0).to(torch.float32)], dim=-1)
    boxes = boxes.reshape(S, num_bins * runs_per_bin, 4)
    valid = any_m.reshape(S, -1)
    support = torch.where(valid, support.reshape(S, -1),
                          torch.full_like(support.reshape(S, -1), -1.0))
    top = torch.argsort(-support, dim=-1, stable=True)[:, :max_boxes]
    return (torch.gather(boxes, 1, top[..., None].expand(S, top.shape[1], 4)),
            torch.gather(valid, 1, top))


# ---------------------------------------------------------------------------
# Boxes, IOU
# ---------------------------------------------------------------------------

def box_iou(c1, s1, c2, s2) -> torch.Tensor:
    """Axis-aligned 3D IOU (calBoxIOU :1410-1443). c/s: (..., 3)."""
    lo = torch.maximum(c1 - s1 / 2, c2 - s2 / 2)
    hi = torch.minimum(c1 + s1 / 2, c2 + s2 / 2)
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    v1 = torch.prod(s1, dim=-1)
    v2 = torch.prod(s2, dim=-1)
    return inter / torch.clamp(v1 + v2 - inter, min=1e-9)


# ---------------------------------------------------------------------------
# Bird-view (V-map) stage of the U-V detector (uvDetector.cpp:518-569
# extract_bird_view + UVtracker:43-155 check_status): U-map boxes become
# metric bird's-eye rectangles, tracked frame to frame by
# overlap-or-distance association.
# ---------------------------------------------------------------------------

def bird_view_boxes(intr: CameraIntrinsics, uboxes: torch.Tensor,
                    valid: torch.Tensor, num_bins: int = 32) -> torch.Tensor:
    """U-map boxes -> bird's-eye metric rectangles (extract_bird_view).

    uboxes (S, B, 4): [u_min, u_max, depth, pixel height] from
    u_map_detect. Returns (S, B, 4): [x_left, y_near, width,
    depth_extent] in meters in the camera's ground frame (x lateral from
    the optical axis, y = depth); the body is the box's depth-bin extent
    behind the observed front face (uvDetector.cpp:524-533)."""
    dev = uboxes.device
    bin_w = (intr.depth_max - intr.depth_min) / num_bins
    inv_fx = f32(recip32(intr.fx), dev)
    depth = uboxes[..., 2]
    width = depth * (uboxes[..., 1] - uboxes[..., 0]) * inv_fx
    x_left = depth * (uboxes[..., 0] - intr.cx) * inv_fx
    y_near = depth - f32(0.5 * bin_w, dev)
    out = torch.stack([x_left, y_near, width,
                       torch.full_like(depth, bin_w)], dim=-1)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


class BirdTracks(NamedTuple):
    """Fixed-shape bird's-eye track tables (UVtracker state), (S, T, ...)."""
    box: torch.Tensor     # (S, T, 4) [x, y, w, h]
    vel: torch.Tensor     # (S, T, 2) center velocity (m/s)
    age: torch.Tensor     # (S, T) int32 frames tracked
    live: torch.Tensor    # (S, T) bool


def init_bird_tracks(batch: int, max_tracks: int, device=None) -> BirdTracks:
    """Empty tables on the card unless `device` names another."""
    S, T = batch, max_tracks
    device = resolve_device(device)
    kw = dict(dtype=torch.float32, device=device)
    return BirdTracks(box=torch.zeros((S, T, 4), **kw),
                      vel=torch.zeros((S, T, 2), **kw),
                      age=torch.zeros((S, T), dtype=torch.int32,
                                      device=device),
                      live=torch.zeros((S, T), dtype=torch.bool,
                                       device=device))


def _rect_overlap(b1, b2):
    """Intersection area of [x, y, w, h] rects."""
    lo = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    hi = torch.minimum(b1[..., 0:2] + b1[..., 2:4], b2[..., 0:2] + b2[..., 2:4])
    wh = torch.clamp(hi - lo, min=0.0)
    return wh[..., 0] * wh[..., 1]


def bird_track_step(tracks: BirdTracks, boxes: torch.Tensor,
                    valid: torch.Tensor, dt: float,
                    overlap_threshold: float = 0.5) -> BirdTracks:
    """One UVtracker::check_status cycle for S scenarios: boxes (S, B, 4),
    valid (S, B).

    A detection inherits a track when the overlap ratio (relative to
    either rectangle, the reference's max(o/a_now, o/a_pre)) reaches the
    threshold or the center distance is within the mean combined-diagonal
    metric (uvDetector.cpp:94-100); pairs are taken greedily by
    descending score (row-major first on ties). Matched tracks update a
    finite-difference center velocity; unmatched detections open fresh
    tracks in the first free slots; unmatched tracks die."""
    S, T = tracks.box.shape[:2]
    B = boxes.shape[1]
    dev = boxes.device
    ninf = float("-inf")
    tb = tracks.box
    ov = _rect_overlap(tb[:, :, None, :], boxes[:, None, :, :])    # (S,T,B)
    a_pre = tb[..., 2] * tb[..., 3]
    a_now = boxes[..., 2] * boxes[..., 3]
    ratio = torch.maximum(ov / torch.clamp(a_now[:, None, :], min=1e-9),
                          ov / torch.clamp(a_pre[:, :, None], min=1e-9))
    c_pre = tb[..., 0:2] + tb[..., 2:4] / 2
    c_now = boxes[..., 0:2] + boxes[..., 2:4] / 2
    dist = norm2(c_pre[:, :, None] - c_now[:, None, :])
    metric = norm2(tb[:, :, None, 2:4] + boxes[:, None, :, 2:4]) / 2
    ok = ((ratio >= overlap_threshold) | (dist <= metric)) \
        & tracks.live[:, :, None] & valid[:, None, :]

    # greedy one-to-one by descending score
    score = torch.where(ok, ratio + 1.0 / (1.0 + dist),
                        torch.full_like(ratio, ninf))
    t_ar = torch.arange(T, device=dev)
    b_ar = torch.arange(B, device=dev)
    t2d = torch.full((S, T), -1, dtype=torch.int64, device=dev)
    s = score
    for _ in range(min(T, B)):
        flat = torch.argmax(s.reshape(S, T * B), dim=-1)
        ti, di = flat // B, flat % B
        best = torch.gather(s.reshape(S, T * B), 1, flat[:, None])[:, 0]
        hit = best > ninf
        row = t_ar[None, :] == ti[:, None]                         # (S,T)
        col = b_ar[None, :] == di[:, None]                         # (S,B)
        t2d = torch.where(row & hit[:, None], di[:, None], t2d)
        s = torch.where(row[:, :, None], torch.full_like(s, ninf), s)
        s = torch.where((col & hit[:, None])[:, None, :],
                        torch.full_like(s, ninf), s)
    matched = t2d >= 0
    di = torch.clamp(t2d, 0, B - 1)
    new_c = _rows(c_now, di)
    vel = _sel(matched, (new_c - c_pre) * f32(recip32(dt), dev),
               tracks.vel)
    box = _sel(matched, _rows(boxes, di), tb)
    age = torch.where(matched, tracks.age + 1, torch.zeros_like(tracks.age))
    live = tracks.live & matched

    det_used = torch.any((t2d[:, :, None] == b_ar[None, None, :])
                         & matched[:, :, None], dim=1)             # (S,B)
    det_new = valid & ~det_used
    for bi in range(B):
        free = torch.argmin(live.to(torch.int32), dim=-1)          # (S,)
        slot = t_ar[None, :] == free[:, None]
        can = det_new[:, bi] & ~torch.any(slot & live, dim=-1)
        put = slot & can[:, None]
        box = _sel(put, boxes[:, bi, None, :].expand_as(box), box)
        vel = _sel(put, torch.zeros_like(vel), vel)
        age = torch.where(put, torch.ones_like(age), age)
        live = live | put
    return BirdTracks(box=box, vel=vel, age=age, live=live)


# ---------------------------------------------------------------------------
# Detection fusion (dynamicDetector::filterBBoxes :987-1136)
# ---------------------------------------------------------------------------

def fuse_mutual_best(uv_pos, uv_size, uv_valid, db_pos, db_size, db_valid,
                     iou_thresh: float = 0.5):
    """Mutual-best-IOU fusion of U-V and DBSCAN boxes (:993-1031), per
    scenario: uv_* (S, U, ...), db_* (S, D, ...).

    A pair survives only if each box is the other's best IOU match (the
    first on ties) and the IOU clears the threshold; the fused box is the
    conservative union AABB. Returns (pos (S, U, 3), size (S, U, 3), valid
    (S, U)) indexed by the uv slot."""
    iou = box_iou(uv_pos[:, :, None], uv_size[:, :, None],
                  db_pos[:, None, :], db_size[:, None, :])         # (S,U,D)
    iou = torch.where(uv_valid[:, :, None] & db_valid[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    best_iou, best_db = torch.max(iou, dim=2)                      # (S,U)
    best_uv = torch.argmax(iou, dim=1)                             # (S,D)
    U = uv_pos.shape[1]
    mutual = torch.gather(best_uv, 1, best_db) \
        == torch.arange(U, device=iou.device)
    ok = mutual & (best_iou > iou_thresh)
    mp = _rows(db_pos, best_db)
    ms = _rows(db_size, best_db)
    hi = torch.maximum(uv_pos + uv_size / 2, mp + ms / 2)
    lo = torch.minimum(uv_pos - uv_size / 2, mp - ms / 2)
    return (hi + lo) / 2, hi - lo, ok


def project_box_to_image(intr: CameraIntrinsics, center_w, size_w,
                         cam_pos, cam_rot):
    """3D world boxes (S, B, 3) -> image-plane rects [tlx, tly, w, h]
    (S, B, 4) at the center's depth (filterBBoxes :1040-1076: corners
    projected at the center's z); cam_pos (S, 3), cam_rot (S, 3, 3)
    optical -> world."""
    c = matmul3(center_w - cam_pos[:, None, :], cam_rot)          # world->cam
    z = torch.clamp(c[..., 2], min=1e-3)
    s = size_w
    tlx = (intr.fx * (c[..., 0] - s[..., 0] / 2) + intr.cx * z) / z
    tly = (intr.fy * (c[..., 1] - s[..., 1] / 2) + intr.cy * z) / z
    brx = (intr.fx * (c[..., 0] + s[..., 0] / 2) + intr.cx * z) / z
    bry = (intr.fy * (c[..., 1] + s[..., 1] / 2) + intr.cy * z) / z
    return torch.stack([tlx, tly, brx - tlx, bry - tly], dim=-1)


def fuse_external_2d(intr: CameraIntrinsics, centers_w, sizes_w, valid,
                     cam_pos, cam_rot, det2d, det2d_valid,
                     iou_thresh: float = 0.5):
    """External 2D-detection fusion (the reference's YOLO branch,
    filterBBoxes :1035-1133), per scenario: each image-plane detection
    [tlx, tly, w, h] (S, D, 4) marks its best-IOU projected 3D box (S, B)
    as dynamic / human. Detector-agnostic: any (rect, valid) stream works.
    Returns (is_dynamic (S, B), is_human (S, B))."""
    rects = project_box_to_image(intr, centers_w, sizes_w, cam_pos, cam_rot)
    ov = _rect_overlap(det2d[:, :, None, :], rects[:, None, :, :])  # (S,D,B)
    a_d = det2d[..., 2] * det2d[..., 3]
    a_r = rects[..., 2] * rects[..., 3]
    union = a_d[:, :, None] + a_r[:, None, :] - ov
    iou = torch.where(union > 0, ov / torch.clamp(union, min=1e-9),
                      torch.zeros_like(ov))
    iou = torch.where(det2d_valid[:, :, None] & valid[:, None, :], iou,
                      torch.zeros_like(iou))
    best_iou, best = torch.max(iou, dim=2)                         # (S,D)
    hit = best_iou > iou_thresh
    # scatter-max of hit flags onto each detection's best box
    flags = torch.zeros(valid.shape, dtype=torch.int32, device=valid.device)
    flags = flags.scatter_reduce(1, best, hit.to(torch.int32), "amax")
    flags = flags > 0
    return flags, flags
