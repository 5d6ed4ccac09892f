"""Depth-camera dynamic-obstacle tracking (port of the parts of
intent_mpc_tpu/models/perception.py that the real detector runs),
batched over a leading scenario axis S.

Rebuild of onboard_detector's dynamicDetector helpers:

  projectDepthImage (:1240-1279): depth image -> world point cloud
  kalmanFilter.cpp (:32-48): one linear predict + update step
  trackingCB (:719-732) / kalmanFilterAndUpdateHist (:1789-1943):
      linear propagation, greedy nearest association, per-track
      constant-velocity Kalman filters (kalmanFilterMatrixVel
      :1945-1968), coasting, track births into free slots
  classificationCB (:734-914): dynamic-vs-static voting

Tracks live in padded (S, T) tables with live masks. The two sequential
scans of JAX's track_step (the greedy pick and the slot opening) are
Python loops over their min(T, D) and D steps, vectorised over S, with
no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intent_mpc_torch.utils.rounding import matmul3, norm3


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
