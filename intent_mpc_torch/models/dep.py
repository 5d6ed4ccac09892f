"""Incremental dynamic exploration planner (DEP): the roadmap-reuse port of
intent_mpc_tpu/models/dep.py, batched over a leading scenario axis S.

Rebuild of global_planner's DEP (dep.cpp). The reference's makePlan cycle
(dep.cpp:309-353): detectFrontierRegion -> buildRoadMap (grow a persistent
PRM by frontier-weighted sampling, :516-560) -> pruneNodes (drop nodes
invalidated by new occupancy, :656-687) -> updateInformationGain (per-node
unknown-voxel counts binned per yaw, :688-719 + calculateUnknown
:1022-1070) -> getBestViewCandidates (gain priority queue with the
minVoxelThresh cutoff, :721-787) -> findCandidatePath (A* on the roadmap,
:789-812) -> findBestPath (score = unknown / (dist/vel + yawPenalty *
yawDist/angularVel), :813-862).

The roadmap is a fixed-capacity node pool (S, N, ...) carried across
exploration steps (`RoadmapState`); sampling, pruning, gain evaluation,
shortest paths and scoring are masked fixed-shape ops, with the JAX
package's documented deviations from dep.cpp: node growth samples frontier
and free voxels directly (`prng.categorical`, the JAX package's bits);
shortest paths are masked Bellman-Ford relaxations over the radius /
line-of-sight adjacency; gains are recomputed for all live nodes every
step; line-of-sight visibility for the gain samples `los_samples` points
along each node -> voxel segment (0: the coarse occlusion-free bound).

The gains count only a window of the map around each node: the voxel
indices within ceil(range / resolution) + 2 of the node's own (fewer in z,
where the sensor box ends at range * tan(vFOV / 2)). The counts and
per-yaw histograms equal the JAX package's count over every voxel of the
map (sums of ones, exact in any order below 2^24).

Rounding follows the JAX package's compiled CPU program where a decision
depends on it: a constant divisor is a multiplication by its float32
reciprocal (utils/rounding.recip32); voxel centers, segment samples and
sample positions are one FMA; distances are the FMA chain of
utils/rounding.py. The yaw bin of a voxel takes atan2 in float64 rounded
to float32, the same on the card and the CPU; XLA's float32 atan2 on the
CPU (glibc's atan2f) is within an ulp of it, and a voxel whose angle sits
within that ulp of a bin edge can fall in the neighbouring bin.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from intent_mpc_torch.models.exploration import (ExplorationConfig,
                                                 classify, frontiers)
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.device import constant, f32, resolve_device
from intent_mpc_torch.utils.grid import (WIN_X, WIN_Y, WIN_Z, as_origin,
                                         grid_lookup, scenario_chunks,
                                         window_axes, window_radius)
from intent_mpc_torch.utils.rounding import fma, recip32, sq_sum3, sqrt32

_PI = float(np.float32(np.pi))


class DEPConfig(NamedTuple):
    capacity: int = 128          # roadmap node pool size
    samples_per_step: int = 16   # frontier samples tried per cycle
    dist_thresh: float = 0.8     # min node spacing (distThresh_)
    sensor_range: float = 5.0    # dmax_
    horizontal_fov: float = 1.57  # horizontalFOV_ (rad)
    vertical_fov: float = 1.0    # verticalFOV_ (rad)
    yaw_bins: int = 32           # yaws_ discretization (calculateUnknown)
    min_voxel_thresh: float = 0.1  # gain cutoff vs best (minVoxelThresh_)
    max_candidates: int = 8      # maxCandidateNum_
    connect_radius: float = 2.5  # roadmap edge radius
    edge_los_samples: int = 5    # collision samples per edge
    los_samples: int = 0         # gain visibility samples (0 = coarse)
    vel: float = 2.0             # vel_ (path-time scoring)
    angular_vel: float = 1.0     # angularVel_
    yaw_penalty: float = 1.0     # yawPenaltyWeight_
    max_path_len: int = 16       # Bellman-Ford relaxations / path walk
    explore: ExplorationConfig = ExplorationConfig()


class RoadmapState(NamedTuple):
    pos: torch.Tensor        # (S, N, 3)
    valid: torch.Tensor      # (S, N) bool
    gain: torch.Tensor       # (S, N) total unknown voxels in sensor range
    yaw_gain: torch.Tensor   # (S, N, B) unknown voxels per yaw bin


class DEPPlan(NamedTuple):
    path: torch.Tensor       # (S, L, 3) start -> best view (padded by repeat)
    path_len: torch.Tensor   # (S,) int32 live waypoints
    viewpoint: torch.Tensor  # (S, 3)
    best_yaw: torch.Tensor   # (S,) heading maximizing gain at the viewpoint
    gain: torch.Tensor       # (S,) unknown voxels along the chosen path
    score: torch.Tensor      # (S,) findBestPath score of the winner
    success: torch.Tensor    # (S,) bool


def dep_init(cfg: DEPConfig, start, device=None) -> RoadmapState:
    """S empty roadmaps holding one node each, at start (S, 3), on the card
    unless `device` names another."""
    dev = resolve_device(device)
    start = torch.as_tensor(start, dtype=torch.float32, device=dev)
    S, N, B = start.shape[0], cfg.capacity, cfg.yaw_bins
    pos = torch.zeros((S, N, 3), dtype=torch.float32, device=dev)
    pos[:, 0] = start
    valid = torch.zeros((S, N), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    return RoadmapState(pos=pos, valid=valid,
                        gain=torch.zeros((S, N), device=dev),
                        yaw_gain=torch.zeros((S, N, B), device=dev))


def _norm(d: torch.Tensor) -> torch.Tensor:
    """|d| of d (..., 3) as XLA's compiled CPU program rounds it."""
    return sqrt32(sq_sum3(d[..., 0], d[..., 1], d[..., 2]))


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2 taken in float64 and rounded once: the same value on
    the card and the CPU."""
    return torch.atan2(y.double(), x.double()).float()


def _yaw_bin(ang: torch.Tensor, bins: int) -> torch.Tensor:
    """floor((ang + pi) / (2 pi) * B) mod B, the division by the constant
    2 pi as XLA compiles it (a multiplication by its reciprocal)."""
    t = (ang + _PI) * recip32(2 * math.pi) * float(bins)
    return torch.remainder(torch.floor(t).to(torch.int64), bins)


def _fov_sum(cfg: DEPConfig, hist: torch.Tensor) -> torch.Tensor:
    """The circular window sum of the per-yaw histograms hist (..., B) over
    the horizontal FOV, as the JAX package sums it: offsets -(B // 2) ..
    B // 2 with |offset| <= half the FOV in bins (so for an even B the
    opposite bin counts twice once the window reaches it)."""
    B = cfg.yaw_bins
    half = max(math.floor(np.float32(cfg.horizontal_fov / 2.0
                                     / (2 * math.pi / B))), 0)
    offs = [o for o in range(-(B // 2), B // 2 + 1) if abs(o) <= half]
    idx = (torch.arange(B, device=hist.device)[:, None]
           + constant(tuple(offs), hist.device, torch.int64)) % B
    return torch.sum(hist[..., idx], dim=-1)


def node_gains(cfg: DEPConfig, log_odds: torch.Tensor, origin, res: float,
               nodes: torch.Tensor, valid: torch.Tensor):
    """calculateUnknown (dep.cpp:1022-1070) for nodes (S, N, 3) on maps
    log_odds (S, nx, ny, nz): unknown voxels inside the sensor box (within
    range of the node, |dz| within range * tan(vFOV / 2)), not occupied,
    optionally line-of-sight visible; binned into a per-yaw histogram then
    window-summed over the horizontal FOV. Returns (gain (S, N), yaw_gain
    (S, N, B)), 0 where not valid."""
    dev = log_odds.device
    unknown, _, occupied = classify(log_odds, cfg.explore)
    target = unknown & ~occupied
    origin = as_origin(origin, dev)
    dims = log_odds.shape[1:]
    B = cfg.yaw_bins
    R = float(np.float32(cfg.sensor_range))
    z_range = float(np.float32(cfg.sensor_range)
                     * np.tan(np.float32(cfg.vertical_fov / 2.0)))
    rxy = window_radius(cfg.sensor_range, res)
    rz = window_radius(min(cfg.sensor_range, z_range), res)
    S, N = nodes.shape[:2]
    W = (2 * rxy + 1) ** 2 * (2 * rz + 1) * max(cfg.los_samples, 1)
    hists = []
    for s0, s1 in scenario_chunks(S, N * W):
        p = nodes[s0:s1]
        (ix, inx, dx), (iy, iny, dy), (iz, inz, dz) = window_axes(
            p, origin, res, dims, (rxy, rxy, rz))
        dist = sqrt32(sq_sum3(dx[WIN_X], dy[WIN_Y], dz[WIN_Z]))
        sc = torch.arange(s0, s1, device=dev)[:, None, None, None, None]
        vis = target[sc, ix[WIN_X], iy[WIN_Y], iz[WIN_Z]] \
            & inx[WIN_X] & iny[WIN_Y] & inz[WIN_Z] & (dist <= R) \
            & (torch.abs(dz) <= z_range)[WIN_Z]
        if cfg.los_samples > 0:
            vis = vis & ~_los_blocked(cfg, occupied[s0:s1], origin, res, p,
                                      dx[WIN_X], dy[WIN_Y], dz[WIN_Z])
        counts = vis.sum(dim=-1).to(torch.float32)        # (s, N, Wx, Wy)
        binidx = _yaw_bin(_atan2(dy[..., None, :], dx[..., :, None]), B)
        h = torch.zeros((s1 - s0, N, B), device=dev)
        h.scatter_add_(2, binidx.reshape(s1 - s0, N, -1),
                       counts.reshape(s1 - s0, N, -1))
        hists.append(h)
    hist = torch.cat(hists)
    ygain = _fov_sum(cfg, hist)
    total = hist.sum(dim=-1)
    zero = f32(0.0, dev)
    return (torch.where(valid, total, zero),
            torch.where(valid[..., None], ygain, zero))


def _los_blocked(cfg: DEPConfig, occupied: torch.Tensor, origin, res: float,
                 p: torch.Tensor, dx, dy, dz) -> torch.Tensor:
    """Any occupied voxel at the los_samples points p + t d, t = k / (n + 1),
    of the segments from the nodes p (s, N, 3) to the window's voxel
    centers (offsets d broadcast to (s, N, Wx, Wy, Wz))."""
    n = cfg.los_samples
    ts = (np.arange(n, dtype=np.float32) + np.float32(1.0)) \
        * np.float32(recip32(n + 1))
    d = torch.stack(torch.broadcast_tensors(dx, dy, dz), dim=-1)
    base = p[:, :, None, None, None, :]
    blocked = torch.zeros(d.shape[:-1], dtype=torch.bool, device=p.device)
    for t in ts:
        pts = fma(f32(float(t), p.device), d, base)
        blocked |= grid_lookup(occupied, origin, res, pts)
    return blocked


def grow_roadmap(cfg: DEPConfig, log_odds: torch.Tensor, free: torch.Tensor,
                 origin: torch.Tensor, res: float, state: RoadmapState,
                 key: torch.Tensor):
    """buildRoadMap (dep.cpp:516-560): frontier-weighted and free-space
    samples (half the step budget each), kept where they lie on a free
    voxel spaced from the live nodes and from earlier samples of the step
    (the reference inserts sequentially), inserted into the first free
    slots. Returns (pos (S, N, 3), valid (S, N))."""
    dev = log_odds.device
    S = log_odds.shape[0]
    inf = f32(float("inf"), dev)
    zero = f32(0.0, dev)
    fr = frontiers(log_odds, cfg.explore).reshape(S, -1)
    k = prng.split(key, 3)
    n = cfg.samples_per_step
    idx_fr = prng.categorical(k[:, 0], torch.where(fr, zero, -inf),
                              n - n // 2)
    idx_free = prng.categorical(
        k[:, 2], torch.where(free.reshape(S, -1), zero, -inf), n // 2)
    sample_idx = torch.cat([idx_fr, idx_free], dim=-1)          # (S, n)
    _, ny, nz = log_odds.shape[1:]
    vox = torch.stack([sample_idx // (ny * nz), (sample_idx // nz) % ny,
                       sample_idx % nz], dim=-1)
    jitter = prng.uniform(k[:, 1], (n, 3))
    samples = fma(vox.to(torch.float32) + jitter, f32(res, dev), origin)

    d_nodes = _norm(samples[:, :, None] - state.pos[:, None])
    d_nodes = torch.where(state.valid[:, None], d_nodes, inf)
    spaced = torch.amin(d_nodes, dim=-1) >= cfg.dist_thresh
    d_ss = _norm(samples[:, :, None] - samples[:, None])
    earlier = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev),
                         diagonal=-1)
    close_prior = torch.any(earlier & (d_ss < cfg.dist_thresh), dim=-1)
    on_free = grid_lookup(free, origin, res, samples)
    new_ok = spaced & ~close_prior & on_free & torch.any(fr, dim=-1)[:, None]

    # the first free slots: a stable sort puts the invalid ones first
    slots = torch.sort(state.valid.to(torch.uint8), dim=-1,
                       stable=True).indices[:, :n]
    slot_valid = torch.gather(state.valid, 1, slots)
    can_insert = new_ok & ~slot_valid
    at = slots[..., None].expand(S, n, 3)
    pos = state.pos.scatter(1, at, torch.where(
        can_insert[..., None], samples, torch.gather(state.pos, 1, at)))
    valid = state.valid.scatter(1, slots, slot_valid | can_insert)
    return pos, valid


def prune(occupied: torch.Tensor, origin: torch.Tensor, res: float,
          pos: torch.Tensor, valid: torch.Tensor, curr_pos: torch.Tensor):
    """pruneNodes (dep.cpp:656-687): drop nodes the map now occupies.
    Returns (valid, the live node nearest the explorer (S,), which anchors
    the shortest paths)."""
    valid = valid & ~grid_lookup(occupied, origin, res, pos)
    d = torch.where(valid, _norm(pos - curr_pos[:, None]),
                    f32(float("inf"), pos.device))
    return valid, torch.argmin(d, dim=-1)


def roadmap_paths(cfg: DEPConfig, occupied: torch.Tensor,
                  origin: torch.Tensor, res: float, pos: torch.Tensor,
                  valid: torch.Tensor, near: torch.Tensor):
    """The roadmap's radius / line-of-sight adjacency and `max_path_len`
    masked Bellman-Ford relaxations from the node `near` (ties to the
    first source). Returns (dist (S, N), pred (S, N), -1 at the root and
    where unreached)."""
    dev = pos.device
    S, N = valid.shape
    diff = pos[:, None] - pos[:, :, None]                 # [s, i, j] = pj - pi
    d_mat = _norm(-diff)
    conn = (d_mat <= cfg.connect_radius) & valid[:, :, None] \
        & valid[:, None, :]
    E = cfg.edge_los_samples
    ts = (np.arange(E, dtype=np.float32) + np.float32(1.0)) \
        * np.float32(recip32(E + 1))
    seg = fma(constant(tuple(ts.tolist()), dev)[:, None], diff[..., None, :],
              pos[:, :, None, None])                        # (S, N, N, E, 3)
    edge_blocked = torch.any(grid_lookup(occupied, origin, res, seg), dim=-1)
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    w = torch.where(conn & ~edge_blocked & ~eye, d_mat,
                    f32(float("inf"), dev))

    dist = torch.full((S, N), float("inf"), device=dev)
    # a device scalar: a Python one through an index tensor is a host copy
    dist[torch.arange(S, device=dev), near] = f32(0.0, dev)
    pred = torch.full((S, N), -1, dtype=torch.int64, device=dev)
    for _ in range(cfg.max_path_len):
        best_d, best_src = torch.min(dist[:, :, None] + w, dim=1)
        better = best_d < dist
        dist = torch.where(better, best_d, dist)
        pred = torch.where(better, best_src, pred)
    return dist, pred


def score_views(cfg: DEPConfig, pos: torch.Tensor, valid: torch.Tensor,
                gain: torch.Tensor, yaw_gain: torch.Tensor,
                dist: torch.Tensor, pred: torch.Tensor,
                curr_yaw: torch.Tensor) -> DEPPlan:
    """getBestViewCandidates (dep.cpp:721-787: the `max_candidates` best
    gains above min_voxel_thresh of the best, a stable top-k) and
    findBestPath (:813-862): each candidate's roadmap path scored by the
    unknown voxels along it over its flight and turning time."""
    dev = pos.device
    S = pos.shape[0]
    ar = torch.arange(S, device=dev)
    inf = f32(float("inf"), dev)
    zero = f32(0.0, dev)
    max_gain = torch.amax(torch.where(valid, gain, zero), dim=-1)
    eligible = valid & (gain >= float(np.float32(cfg.min_voxel_thresh))
                        * max_gain[:, None]) & (gain > 0)
    order = torch.sort(torch.where(eligible, gain, -inf), dim=-1,
                       descending=True, stable=True)
    K = cfg.max_candidates
    cand_idx = order.indices[:, :K]
    cand_ok = order.values[:, :K] > 0

    # back-walk each candidate's predecessor chain (goal -> start), then
    # forward with the start first, the tail padded by the goal
    L = cfg.max_path_len
    node, rev = cand_idx, []
    for _ in range(L):
        rev.append(node)
        node = torch.where(node >= 0, torch.gather(pred, 1,
                                                   torch.clamp(node, min=0)),
                           torch.full_like(node, -1))
    rev = torch.stack(rev, dim=-1)                            # (S, K, L)
    n_live = torch.sum(rev >= 0, dim=-1)
    jl = torch.arange(L, device=dev)
    back = torch.clamp(n_live[..., None] - 1 - jl, 0, L - 1)
    fwd = torch.where(jl < n_live[..., None], torch.gather(rev, 2, back),
                      cand_idx[..., None])
    pts = torch.gather(pos, 1, fwd.reshape(S, K * L, 1).expand(S, K * L, 3)
                       ).reshape(S, K, L, 3)
    nxt = torch.roll(pts, -1, dims=2)
    seg_live = jl < (n_live[..., None] - 1)
    seg_len = torch.where(seg_live, torch.linalg.vector_norm(nxt - pts,
                                                             dim=-1), zero)
    ang = _atan2(nxt[..., 1] - pts[..., 1], nxt[..., 0] - pts[..., 0])
    B = cfg.yaw_bins
    # unknown along the path: each intermediate node contributes its
    # yaw-gain toward the next waypoint; the goal its best yaw
    node_g = yaw_gain[ar[:, None, None], fwd, _yaw_bin(ang, B)]
    cand_yg = torch.gather(yaw_gain, 1, cand_idx[..., None].expand(S, K, B))
    unk = torch.sum(torch.where(seg_live, node_g, zero), dim=-1) \
        + torch.amax(cand_yg, dim=-1)
    byaw = fma(torch.argmax(cand_yg, dim=-1).to(torch.float32) + 0.5,
               f32(2.0 * _PI * recip32(B), dev), f32(-_PI, dev))
    angs = torch.where(seg_live, ang, zero)
    prev = torch.cat([curr_yaw[:, None, None].expand(S, K, 1),
                      angs[..., :-1]], dim=-1)
    dyaw = torch.abs(torch.atan2(torch.sin(angs - prev),
                                 torch.cos(angs - prev)))
    last = torch.where(n_live > 1, torch.gather(
        angs, 2, torch.clamp(n_live - 2, min=0)[..., None])[..., 0],
        curr_yaw[:, None].expand(S, K))
    yaw_dist = torch.sum(torch.where(seg_live, dyaw, zero), dim=-1) \
        + torch.abs(torch.atan2(torch.sin(byaw - last),
                                torch.cos(byaw - last)))
    t_path = torch.sum(seg_len, dim=-1) * recip32(cfg.vel) \
        + cfg.yaw_penalty * yaw_dist * recip32(cfg.angular_vel)
    reachable = torch.isfinite(torch.gather(dist, 1, cand_idx)) & cand_ok
    scores = torch.where(reachable & (t_path > 1e-6),
                         unk / torch.clamp(t_path, min=1e-6), -inf)
    bi = torch.argmax(scores, dim=-1)
    best = scores[ar, bi]
    return DEPPlan(path=pts[ar, bi], path_len=n_live[ar, bi].to(torch.int32),
                   viewpoint=pos[ar, cand_idx[ar, bi]], best_yaw=byaw[ar, bi],
                   gain=unk[ar, bi], score=best,
                   success=torch.isfinite(best) & (best > 0))


def dep_step(cfg: DEPConfig, log_odds: torch.Tensor, origin, res: float,
             state: RoadmapState, curr_pos: torch.Tensor,
             curr_yaw: torch.Tensor, key: torch.Tensor):
    """One exploration cycle for S explorers (dep.cpp makePlan): grow,
    prune and re-gain the persistent roadmaps, then pick and route to the
    best view. log_odds (S, nx, ny, nz), curr_pos (S, 3), curr_yaw (S,),
    key (S, 2). Returns (RoadmapState, DEPPlan)."""
    origin = as_origin(origin, log_odds.device)
    _, free, occupied = classify(log_odds, cfg.explore)
    pos, valid = grow_roadmap(cfg, log_odds, free, origin, res, state, key)
    valid, near = prune(occupied, origin, res, pos, valid, curr_pos)
    gain, yaw_gain = node_gains(cfg, log_odds, origin, res, pos, valid)
    dist, pred = roadmap_paths(cfg, occupied, origin, res, pos, valid, near)
    plan = score_views(cfg, pos, valid, gain, yaw_gain, dist, pred, curr_yaw)
    return RoadmapState(pos=pos, valid=valid, gain=gain,
                        yaw_gain=yaw_gain), plan
