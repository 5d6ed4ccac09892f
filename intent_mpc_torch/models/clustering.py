"""Static-obstacle clustering: DBSCAN -> 2-means tree refinement -> rotated
bounding boxes (port of intent_mpc_tpu/models/clustering.py).

Rebuild of trajectory_planner/clustering (obstacleClustering.cpp, DBSCAN.h,
Kmeans.cpp), fixed-shape and batched over a leading scenario axis S:

  * DBSCAN: pairwise-distance core-point test, then label propagation
    over the core adjacency graph to the fixed point where each core
    point holds the minimum core index of its component; border points
    attach to the minimum core-neighbour label.
  * 2-means split (runKmeans :129-227): farthest-point-pair init, fixed
    Lloyd iterations, membership masks.
  * getOrientation (:230-283): angle sweep maximizing the rotated bbox's
    point density.
  * the refinement tree (run :14-95): `tree_level` rounds of conditional
    splitting on density < 0.9 into a padded slot array.

Ties follow the JAX package: argmin/argmax take the first index, sorts
are stable, and the squared distances of the DBSCAN radius test and the
norms are rounded as the JAX package's CPU program rounds them
(`utils/rounding.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from intent_mpc_torch.utils import trace
from intent_mpc_torch.utils.device import constant
from intent_mpc_torch.utils.rounding import fma, norm3, sq_sum3

DBSCAN_BLOCK = 8


class ClusteringConfig(NamedTuple):
    eps: float = 0.5
    min_pts: int = 15
    tree_level: int = 3
    angle_num: int = 20
    density_thresh: float = 0.9
    kmeans_iters: int = 10
    resolution: float = 0.2
    max_clusters: int = 8          # DBSCAN slot count before refinement


class StaticObstacles(NamedTuple):
    centroid: torch.Tensor   # (S, C, 3)
    size: torch.Tensor       # (S, C, 3)
    yaw: torch.Tensor        # (S, C)
    active: torch.Tensor     # (S, C) bool


def dbscan(points: torch.Tensor, valid: torch.Tensor, eps: float,
           min_pts: int) -> torch.Tensor:
    """Labels (S, P) int32: cluster id = the minimum core index of the
    cluster; -1 noise. points (S, P, 3), valid (S, P).

    JAX runs the propagation in a while_loop until no label changes. Here
    the rounds run in blocks of DBSCAN_BLOCK, and the host reads the
    "changed" flag of a block's last round once per block: the only
    synchronization. The reads count as "clustering.host_reads" and the
    rounds as "clustering.rounds" in utils/trace. Each round takes the minimum label over the core
    neighbours and then jumps once through the label's own label (a core
    point's label is the index of a core point of its component, so
    labels[labels] stays inside the component). That reaches the same
    fixed point, the component minimum, in fewer rounds; rounds past it
    change nothing."""
    S, P = points.shape[:2]
    x, y, z = (points[:, :, None, a] - points[:, None, :, a]
               for a in range(3))
    adj = sq_sum3(x, y, z) <= eps * eps
    del x, y, z
    adj &= valid[:, :, None] & valid[:, None, :]
    degree = adj.sum(dim=-1)
    core = (degree >= min_pts) & valid

    idx = torch.arange(P, dtype=torch.int32, device=points.device)
    big = torch.full((), P, dtype=torch.int32, device=points.device)
    labels = torch.where(core, idx, big)
    core_adj = adj & core[:, :, None] & core[:, None, :]
    while True:
        for _ in range(DBSCAN_BLOCK):
            neigh = torch.where(core_adj, labels[:, None, :], big).amin(dim=-1)
            new = torch.minimum(labels, neigh)
            jump = torch.gather(new, 1, torch.clamp(new, max=P - 1).long())
            new = torch.where(core, torch.minimum(new, jump), labels)
            changed = torch.any(new != labels)
            labels = new
        trace.count("clustering.rounds", DBSCAN_BLOCK)
        trace.count("clustering.host_reads")
        if not bool(changed):
            break
    del core_adj

    border = torch.where(adj & core[:, None, :], labels[:, None, :],
                         big).amin(dim=-1)
    labels = torch.where(core, labels, border)
    return torch.where(valid & (labels < P), labels,
                       torch.full_like(labels, -1))


def _masked_bbox(points, w):
    """points (S, 1.., P, 3) against weights (S, .., P): min and max over
    the points with w > 0 (+-1e9 where none)."""
    m = w[..., None] > 0
    mn = torch.where(m, points, torch.full_like(points, 1e9)).amin(dim=-2)
    mx = torch.where(m, points, torch.full_like(points, -1e9)).amax(dim=-2)
    return mn, mx


def kmeans_split(points: torch.Tensor, w: torch.Tensor, iters: int):
    """Split each cluster (membership weights w (S, C, P) over points
    (S, P, 3)) into two via 2-means with farthest-point-pair
    initialization (runKmeans :134-166). Returns (w_a, w_b)."""
    pts = points[:, None]                                       # (S,1,P,3)
    mn, mx = _masked_bbox(pts, w)
    centroid = (mn + mx) / 2.0                                  # (S,C,3)
    d0 = norm3(pts - centroid[:, :, None, :]) * w
    f = _gather_point(points, torch.argmax(d0, dim=-1))                # (S,C,3)
    d1 = norm3(pts - f[:, :, None, :]) * w
    ff = _gather_point(points, torch.argmax(d1, dim=-1))
    c = torch.stack([f, ff], dim=2)                             # (S,C,2,3)

    def assign_of(c):
        d = norm3(pts[:, :, :, None, :] - c[:, :, None, :, :])  # (S,C,P,2)
        return torch.argmin(d, dim=-1)

    for _ in range(iters):
        assign = assign_of(c)
        cs = []
        for j in (0, 1):
            wj = w * (assign == j)
            cs.append(torch.sum(pts * wj[..., None], dim=-2)
                      / torch.clamp(torch.sum(wj, dim=-1), min=1e-9)[..., None])
        c = torch.stack(cs, dim=2)
    assign = assign_of(c)
    return w * (assign == 0), w * (assign == 1)


def _gather_point(points: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """points (S, P, 3) at per-slot indices i (S, C) -> (S, C, 3)."""
    return torch.gather(points, 1, i[..., None].expand(i.shape + (3,)))


def best_orientation(cfg: ClusteringConfig, points: torch.Tensor,
                     w: torch.Tensor):
    """Angle sweep maximizing bbox point density (getOrientation :230-283)
    for every slot: points (S, P, 3), w (S, C, P). Returns (centroid
    (S, C, 3), dimension (S, C, 3), yaw (S, C), density (S, C))."""
    dev = points.device
    pts = points[:, None]                                       # (S,1,P,3)
    mn, mx = _masked_bbox(pts, w)
    centroid = (mn + mx) / 2.0                                  # (S,C,3)
    angles_np = (np.float32(np.pi) * np.arange(cfg.angle_num, dtype=np.float32)
                 / np.float32(cfg.angle_num))
    angles = constant(tuple(angles_np.tolist()), dev)
    # float32 cos/sin of the table, correctly rounded (the JAX package's
    # values for these arguments)
    a64 = angles_np.astype(np.float64)
    ca = constant(tuple(np.cos(a64).astype(np.float32).tolist()), dev)
    sa = constant(tuple(np.sin(a64).astype(np.float32).tolist()), dev)
    rel = pts - centroid[:, :, None, :]                         # (S,C,P,3)
    rx_, ry_, rz_ = (rel[:, :, None, :, a] for a in range(3))   # (S,C,1,P)
    cab, sab = ca[:, None], sa[:, None]                         # (A,1)
    rx = fma(cab, rx_, -(sab * ry_))
    ry = fma(sab, rx_, cab * ry_)
    rz = rz_.expand(rx.shape)
    rot = torch.stack([rx, ry, rz], dim=-1)                     # (S,C,A,P,3)

    mn_a, mx_a = _masked_bbox(rot, w[:, :, None, :])            # (S,C,A,3)
    ext = mx_a - mn_a
    num = ext / cfg.resolution + 1.0
    npts = torch.sum(w, dim=-1)                                 # (S,C)
    density = npts[..., None] / (num[..., 0] * num[..., 1] * num[..., 2])
    best = torch.argmax(density, dim=-1)                               # (S,C)

    def pick(a):
        return torch.gather(a, 2, best[:, :, None, None].expand(
            a.shape[:2] + (1,) + a.shape[3:]))[:, :, 0]
    dim = pick(ext)
    mid = (pick(mn_a) + pick(mx_a)) / 2.0
    a = angles[best]
    cna, sna = torch.cos(-a), torch.sin(-a)
    cx = cna * mid[..., 0] - sna * mid[..., 1] + centroid[..., 0]
    cy = sna * mid[..., 0] + cna * mid[..., 1] + centroid[..., 1]
    cz = mid[..., 2] + centroid[..., 2]
    dens = torch.gather(density, 2, best[..., None])[..., 0]
    return (torch.stack([cx, cy, cz], dim=-1), dim, -a,
            torch.where(npts > 0, dens, torch.zeros_like(dens)))


def cluster_obstacles(cfg: ClusteringConfig, points: torch.Tensor,
                      valid: torch.Tensor) -> StaticObstacles:
    """Full pipeline for points (S, P, 3), valid (S, P): DBSCAN seeds,
    density-driven 2-means tree refinement, rotated bboxes
    (obstacleClustering::run)."""
    S, P = points.shape[:2]
    dev, dt = points.device, points.dtype
    labels = dbscan(points, valid, cfg.eps, cfg.min_pts)

    # the max_clusters largest labels -> initial membership masks; a stable
    # sort keeps equal sizes in index order, as jnp.argsort does
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    sizes = torch.sum((labels[:, None, :] == ar[None, :, None])
                      & (labels[:, None, :] >= 0), dim=-1)      # (S,P)
    top = torch.argsort(-sizes, dim=-1, stable=True)[:, :cfg.max_clusters]
    top_size = torch.gather(sizes, 1, top)
    slot_active = top_size > 0
    member = ((labels[:, None, :] == top[:, :, None])
              & slot_active[:, :, None]).to(dt)                 # (S,C0,P)

    C = cfg.max_clusters * (2 ** cfg.tree_level)
    W = torch.zeros((S, C, P), dtype=dt, device=dev)
    W[:, :cfg.max_clusters] = member
    active = torch.zeros((S, C), dtype=torch.bool, device=dev)
    active[:, :cfg.max_clusters] = slot_active
    complete = torch.zeros((S, C), dtype=torch.bool, device=dev)
    n_slots = cfg.max_clusters
    slots = torch.arange(C, device=dev)

    for _ in range(cfg.tree_level):
        dens = best_orientation(cfg, points, W)[3]
        need_split = active & ~complete & (dens < cfg.density_thresh)
        w_a, w_b = kmeans_split(points, W, cfg.kmeans_iters)
        # children replace the parent slot and occupy a mirrored new slot
        W_new = torch.where(need_split[..., None], w_a, W)
        child = slots + n_slots
        ok_child = need_split & (child < C)
        dst = torch.where(ok_child, child, torch.full_like(child, C - 1))
        W_new = W_new.scatter_reduce(
            1, dst[..., None].expand(S, C, P),
            torch.where(ok_child[..., None], w_b, torch.zeros_like(w_b)),
            reduce="amax", include_self=True)
        active = _set_last_wins(active, dst,
                                torch.gather(active, 1, dst) | ok_child)
        complete = torch.where(need_split, torch.zeros_like(complete),
                               torch.where(active & ~complete,
                                           torch.ones_like(complete),
                                           complete))
        W = W_new
        n_slots = min(n_slots * 2, C)

    cen, dim, yaw, _ = best_orientation(cfg, points, W)
    has_pts = torch.sum(W, dim=-1) > 0
    return StaticObstacles(centroid=cen, size=dim, yaw=yaw,
                           active=active & has_pts)


def _set_last_wins(a: torch.Tensor, dst: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """a.at[dst].set(vals) along axis 1, per scenario, where among rows
    that share a destination the highest row's value lands (the JAX
    package's CPU scatter applies updates in row order). a, dst, vals
    (S, C)."""
    C = dst.shape[1]
    rows = torch.arange(C, device=dst.device)
    hit = dst[:, None, :] == rows[None, :, None]                # (S,target,row)
    src = torch.where(hit, rows, torch.full_like(rows, -1)).amax(dim=-1)
    got = torch.gather(vals, 1, torch.clamp(src, min=0))
    return torch.where(src >= 0, got, a)
