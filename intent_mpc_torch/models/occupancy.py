"""Voxel occupancy grid as a tensor (port of
intent_mpc_tpu/models/occupancy.py).

In the DYNUS benchmark no depth sensor runs, so the map stays empty and
every occupancy query reports free; the query surface is kept as a
gather into a dense int8 grid. A static grid can be rasterized from
static obstacles (`build_from_static_obstacles`, the prebuilt-map mode of
the real-perception loop).

The grid is either shared by the batch, (nx, ny, nz), or one per
scenario, (S, nx, ny, nz) (`stack_grids`): every seed has its own
statics. Queries then take points with the scenario axis leading,
(S, ..., 3). The origin (3,) and resolution are shared.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from intent_mpc_torch.utils.device import constant
from intent_mpc_torch.utils.rounding import fma, sq_norm3


class OccupancyGrid(NamedTuple):
    grid: torch.Tensor        # (nx, ny, nz) or (S, nx, ny, nz) int8; 1 = occupied
    origin: torch.Tensor      # (3,) world position of voxel (0,0,0) corner
    resolution: torch.Tensor  # scalar


def empty_grid(device="cpu") -> OccupancyGrid:
    """A grid that reports free everywhere (the DYNUS benchmark map state)."""
    return OccupancyGrid(
        grid=torch.zeros((1, 1, 1), dtype=torch.int8, device=device),
        origin=torch.full((3,), 1e9, dtype=torch.float32, device=device),
        resolution=torch.tensor(1.0, dtype=torch.float32, device=device),
    )


def is_empty(g: OccupancyGrid) -> bool:
    """True for the single-voxel empty grid (a shape test, no device read)."""
    return g.grid.numel() == 1


def _per_scenario(g: OccupancyGrid) -> torch.Tensor:
    """The grid with a scenario axis: (S or 1, nx, ny, nz)."""
    return g.grid if g.grid.dim() == 4 else g.grid[None]


def _lookup(grid4: torch.Tensor, i0, i1, i2) -> torch.Tensor:
    """grid values at voxel indices (S, ...) of each scenario's own grid,
    or of the shared grid (indexed by a Python int: a 0-dim index tensor
    would be read on the host)."""
    if grid4.shape[0] == 1:
        return grid4[0][i0, i1, i2]
    S = grid4.shape[0]
    s = torch.arange(S, device=i0.device).reshape((S,) + (1,) * (i0.dim() - 1))
    return grid4[s, i0, i1, i2]


def is_occupied(g: OccupancyGrid, p: torch.Tensor) -> torch.Tensor:
    """Vectorized isInflatedOccupied: p (..., 3) -> bool (...); with a
    per-scenario grid p is (S, ..., 3) and each scenario reads its own.

    Out-of-map points are free (occupancyMap isInMap semantics)."""
    grid4 = _per_scenario(g)
    idx = torch.floor((p - g.origin) / g.resolution).to(torch.int64)
    in_map = torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    coords = []
    for a, size in enumerate(grid4.shape[1:]):
        ia = idx[..., a]
        in_map = in_map & (ia >= 0) & (ia < size)
        coords.append(torch.clamp(ia, 0, size - 1))
    vals = _lookup(grid4, *coords)
    return in_map & (vals > 0)


def local_occupied_points(g: OccupancyGrid, center: torch.Tensor,
                          window: tuple, max_points: int):
    """Fixed-shape local static cloud: the `max_points` occupied voxel
    centers nearest `center` (S, 3) within a `window`-voxel box around it,
    from the scenario's own grid.

    The reference feeds obstacleClustering a local static point cloud
    gathered from the map around the robot (mpcPlanner.cpp getStaticObs
    path; obstacleClustering.cpp:14-95). The window is clamped into the
    grid as JAX's dynamic_slice clamps it, and the nearest are taken by a
    stable descending sort, so equal distances keep the lower window
    index first, as `lax.top_k` does. Returns (pts (S, max_points, 3),
    valid (S, max_points) bool)."""
    grid4 = _per_scenario(g)
    S = center.shape[0]
    dev = center.device
    dims = grid4.shape[1:]
    win = [min(w, d) for w, d in zip(window, dims)]
    res = g.resolution
    half = constant(tuple(w // 2 for w in window), dev, torch.int32)
    hi = constant(tuple(max(d - w, 0) for d, w in zip(dims, window)), dev,
                  torch.int32)
    idx0 = torch.floor((center - g.origin) / res).to(torch.int32) - half
    idx0 = torch.minimum(torch.clamp(idx0, min=0), hi)        # (S, 3)
    ii, jj, kk = torch.meshgrid(*(torch.arange(w, device=dev) for w in win),
                                indexing="ij")
    offs = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3)   # (V, 3)
    vox = offs[None].to(torch.int32) + idx0[:, None, :]       # (S, V, 3)
    v = vox.to(torch.int64)
    occm = _lookup(grid4, v[..., 0], v[..., 1], v[..., 2]) > 0  # (S, V)
    coords = fma(vox.to(torch.float32) + 0.5, res, g.origin)
    d2 = sq_norm3(coords - center[:, None, :])
    score = torch.where(occm, -d2, torch.full_like(d2, float("-inf")))
    k = min(max_points, coords.shape[1])
    top, sel = torch.sort(score, dim=-1, descending=True, stable=True)
    top, sel = top[:, :k], sel[:, :k]
    pts = torch.gather(coords, 1, sel[..., None].expand(S, k, 3))
    valid = torch.isfinite(top)
    if k < max_points:
        pts = torch.cat([pts, pts.new_zeros((S, max_points - k, 3))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((S, max_points - k))],
                          dim=1)
    return torch.where(valid[..., None], pts, torch.zeros_like(pts)), valid


def build_from_static_obstacles(origin, size_m, resolution, centers, bboxes,
                                inflation, device="cpu") -> OccupancyGrid:
    """Rasterize axis-aligned static boxes (inflated by the robot size)
    into one scenario's (nx, ny, nz) grid, on the host, then move it to
    `device`."""
    origin = np.asarray(origin, np.float32)
    dims = tuple(int(np.ceil(s / resolution)) for s in size_m)
    grid = np.zeros(dims, np.int8)
    centers = np.asarray(centers)
    bboxes = np.asarray(bboxes)
    inflation = np.asarray(inflation)
    for c, b in zip(centers, bboxes):
        half = b / 2.0 + inflation
        lo = np.floor((c - half - origin) / resolution).astype(int)
        hi = np.ceil((c + half - origin) / resolution).astype(int)
        lo = np.clip(lo, 0, np.array(dims) - 1)
        hi = np.clip(hi, 0, np.array(dims))
        grid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
    return OccupancyGrid(
        grid=torch.as_tensor(grid, device=device),
        origin=torch.as_tensor(origin, device=device),
        resolution=torch.tensor(resolution, dtype=torch.float32,
                                device=device))


def stack_grids(grids: Sequence[OccupancyGrid]) -> OccupancyGrid:
    """One per-scenario grid (S, nx, ny, nz) from S grids of one shape and
    one origin and resolution."""
    g0 = grids[0]
    for g in grids[1:]:
        if (g.grid.shape != g0.grid.shape
                or not torch.equal(g.origin, g0.origin)
                or not torch.equal(g.resolution, g0.resolution)):
            raise ValueError("stack_grids needs grids of one shape, origin "
                             "and resolution")
    return OccupancyGrid(grid=torch.stack([g.grid for g in grids]),
                         origin=g0.origin, resolution=g0.resolution)
