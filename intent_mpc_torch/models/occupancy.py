"""Voxel occupancy grid as a tensor (port of
intent_mpc_tpu/models/occupancy.py, the parts the default loop reads).

In the DYNUS benchmark no depth sensor runs, so the map stays empty and
every occupancy query reports free; the query surface is kept as a
gather into a dense int8 grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OccupancyGrid(NamedTuple):
    grid: torch.Tensor        # (nx, ny, nz) int8; 1 = inflated-occupied
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


def is_occupied(g: OccupancyGrid, p: torch.Tensor) -> torch.Tensor:
    """Vectorized isInflatedOccupied: p (..., 3) -> bool (...).

    Out-of-map points are free (occupancyMap isInMap semantics)."""
    idx = torch.floor((p - g.origin) / g.resolution).to(torch.int64)
    in_map = torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    coords = []
    for a, size in enumerate(g.grid.shape):
        ia = idx[..., a]
        in_map = in_map & (ia >= 0) & (ia < size)
        coords.append(torch.clamp(ia, 0, size - 1))
    vals = g.grid[coords[0], coords[1], coords[2]]
    return in_map & (vals > 0)
