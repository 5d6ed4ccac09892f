"""Voxel-grid helpers shared by the planners and trajectory back ends:
map origins, voxel indices, masks looked up at points, and windows of
voxels around points (the windowed counts of exploration and dep, the
nearest-obstacle search of traj_divider), batched over a leading
scenario axis S."""

from __future__ import annotations

import math

import torch

from intent_mpc_torch.utils.device import constant, f32
from intent_mpc_torch.utils.rounding import fma, recip32

# elements of one chunk of a windowed count (viewpoints x window voxels)
WINDOW_CHUNK_ELEMS = 1 << 26
# one window axis (..., W) spread over the window (..., Wx, Wy, Wz)
WIN_X = (..., slice(None), None, None)
WIN_Y = (..., None, slice(None), None)
WIN_Z = (..., None, None, slice(None))


def as_origin(origin, device) -> torch.Tensor:
    """A map origin (3,) float32 on `device`: a tensor as given, a sequence
    as a cached constant (no copy from the host per call)."""
    if isinstance(origin, torch.Tensor):
        return origin.to(device=device, dtype=torch.float32)
    return constant(tuple(float(o) for o in origin), device)


def voxel_index(p: torch.Tensor, origin: torch.Tensor,
                resolution: float) -> torch.Tensor:
    """int64 voxel indices floor((p - origin) / resolution) of p (..., 3),
    the division by a constant resolution taken as XLA compiles it: a
    multiplication by its float32 reciprocal."""
    return torch.floor((p - origin) * recip32(resolution)).to(torch.int64)


def grid_lookup(mask: torch.Tensor, origin: torch.Tensor, resolution: float,
                pts: torch.Tensor) -> torch.Tensor:
    """mask (S, nx, ny, nz) at each point pts (S, ..., 3) of its scenario:
    False outside the grid."""
    idx = voxel_index(pts, origin, resolution)
    dims = mask.shape[1:]
    inside = torch.ones(idx.shape[:-1], dtype=torch.bool, device=pts.device)
    cl = []
    for a in range(3):
        inside = inside & (idx[..., a] >= 0) & (idx[..., a] < dims[a])
        cl.append(torch.clamp(idx[..., a], 0, dims[a] - 1))
    S = mask.shape[0]
    sc = torch.arange(S, device=pts.device).reshape(
        (S,) + (1,) * (idx.dim() - 2))
    return mask[sc, cl[0], cl[1], cl[2]] & inside


def window_radius(extent: float, resolution: float) -> int:
    """Window half-width in voxels that holds every voxel center within
    `extent` of a point, on either side of the point's own voxel."""
    return int(math.ceil(extent / resolution)) + 2


def window_axes(p: torch.Tensor, origin: torch.Tensor, resolution: float,
                dims, radii):
    """Per-axis window of the points p (S, V, 3): for each axis a, the
    voxel indices (S, V, 2 r_a + 1) around p's own voxel (clamped into
    the grid), whether each lies inside the grid, and the offset of its
    center from p, origin_a + (i + 0.5) res - p_a with the center as one
    FMA (the voxel centers of JAX's compiled program)."""
    base = voxel_index(p, origin, resolution)
    out = []
    for a, r in enumerate(radii):
        off = torch.arange(-r, r + 1, device=p.device)
        i = base[..., a, None] + off
        inside = (i >= 0) & (i < dims[a])
        c = fma((i.to(torch.float32) + 0.5), f32(resolution, p.device),
                origin[a])
        out.append((torch.clamp(i, 0, dims[a] - 1), inside,
                    c - p[..., a, None]))
    return out


def scenario_chunks(S: int, per_scenario: int):
    """Ranges of scenarios holding at most WINDOW_CHUNK_ELEMS elements each
    (one scenario at least)."""
    step = max(1, WINDOW_CHUNK_ELEMS // max(per_scenario, 1))
    return [(s, min(s + step, S)) for s in range(0, S, step)]
