"""Octomap-equivalent: tri-state multi-resolution occupancy pyramid (port of
intent_mpc_tpu/models/octo.py), one pyramid per scenario.

The reference's octomap-backed planners (global_planner/include/
global_planner/rrtOctomap.h, rrtStarOctomap.h) differ from the
occupancy-grid planners in two capabilities:

  * unknown-space semantics: octomap nodes never observed are absent from
    the tree; ``checkCollisionPoint(p, ignoreUnknown)`` (rrtOctomap.h:
    337-350) treats an absent node as occupied unless ``ignoreUnknown_``
    is set, so the planner can refuse to route through unexplored space;
  * multi-resolution queries: ``OcTree::search(p, depth)`` answers
    occupancy at any tree depth; inner nodes hold the max over children.

The octree is a mip pyramid of dense int8 tensors (S, nx >> l, ny >> l,
nz >> l): level 0 is the base tri-state grid (occupied and unknown as two
binary fields; free = neither), level l the 2x2x2 max-pool of level l - 1,
so a coarse cell is occupied exactly when a base voxel below it is.
Unknown is a log-odds still exactly at the 0.0 prior.

The planners of models/global_planner.py take an OctoMap wherever they take
an OccupancyGrid (``occupied_at``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from intent_mpc_torch.models.mapping import (LogOddsMap, MappingConfig,
                                             first_hit)
from intent_mpc_torch.models.occupancy import OccupancyGrid, _lookup
from intent_mpc_torch.utils.device import constant, f32
from intent_mpc_torch.utils.rounding import fma


class OctoMap(NamedTuple):
    """Tri-state occupancy pyramids. levels_occ / levels_unk are tuples of
    (S, nx >> l, ny >> l, nz >> l) int8 tensors, level 0 finest.
    Dimensions are padded up to a multiple of 2 ** (levels - 1); padding is
    free for ``occ`` and unknown for ``unk`` (out-of-map == unobserved, as
    octomap's NULL node answers)."""
    levels_occ: Tuple[torch.Tensor, ...]
    levels_unk: Tuple[torch.Tensor, ...]
    origin: torch.Tensor     # (3,) world position of voxel (0,0,0) corner
    resolution: float        # base (level-0) voxel edge, meters
    ignore_unknown: bool = True

    @property
    def num_levels(self) -> int:
        return len(self.levels_occ)


def _pool2(a: torch.Tensor) -> torch.Tensor:
    """2x2x2 max-pool of (S, nx, ny, nz) with even dims (octomap inner-node
    occupancy = max over children)."""
    S, nx, ny, nz = a.shape
    return a.reshape(S, nx // 2, 2, ny // 2, 2, nz // 2, 2).amax(dim=(2, 4, 6))


def _build_pyramid(base: torch.Tensor, levels: int, pad_value: int
                   ) -> Tuple[torch.Tensor, ...]:
    mult = 1 << (levels - 1)
    pads = []
    for d in reversed(base.shape[1:]):
        pads += [0, (-d) % mult]
    base = F.pad(base, pads, value=pad_value)
    out = [base]
    for _ in range(levels - 1):
        out.append(_pool2(out[-1]))
    return tuple(out)


def from_log_odds(m: LogOddsMap, cfg: MappingConfig, levels: int = 4,
                  ignore_unknown: bool = True) -> OctoMap:
    """The tri-state pyramids of S log-odds maps. Occupied follows
    isOccupied (log-odds >= l_occ); unknown is "never updated", log-odds
    still exactly at the 0.0 prior (octomap: node absent from the tree)."""
    dev = m.log_odds.device
    occ = (m.log_odds >= f32(cfg.l_occ, dev)).to(torch.int8)
    unk = (m.log_odds == 0.0).to(torch.int8)
    return OctoMap(levels_occ=_build_pyramid(occ, levels, 0),
                   levels_unk=_build_pyramid(unk, levels, 1),
                   origin=m.origin, resolution=m.resolution,
                   ignore_unknown=ignore_unknown)


def from_occupancy_grid(g: OccupancyGrid, levels: int = 4) -> OctoMap:
    """Wrap a binary grid, shared (nx, ny, nz) or per scenario (S, nx, ny,
    nz): everything observed, so nothing is unknown."""
    grid = g.grid if g.grid.dim() == 4 else g.grid[None]
    occ = (grid > 0).to(torch.int8)
    return OctoMap(levels_occ=_build_pyramid(occ, levels, 0),
                   levels_unk=_build_pyramid(torch.zeros_like(occ), levels, 0),
                   origin=g.origin,
                   resolution=float(g.resolution.detach().cpu()),
                   ignore_unknown=True)


def _level_lookup(level: torch.Tensor, pad_answer: int, idx: torch.Tensor
                  ) -> torch.Tensor:
    """Gather of (S or 1, a, b, c) at idx (S, ..., 3) (that level's
    resolution); out of bounds -> pad_answer."""
    in_map = torch.ones(idx.shape[:-1], dtype=torch.bool, device=idx.device)
    coords = []
    for a, size in enumerate(level.shape[1:]):
        ia = idx[..., a]
        in_map = in_map & (ia >= 0) & (ia < size)
        coords.append(torch.clamp(ia, 0, size - 1))
    vals = _lookup(level, *coords)
    return torch.where(in_map, vals, torch.full_like(vals, pad_answer))


def search(o: OctoMap, p: torch.Tensor, level: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OcTree::search at a pyramid level: p (S, ..., 3) world points ->
    (occupied, unknown) int8 (S, ...) at that resolution. A coarse cell is
    occupied / unknown if any base voxel below it is."""
    res = f32(o.resolution, p.device)
    idx = torch.floor((p - o.origin) / res).to(torch.int32) >> level
    idx = idx.to(torch.int64)
    occ = _level_lookup(o.levels_occ[level], 0, idx)
    unk = _level_lookup(o.levels_unk[level], 1, idx)
    return occ, unk


def is_blocked(o: OctoMap, p: torch.Tensor) -> torch.Tensor:
    """checkCollisionPoint (rrtOctomap.h:337-350): occupied, or unknown
    when the map was built with ignore_unknown=False. Out-of-map points are
    unknown (octomap search returns NULL), hence blocked for a conservative
    map; this deliberately differs from occupancy.is_occupied, whose
    out-of-map answer is free. p (S, ..., 3) -> bool (S, ...)."""
    occ, unk = search(o, p, 0)
    blocked = occ > 0
    if not o.ignore_unknown:
        blocked = blocked | (unk > 0)
    return blocked


def box_blocked(o: OctoMap, p: torch.Tensor, collision_box,
                samples_per_axis: int) -> torch.Tensor:
    """checkCollision with a robot collision box (rrtOctomap.h:313-335):
    the box sampled on a static (s, s, s) lattice around p (S, 3), ends
    included, the point checks OR-ed. collision_box: (3,) full extents.
    Returns (S,) bool."""
    s = max(2, samples_per_axis)
    dev = p.device
    fr = torch.arange(s, dtype=torch.float32, device=dev) \
        / f32(s - 1, dev) - 0.5
    half = constant(tuple(float(c) for c in collision_box), dev)
    offs = torch.stack(torch.meshgrid(fr * half[0], fr * half[1],
                                      fr * half[2], indexing="ij"),
                       dim=-1).reshape(-1, 3)
    return torch.any(is_blocked(o, p[:, None, :] + offs), dim=-1)


def segment_free(o: OctoMap, a: torch.Tensor, b: torch.Tensor,
                 checks: int = 8) -> torch.Tensor:
    """checkCollisionLine (rrtOctomap.h:359+): no blocked sample on (a, b]
    for segments a, b (S, ..., 3) -> bool (S, ...).

    Hierarchical: a coarse pass at the top pyramid level (cells 2^(L-1)
    voxels wide) proves most segments free; where it hits, the fine pass
    decides. Both passes are computed and selected per segment (a branch
    on the coarse answer would read the device on every edge); the coarse
    all-clear is exact under the inner-max policy."""
    dev = a.device
    d = (b - a)[..., None, :]
    fine_fr = (torch.arange(checks, dtype=torch.float32, device=dev)
               + 1.0) / f32(checks, dev)
    fine = ~torch.any(is_blocked(o, fma(d, fine_fr[:, None],
                                        a[..., None, :])), dim=-1)
    top = o.num_levels - 1
    coarse_checks = max(2, checks // (1 << top) + 1)
    fr = (torch.arange(coarse_checks, dtype=torch.float32, device=dev)
          + 1.0) / f32(coarse_checks, dev)
    occ, unk = search(o, fma(d, fr[:, None], a[..., None, :]), top)
    hit = occ > 0
    if not o.ignore_unknown:
        hit = hit | (unk > 0)
    return ~torch.any(hit, dim=-1) | fine


def cast_ray(o: OctoMap, start: torch.Tensor, end: torch.Tensor,
             samples: int = 256):
    """First blocked sample between start and end (S, 3) (octomap
    computeRay + per-point search; mapping.first_hit)."""
    return first_hit(lambda p: is_blocked(o, p), start, end, samples)
