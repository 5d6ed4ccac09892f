"""Frontier-based exploration planning (port of
intent_mpc_tpu/models/exploration.py), batched over a leading scenario
axis S.

Rebuild of global_planner's dynamic exploration planner (dep.cpp) in its
one-shot form over the log-odds map:

  * unknown voxels: |log_odds| below an evidence threshold (never observed)
  * frontiers: free voxels 6-adjacent to unknown ones (padded shifts)
  * candidate viewpoints: seeded draws in a box, kept in observed-free
    space, scored by the number of unknown voxels inside sensor range
    (information gain) discounted by distance
  * the best view's path from the PRM planner (global_planner.prm_plan)

The gain counts only a window of the map around each viewpoint: the voxels
whose index lies within ceil(range / resolution) + 2 of the viewpoint's
own index on every axis, which holds every voxel center within range. The
counts equal the JAX package's count over the whole map (sums of ones, in
any order) at a fraction of the work at the DYNUS width (0.15 m voxels, 5
m range: 73^3 of 8.38M voxels per viewpoint).

Distances and voxel centers follow the JAX package's compiled CPU program
(a sum of squares as one chain of FMAs, the center as one FMA;
utils/rounding.py), so that both packages, and the card and the CPU, count
the same voxels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from intent_mpc_torch.models.global_planner import PRMConfig, prm_plan
from intent_mpc_torch.models.occupancy import OccupancyGrid
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.device import f32
from intent_mpc_torch.utils.grid import (WIN_X, WIN_Y, WIN_Z, as_origin,
                                         grid_lookup, scenario_chunks,
                                         window_axes, window_radius)
from intent_mpc_torch.utils.rounding import sq_sum3, sqrt32


class ExplorationConfig(NamedTuple):
    evidence_thresh: float = 1e-3    # |log odds| below -> unknown
    occupied_thresh: float = 1.39    # log odds above -> occupied (p=0.8)
    sensor_range: float = 5.0
    num_candidates: int = 128
    distance_weight: float = 0.3     # gain discount per meter of distance


def classify(log_odds: torch.Tensor, cfg: ExplorationConfig):
    """(unknown, free, occupied) boolean grids of log_odds (S, nx, ny, nz)."""
    unknown = torch.abs(log_odds) < cfg.evidence_thresh
    occupied = log_odds >= cfg.occupied_thresh
    free = ~unknown & ~occupied
    return unknown, free, occupied


def frontiers(log_odds: torch.Tensor, cfg: ExplorationConfig) -> torch.Tensor:
    """Free voxels 6-adjacent to unknown voxels: (S, nx, ny, nz) bool.

    Padded shifts, not a roll: a roll wraps around the grid and marks
    voxels on one face as frontiers of unknown space on the opposite
    face."""
    unknown, free, _ = classify(log_odds, cfg)
    up = torch.nn.functional.pad(unknown, (1, 1, 1, 1, 1, 1))
    near_unknown = (up[:, 2:, 1:-1, 1:-1] | up[:, :-2, 1:-1, 1:-1]
                    | up[:, 1:-1, 2:, 1:-1] | up[:, 1:-1, :-2, 1:-1]
                    | up[:, 1:-1, 1:-1, 2:] | up[:, 1:-1, 1:-1, :-2])
    return free & near_unknown


def information_gain(log_odds: torch.Tensor, origin, resolution: float,
                     viewpoints: torch.Tensor,
                     cfg: ExplorationConfig) -> torch.Tensor:
    """Unknown-voxel count within sensor range of each viewpoint: log_odds
    (S, nx, ny, nz), viewpoints (S, V, 3) -> (S, V) int64.

    The reference casts rays per node (dep.cpp gain evaluation); a range
    ball over the unknown mask is the dense equivalent (occlusion-free
    upper bound, which is also what DEP's coarse gain uses)."""
    unknown, _, _ = classify(log_odds, cfg)
    origin = as_origin(origin, log_odds.device)
    dims = log_odds.shape[1:]
    r = window_radius(cfg.sensor_range, resolution)
    r2 = float(np.float32(cfg.sensor_range ** 2))
    S, V = viewpoints.shape[:2]
    out = []
    for s0, s1 in scenario_chunks(S, V * (2 * r + 1) ** 3):
        (ix, inx, dx), (iy, iny, dy), (iz, inz, dz) = window_axes(
            viewpoints[s0:s1], origin, resolution, dims, (r, r, r))
        d2 = sq_sum3(dx[WIN_X], dy[WIN_Y], dz[WIN_Z])
        inside = inx[WIN_X] & iny[WIN_Y] & inz[WIN_Z]
        sc = torch.arange(s0, s1, device=log_odds.device)[:, None, None,
                                                           None, None]
        unk = unknown[sc, ix[WIN_X], iy[WIN_Y], iz[WIN_Z]]
        out.append(torch.sum(unk & inside & (d2 <= r2), dim=(-3, -2, -1)))
    return torch.cat(out)


class ExplorationPlan(NamedTuple):
    viewpoint: torch.Tensor   # (S, 3) chosen next-best view
    gain: torch.Tensor        # (S,) information gain
    path: torch.Tensor        # (S, L, 3) path from current position
    path_len: torch.Tensor    # (S,) int32
    success: torch.Tensor     # (S,) bool


def plan_next_view(log_odds: torch.Tensor, origin, resolution: float,
                   curr_pos: torch.Tensor, bounds_lo: torch.Tensor,
                   bounds_hi: torch.Tensor, key: torch.Tensor,
                   cfg: ExplorationConfig = ExplorationConfig(),
                   prm_cfg: PRMConfig = PRMConfig()) -> ExplorationPlan:
    """Next-best-view selection + PRM path (the DEP cycle) for S maps:
    curr_pos, bounds_lo, bounds_hi (S, 3), key (S, 2)."""
    dev = log_odds.device
    origin = as_origin(origin, dev)
    lo, hi = bounds_lo, bounds_hi
    k = prng.split(prng.fold_in(key, 0))
    u = prng.uniform(k[:, 0], (cfg.num_candidates, 3))
    cands = u * (hi - lo)[:, None] + lo[:, None]

    # candidates must be in observed-free space
    _, free, occupied = classify(log_odds, cfg)
    is_free = grid_lookup(free, origin, resolution, cands)

    gains = information_gain(log_odds, origin, resolution, cands,
                             cfg).to(torch.float32)
    dist = sqrt32(sq_sum3(*(cands - curr_pos[:, None]).unbind(-1)))
    score = torch.where(is_free,
                        gains * torch.exp(-cfg.distance_weight * dist),
                        f32(-1.0, dev))
    best = torch.argmax(score, dim=-1)
    ar = torch.arange(score.shape[0], device=dev)
    view = cands[ar, best]

    occ_grid = OccupancyGrid(grid=occupied.to(torch.int8), origin=origin,
                             resolution=f32(resolution, dev))
    res = prm_plan(occ_grid, curr_pos, view, lo, hi, k[:, 1], prm_cfg)
    return ExplorationPlan(viewpoint=view, gain=gains[ar, best],
                           path=res.path, path_len=res.length,
                           success=res.success & (score[ar, best] > 0))
