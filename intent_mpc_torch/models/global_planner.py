"""Global planner: the goal-biased RRT with shortcutting (port of the RRT
part of intent_mpc_tpu/models/global_planner.py).

Rebuild of global_planner/ rrtOccMap::makePlan (:183-290) and
shortcutWaypointPaths (:317+). The incremental tree lives in fixed-size
tensors (nodes (S, N, 3), parent (S, N), N = max_iters + 2) for a batch of
S planning problems, one per scenario: each iteration samples (goal-biased),
finds the nearest tree node by a masked argmin, steers by the incremental
distance, checks the edge by sampled occupancy lookups and appends under a
mask. Every problem runs all `max_iters` iterations, as the JAX scan does;
after a problem reaches the goal its later iterations change nothing.

The samples are `jax.random`'s bits (utils/prng.py): a problem's key is
folded with the iteration, split in two, and drawn from with `uniform`. The
draws do not depend on the tree, so all of a build's draws come from three
batched hash calls before the loop.

The JAX package's RRT* (`rrt_star_plan`), PRM (`prm_plan`) and grid
wavefront (`grid_wavefront`) are not ported, and `occupied_at` reads the
occupancy grid only: the octree map of models/octo.py is not ported.

Config mirrors global_planner yaml: incremental_distance 0.5,
goal_reach_distance 0.4, connect_goal_ratio 0.2, max_shortcut_dist 3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intent_mpc_torch.models.occupancy import OccupancyGrid, is_occupied
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.rounding import fma


def occupied_at(m, p: torch.Tensor) -> torch.Tensor:
    """Point-collision test of the planners: p (S, ..., 3) -> bool (S, ...)
    against an occupancy grid (shared, or one per scenario)."""
    if not isinstance(m, OccupancyGrid):
        raise NotImplementedError(
            "occupied_at reads an OccupancyGrid only: the octree map "
            "(models/octo.py) is not ported, got %s" % type(m).__name__)
    return is_occupied(m, p)


class RRTConfig(NamedTuple):
    max_iters: int = 512
    incremental_dist: float = 0.5
    goal_reach_dist: float = 0.4
    connect_goal_ratio: float = 0.2
    edge_checks: int = 8           # collision samples per edge
    max_path_len: int = 64
    shortcut_rounds: int = 3
    max_shortcut_dist: float = 3.0


class RRTResult(NamedTuple):
    path: torch.Tensor       # (S, max_path_len, 3) start..goal, padded with goal
    length: torch.Tensor     # (S,) int32 valid waypoints
    success: torch.Tensor    # (S,) bool


def _edge_free(occ, a: torch.Tensor, b: torch.Tensor,
               checks: int) -> torch.Tensor:
    """No occupied sample on the segments a -> b: a, b (S, ..., 3) ->
    (S, ...) bool; the samples a + (b - a) (i + 1) / checks, i < checks."""
    fr = (torch.arange(checks, dtype=torch.float32, device=a.device)
          + 1.0) / checks
    d = (b - a)[..., None, :]
    pts = fma(d, fr[:, None], a[..., None, :])               # (..., C, 3)
    return ~torch.any(occupied_at(occ, pts), dim=-1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[s, idx[s]] for x (S, N, ...) and idx (S,)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def rrt_draws(key: torch.Tensor, iters: int, ratio: float,
              lo: torch.Tensor, hi: torch.Tensor, goal: torch.Tensor):
    """Every sample of a batch of RRT runs: key (S, 2); lo, hi, goal (S, 3).
    Returns q_rand (S, iters, 3), the goal where the goal-biased coin says
    so and a uniform draw in the box elsewhere."""
    it = torch.arange(iters, device=key.device)
    k = prng.split(prng.fold_in(key[:, None, :], it[None, :]))  # (S, I, 2, 2)
    toward = prng.uniform(k[..., 0, :]) < ratio                  # (S, I)
    box = prng.uniform(k[..., 1, :], (3,)) * (hi - lo)[:, None] \
        + lo[:, None]
    return torch.where(toward[..., None], goal[:, None], box)


def rrt_plan(occ: OccupancyGrid, start: torch.Tensor, goal: torch.Tensor,
             bounds_lo: torch.Tensor, bounds_hi: torch.Tensor,
             key: torch.Tensor, cfg: RRTConfig = RRTConfig()) -> RRTResult:
    """Goal-biased RRT for S problems: start, goal, bounds_lo, bounds_hi
    (S, 3) (the sampling box), key (S, 2)."""
    S = start.shape[0]
    dev = start.device
    N = cfg.max_iters + 2
    ar = torch.arange(S, device=dev)
    q_rands = rrt_draws(key, cfg.max_iters, cfg.connect_goal_ratio,
                        bounds_lo, bounds_hi, goal)
    nodes = torch.zeros((S, N, 3), dtype=torch.float32, device=dev)
    nodes[:, 0] = start
    parent = torch.full((S, N), -1, dtype=torch.int64, device=dev)
    count = torch.ones((S,), dtype=torch.int64, device=dev)
    done = torch.zeros((S,), dtype=torch.bool, device=dev)
    goal_idx = torch.full((S,), -1, dtype=torch.int64, device=dev)
    slots = torch.arange(N, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    for i in range(cfg.max_iters):
        q_rand = q_rands[:, i]
        d = torch.linalg.vector_norm(nodes - q_rand[:, None], dim=-1)
        d = torch.where(slots < count[:, None], d, inf)
        ni = torch.argmin(d, dim=-1)
        q_near = nodes[ar, ni]
        vec = q_rand - q_near
        dist = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
        q_new = q_near + vec / torch.clamp(dist, min=1e-9) \
            * torch.clamp(dist, max=cfg.incremental_dist)
        ok = _edge_free(occ, q_near, q_new, cfg.edge_checks) \
            & ~occupied_at(occ, q_new) & ~done
        nodes[ar, count] = torch.where(ok[:, None], q_new, nodes[ar, count])
        parent[ar, count] = torch.where(ok, ni, parent[ar, count])
        reached = ok & (torch.linalg.vector_norm(q_new - goal, dim=-1)
                        <= cfg.goal_reach_dist)
        goal_idx = torch.where(reached & ~done, count, goal_idx)
        count = count + ok.to(torch.int64)
        done = done | reached

    # backtrack (fixed depth): the chain goal -> start, then reversed
    L = cfg.max_path_len
    chain = []
    idx = goal_idx
    for _ in range(L):
        chain.append(idx)
        idx = torch.where(idx >= 0, parent[ar, torch.clamp(idx, min=0)],
                          torch.full_like(idx, -1))
    chain = torch.stack(chain, dim=-1)                            # (S, L)
    n_valid = torch.sum(chain >= 0, dim=-1)
    jl = torch.arange(L, device=dev)
    order = n_valid[:, None] - 1 - jl
    src = torch.where(order >= 0,
                      torch.gather(chain, 1, torch.clamp(order, 0, L - 1)),
                      torch.zeros_like(order))
    pts = torch.where((jl < n_valid[:, None])[..., None],
                      torch.gather(nodes, 1, src[..., None].expand(S, L, 3)),
                      goal[:, None])
    pts = torch.where(done[:, None, None], pts, start[:, None])

    pts, n_valid = _shortcut(occ, pts, n_valid, cfg)
    return RRTResult(path=pts,
                     length=torch.where(done, n_valid,
                                        torch.zeros_like(n_valid)
                                        ).to(torch.int32),
                     success=done)


def _shortcut(occ, path: torch.Tensor, n: torch.Tensor, cfg: RRTConfig):
    """String-pulling shortcut (shortcutWaypointPaths): from each anchor,
    jump to the farthest waypoint reachable by a collision-free segment of
    length <= max_shortcut_dist; repeat from there. path (S, L, 3), n (S,)
    valid points. Returns (path, n)."""
    S, L, _ = path.shape
    dev = path.device
    ar = torch.arange(S, device=dev)
    idx = torch.arange(L, device=dev)
    cur = torch.zeros((S,), dtype=torch.int64, device=dev)
    out_n = torch.ones((S,), dtype=torch.int64, device=dev)
    picks = [cur]
    for _ in range(L - 1):
        a = path[ar, cur]
        free = _edge_free(occ, a[:, None].expand(S, L, 3), path,
                          cfg.edge_checks * 2)
        near = torch.linalg.vector_norm(path - a[:, None], dim=-1) \
            <= cfg.max_shortcut_dist
        cand = free & near & (idx > cur[:, None]) & (idx < n[:, None])
        far = torch.amax(torch.where(cand, idx, cur[:, None]), dim=-1)
        nxt = torch.where(torch.any(cand, dim=-1), far,
                          torch.minimum(cur + 1, n - 1))
        at_end = cur >= n - 1
        cur = torch.where(at_end, cur, nxt)
        out_n = out_n + (~at_end).to(torch.int64)
        picks.append(cur)
    picks = torch.clamp(torch.stack(picks, dim=-1), 0, L - 1)
    newp = torch.gather(path, 1, picks[..., None].expand(S, L, 3))
    # entries past out_n repeat the endpoint (the walk clamps at n - 1)
    return newp, torch.minimum(out_n, n)
