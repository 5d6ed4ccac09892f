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

RRT* (rrtStarOctomap.h) runs the same draws and adds choose-parent over a
radius neighbourhood and one-step rewiring, with `cost_sweeps` rounds of
cost refresh after growth. The PRM (PRMKDTree.cpp / PRMAstar.h) samples a
fixed node set, builds the (S, N, N) radius graph with edge collision
checks, runs min-plus relaxations from the start and descends greedily
from the goal. The grid wavefront (astarOcc.cpp's role) is 6-connected
min-plus value iteration on a voxel grid; like the JAX package's it shifts
with a roll, so its cost wraps around the grid's faces.

The planners take either map backend through `occupied_at`: an
OccupancyGrid (rrtOccMap) or an OctoMap of models/octo.py (rrtOctomap, with
unknown-space semantics).

Config mirrors global_planner yaml: incremental_distance 0.5,
goal_reach_distance 0.4, connect_goal_ratio 0.2, max_shortcut_dist 3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intent_mpc_torch.models.occupancy import OccupancyGrid, is_occupied
from intent_mpc_torch.models.octo import OctoMap, is_blocked
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.device import f32
from intent_mpc_torch.utils.rounding import fma


def occupied_at(m, p: torch.Tensor) -> torch.Tensor:
    """Point-collision dispatch of the planners: p (S, ..., 3) -> bool
    (S, ...) against an OccupancyGrid (shared, or one per scenario; the
    rrtOccMap backend) or an OctoMap (the rrtOctomap / rrtStarOctomap
    backend with unknown-space semantics)."""
    if isinstance(m, OctoMap):
        return is_blocked(m, p)
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


def _chain_path(chain: torch.Tensor, n_valid: torch.Tensor,
                nodes: torch.Tensor, start: torch.Tensor, goal: torch.Tensor,
                ok: torch.Tensor) -> torch.Tensor:
    """The path start..goal of a node chain stored goal -> start: chain
    (S, L) node indices with n_valid (S,) live entries, reversed into
    start-first order and padded with the goal; the start repeated where
    ok is False."""
    S, L = chain.shape
    jl = torch.arange(L, device=chain.device)
    order = n_valid[:, None] - 1 - jl
    src = torch.where(order >= 0,
                      torch.gather(chain, 1, torch.clamp(order, 0, L - 1)),
                      torch.zeros_like(order))
    pts = torch.where((jl < n_valid[:, None])[..., None],
                      torch.gather(nodes, 1, src[..., None].expand(S, L, 3)),
                      goal[:, None])
    return torch.where(ok[:, None, None], pts, start[:, None])


def _backtrack(parent: torch.Tensor, goal_idx: torch.Tensor, L: int):
    """The parent chain from goal_idx (S,) for a fixed depth L: (S, L)
    node indices, -1 past the root; and its live count (S,)."""
    ar = torch.arange(parent.shape[0], device=parent.device)
    chain, idx = [], goal_idx
    for _ in range(L):
        chain.append(idx)
        idx = torch.where(idx >= 0, parent[ar, torch.clamp(idx, min=0)],
                          torch.full_like(idx, -1))
    chain = torch.stack(chain, dim=-1)
    return chain, torch.sum(chain >= 0, dim=-1)


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
    chain, n_valid = _backtrack(parent, goal_idx, cfg.max_path_len)
    pts = _chain_path(chain, n_valid, nodes, start, goal, done)

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


class RRTStarConfig(NamedTuple):
    max_iters: int = 512
    incremental_dist: float = 0.5
    goal_reach_dist: float = 0.4
    connect_goal_ratio: float = 0.2
    edge_checks: int = 8
    max_path_len: int = 64
    neighborhood_radius: float = 1.0   # rrtStarOctomap.h rNeighborhood
    cost_sweeps: int = 64              # parent-chain cost refresh depth


def rrt_star_plan(occ, start: torch.Tensor, goal: torch.Tensor,
                  bounds_lo: torch.Tensor, bounds_hi: torch.Tensor,
                  key: torch.Tensor,
                  cfg: RRTStarConfig = RRTStarConfig()) -> RRTResult:
    """RRT* (rrtStarOctomap.h:1-347 redesigned) for S problems: start,
    goal, bounds_lo, bounds_hi (S, 3), key (S, 2). Goal-biased sampling
    (the RRT's draws) with choose-parent over the free in-radius
    neighbours, rewiring of the neighbours whose path through the new node
    is cheaper in one step, and `cost_sweeps` rounds of cost[i] =
    cost[parent[i]] + |edge| after growth (exact once sweeps >= tree
    depth). The path ends at the cheapest goal-reaching node; it is the
    start repeated where none reached the goal."""
    S = start.shape[0]
    dev = start.device
    N = cfg.max_iters + 2
    ar = torch.arange(S, device=dev)
    q_rands = rrt_draws(key, cfg.max_iters, cfg.connect_goal_ratio,
                        bounds_lo, bounds_hi, goal)
    nodes = torch.zeros((S, N, 3), dtype=torch.float32, device=dev)
    nodes[:, 0] = start
    parent = torch.full((S, N), -1, dtype=torch.int64, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    cost = torch.full((S, N), float("inf"), device=dev)
    cost[:, 0] = 0.0
    count = torch.ones((S,), dtype=torch.int64, device=dev)
    slots = torch.arange(N, device=dev)
    for i in range(cfg.max_iters):
        q_rand = q_rands[:, i]
        mask = slots < count[:, None]
        d = torch.linalg.vector_norm(nodes - q_rand[:, None], dim=-1)
        ni = torch.argmin(torch.where(mask, d, inf), dim=-1)
        q_near = nodes[ar, ni]
        vec = q_rand - q_near
        dist = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
        q_new = q_near + vec / torch.clamp(dist, min=1e-9) \
            * torch.clamp(dist, max=cfg.incremental_dist)
        free_new = ~occupied_at(occ, q_new)

        # choose-parent: min cost-through over free in-radius neighbours
        # (the nearest node is always in radius: the steer caps the step at
        # incremental_dist <= neighborhood_radius)
        dn = torch.linalg.vector_norm(nodes - q_new[:, None], dim=-1)
        near = mask & (dn <= cfg.neighborhood_radius)
        efree = _edge_free(occ, nodes, q_new[:, None].expand(S, N, 3),
                           cfg.edge_checks)
        cand = near & efree
        through = torch.where(cand, cost + dn, inf)
        pi = torch.argmin(through, dim=-1)
        best = through[ar, pi]
        have_parent = torch.isfinite(best)
        pi = torch.where(have_parent, pi, ni)
        new_cost = torch.where(have_parent, best, cost[ar, ni] + dist[:, 0])
        ok = free_new & have_parent

        nodes[ar, count] = torch.where(ok[:, None], q_new, nodes[ar, count])
        parent[ar, count] = torch.where(ok, pi, parent[ar, count])
        cost[ar, count] = torch.where(ok, new_cost, cost[ar, count])

        # rewire: neighbours whose path through q_new is cheaper
        via = new_cost[:, None] + dn
        better = cand & (via < cost) & (slots != pi[:, None]) & ok[:, None]
        parent = torch.where(better, count[:, None], parent)
        cost = torch.where(better, via, cost)
        count = count + ok.to(torch.int64)

    # refresh descendant costs invalidated by rewiring
    pc = torch.clamp(parent, 0, N - 1)
    dpar = torch.linalg.vector_norm(
        nodes - torch.gather(nodes, 1, pc[..., None].expand(S, N, 3)), dim=-1)
    root = slots == 0
    for _ in range(cfg.cost_sweeps):
        cp = torch.where(parent >= 0, torch.gather(cost, 1, pc) + dpar, cost)
        cost = torch.where(root, torch.zeros_like(cp), cp)

    # best goal-reaching node (min total cost), not first-reaching
    mask = slots < count[:, None]
    near_goal = mask & (torch.linalg.vector_norm(nodes - goal[:, None], dim=-1)
                        <= cfg.goal_reach_dist)
    total = torch.where(near_goal, cost, inf)
    goal_idx = torch.argmin(total, dim=-1)
    done = torch.isfinite(total[ar, goal_idx])
    goal_idx = torch.where(done, goal_idx, torch.full_like(goal_idx, -1))

    chain, n_valid = _backtrack(parent, goal_idx, cfg.max_path_len)
    pts = _chain_path(chain, n_valid, nodes, start, goal, done)
    return RRTResult(path=pts,
                     length=torch.where(done, n_valid,
                                        torch.zeros_like(n_valid)
                                        ).to(torch.int32),
                     success=done)


# ---------------------------------------------------------------------------
# PRM roadmap + min-plus shortest path
# ---------------------------------------------------------------------------

class PRMConfig(NamedTuple):
    num_samples: int = 256
    connect_radius: float = 2.0
    edge_checks: int = 8
    relax_iters: int = 64
    max_path_len: int = 64


def prm_plan(occ, start: torch.Tensor, goal: torch.Tensor,
             bounds_lo: torch.Tensor, bounds_hi: torch.Tensor,
             key: torch.Tensor, cfg: PRMConfig = PRMConfig()) -> RRTResult:
    """Probabilistic roadmap for S problems (start, goal, bounds (S, 3),
    key (S, 2)): batch-sample nodes, the radius graph with edge collision
    checks, `relax_iters` min-plus relaxations from the start, and a
    greedy descent from the goal (ties to the first node)."""
    S = start.shape[0]
    dev = start.device
    lo, hi = bounds_lo, bounds_hi
    samples = prng.uniform(key, (cfg.num_samples, 3)) * (hi - lo)[:, None] \
        + lo[:, None]
    nodes = torch.cat([start[:, None], goal[:, None], samples], dim=1)
    M = nodes.shape[1]
    free = ~occupied_at(occ, nodes)
    inf = torch.full((), float("inf"), device=dev)

    d = torch.linalg.vector_norm(nodes[:, :, None] - nodes[:, None], dim=-1)
    within = (d <= cfg.connect_radius) & (d > 1e-6)
    ef = _edge_free(occ, nodes[:, :, None].expand(S, M, M, 3),
                    nodes[:, None].expand(S, M, M, 3), cfg.edge_checks)
    adj = within & ef & free[:, :, None] & free[:, None, :]
    w = torch.where(adj, d, inf)

    dist = torch.full((S, M), float("inf"), device=dev)
    dist[:, 0] = 0.0
    for _ in range(cfg.relax_iters):
        dist = torch.minimum(dist, torch.amin(dist[:, :, None] + w, dim=1))
    success = torch.isfinite(dist[:, 1])

    # greedy descent from goal to start over dist
    L = cfg.max_path_len
    ar = torch.arange(S, device=dev)
    idx = torch.ones((S,), dtype=torch.int64, device=dev)
    chain = []
    for _ in range(L):
        chain.append(idx)
        nbr_cost = torch.where(adj[ar, idx], dist + w[ar, idx], inf)
        nxt = torch.argmin(nbr_cost, dim=-1)
        better = nbr_cost[ar, nxt] < dist[ar, idx] + 1e-6
        idx = torch.where((idx == 0) | ~better, idx, nxt)
    chain = torch.stack(chain, dim=-1)                            # (S, L)
    valid = torch.cat([torch.ones((S, 1), dtype=torch.bool, device=dev),
                       chain[:, 1:] != chain[:, :-1]], dim=-1)
    n_valid = torch.sum(valid, dim=-1)
    pts = _chain_path(chain, n_valid, nodes, start, goal, success)
    return RRTResult(path=pts,
                     length=torch.where(success, n_valid,
                                        torch.zeros_like(n_valid)
                                        ).to(torch.int32),
                     success=success)


def grid_wavefront(occ_grid: torch.Tensor, goal_idx: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """Value iteration on voxel grids occ_grid (S, nx, ny, nz): the
    cost-to-go (S, nx, ny, nz) from each grid's goal voxel goal_idx (S, 3)
    with 6-connected unit steps, 1e9 where unreached or blocked; descend it
    greedily for a path (astarOcc's guide path).

    The neighbours come from a roll, as in the JAX package's
    `grid_wavefront`: the cost wraps around the grid's faces."""
    S = occ_grid.shape[0]
    dev = occ_grid.device
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    cost = torch.full(occ_grid.shape, 1e9, dtype=torch.float32, device=dev)
    ar = torch.arange(S, device=dev)
    cost[ar, goal_idx[:, 0], goal_idx[:, 1], goal_idx[:, 2]] = f32(0.0, dev)
    blocked = occ_grid > 0
    for _ in range(iters):
        best = cost
        for ax in (1, 2, 3):
            best = torch.minimum(best, torch.roll(cost, 1, dims=ax) + 1.0)
            best = torch.minimum(best, torch.roll(cost, -1, dims=ax) + 1.0)
        best = torch.where(blocked, big, best)
        cost = torch.minimum(cost, best)
    return cost
