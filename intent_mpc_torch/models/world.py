"""DYNUS-style seeded obstacle world as tensors (port of
intent_mpc_tpu/models/world.py).

Obstacle kinematics are closed-form trefoil knots, so the world state at
any time `t` is one vectorized expression over (S scenarios, N obstacles).
Scenario generation reproduces the reference's std::mt19937 draw sequence
in float64 numpy and casts to float32 at the end, so seed N gives the
same arrays bit for bit as the JAX package and the reference benchmark.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from intent_mpc_torch.utils.config import WorldConfig
from intent_mpc_torch.utils.rng import MT19937


class Scenario(NamedTuple):
    """Static obstacle parameters, (..., N) or (..., N, 3) with optional
    leading scenario axes (dynus_obstacles_node.cpp:92-148)."""

    origin: torch.Tensor      # (..., N, 3) x0, y0, z0
    scale: torch.Tensor       # (..., N, 3) sx, sy, sz (0 for static)
    offset: torch.Tensor      # (..., N)   trefoil phase offset
    slower: torch.Tensor      # (..., N)   time dilation (0 for static)
    bbox: torch.Tensor        # (..., N, 3) obstacle bounding-box size
    is_static: torch.Tensor   # (..., N)   bool


def generate_scenario_numpy(seed: int, cfg: WorldConfig) -> dict:
    """Seeded world generation (dynus_obstacles_node.cpp:73-152) as numpy
    arrays in the scenario's final dtypes.

    Draw order per obstacle: x, y, z uniforms always; dynamic obstacles
    additionally draw sx, sy, sz, offset, slower.
    """
    rng = MT19937(seed)
    n = cfg.num_obstacles
    num_dynamic = int(n * cfg.dynamic_ratio)
    num_static = n - num_dynamic

    origin = np.zeros((n, 3))
    scale = np.zeros((n, 3))
    offset = np.zeros(n)
    slower = np.zeros(n)
    bbox = np.zeros((n, 3))
    is_static = np.zeros(n, dtype=bool)

    for i in range(n):
        static = i >= num_dynamic
        x = rng.uniform(*cfg.x_range)
        y = rng.uniform(*cfg.y_range)
        z = rng.uniform(*cfg.z_range)
        if static:
            static_idx = i - num_dynamic
            is_vertical = static_idx < (num_static * cfg.percentage_vert)
            if is_vertical:
                bbox[i] = cfg.bbox_static_vert
                z = cfg.bbox_static_vert[2] / 2.0  # pillar sits on the ground
            else:
                bbox[i] = cfg.bbox_static_horiz
            origin[i] = (x, y, z)
            is_static[i] = True
        else:
            bbox[i] = cfg.bbox_dynamic
            origin[i] = (x, y, z)
            scale[i, 0] = rng.uniform(*cfg.scale_range)
            scale[i, 1] = rng.uniform(*cfg.scale_range)
            scale[i, 2] = rng.uniform(*cfg.scale_range)
            offset[i] = rng.uniform(*cfg.offset_range)
            slower[i] = rng.uniform(*cfg.slower_range)

    f32 = np.float32
    return dict(origin=origin.astype(f32), scale=scale.astype(f32),
                offset=offset.astype(f32), slower=slower.astype(f32),
                bbox=bbox.astype(f32), is_static=is_static)


def generate_scenario(seed: int, cfg: WorldConfig, device="cpu") -> Scenario:
    """One seeded scenario as tensors on `device`."""
    arrs = generate_scenario_numpy(seed, cfg)
    return Scenario(**{k: torch.as_tensor(v, device=device)
                       for k, v in arrs.items()})


def obstacle_state(sc: Scenario, t) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form obstacle positions/velocities at time t.

    Trefoil knot (dynus_obstacles_node.cpp:5-26):
      x = (sx/6)(sin tt + 2 sin 2tt) + x0
      y = (sy/5)(cos tt - 2 cos 2tt) + y0
      z = (sz/2)(-sin 3tt) + z0,  tt = t/slower + offset

    t is a float32 tensor broadcastable against the scenario's leading
    axes plus the obstacle axis (a 0-dim tensor for one shared time).
    Returns (pos (..., N, 3), vel (..., N, 3)); static obstacles hold
    their origin with zero velocity.
    """
    safe_slower = torch.where(sc.is_static, torch.ones_like(sc.slower),
                              sc.slower)
    tt = t / safe_slower + sc.offset
    sx, sy, sz = sc.scale[..., 0], sc.scale[..., 1], sc.scale[..., 2]

    px = (sx / 6.0) * (torch.sin(tt) + 2.0 * torch.sin(2.0 * tt)) + sc.origin[..., 0]
    py = (sy / 5.0) * (torch.cos(tt) - 2.0 * torch.cos(2.0 * tt)) + sc.origin[..., 1]
    pz = (sz / 2.0) * (-torch.sin(3.0 * tt)) + sc.origin[..., 2]

    inv = 1.0 / safe_slower
    vx = (sx / 6.0) * inv * (torch.cos(tt) + 4.0 * torch.cos(2.0 * tt))
    vy = (sy / 5.0) * inv * (-torch.sin(tt) + 4.0 * torch.sin(2.0 * tt))
    vz = -(3.0 * sz / 2.0) * inv * torch.cos(3.0 * tt)

    pos = torch.stack([px, py, pz], dim=-1)
    vel = torch.stack([vx, vy, vz], dim=-1)
    static = sc.is_static[..., None]
    pos = torch.where(static, sc.origin, pos)
    vel = torch.where(static, torch.zeros_like(vel), vel)
    return pos, vel


def straight_line_ref_traj(start, goal, spacing: float = 2.5,
                           device="cpu") -> torch.Tensor:
    """Reference trajectory matching ref_trajectory_dynus_benchmark.txt:
    waypoints every `spacing` meters from start to goal. The reference
    MPC's updatePath treats consecutive waypoints as ts=0.1 s apart
    (mpcNavigation.cpp:229-231), so the reference acts as a fast-moving
    carrot; the port reproduces that protocol."""
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    dist = float(np.linalg.norm(goal - start))
    n = max(2, int(np.ceil(dist / spacing - 1e-9)) + 1)
    alphas = np.linspace(0.0, 1.0, n)[:, None]
    pts = start[None, :] * (1 - alphas) + goal[None, :] * alphas
    return torch.as_tensor(pts.astype(np.float32), device=device)
