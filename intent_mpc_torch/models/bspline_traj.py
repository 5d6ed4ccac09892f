"""Gradient-based uniform B-spline trajectory optimization (port of
intent_mpc_tpu/models/bspline_traj.py), batched over a leading scenario
axis S.

Rebuild of trajectory_planner/bsplineTraj (bsplineTraj.cpp): a uniform
cubic B-spline whose control points are optimized with smoothness,
collision, dynamic-obstacle and feasibility terms. The reference's
hand-derived gradients and L-BFGS become `torch.autograd.grad` of the same
cost and Adam steps; the occupancy ESDF (models/mapping.esdf) replaces
guide-point casting, and a batch of trajectories optimizes at once.

Cost terms (bsplineTraj.cpp solver cost assembly):
  * smoothness: squared 3rd-order control-point differences (jerk)
  * static collision: penalty below a clearance threshold of the ESDF
    sampled at control points (trilinear, 1e3 outside the grid)
  * dynamic obstacles: per-(control point, obstacle) ellipsoid clearance
    penalty against the obstacle's position at the control point's time
  * feasibility: velocity/acceleration of the spline derivative control
    points beyond v_max/a_max

The Adam step is optax's (`scale_by_adam` then the learning rate, in
optax's order) as XLA compiles it inside the JAX package's scan: each
moment one FMA, the bias corrections 1 - b^k from b^k rounded once to
float32, the two divisions folded into one (m / (c1 (sqrt(v / c2) + eps))),
the step one FMA. `torch.optim.Adam` orders the step differently.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from intent_mpc_torch.utils.device import constant, f32
from intent_mpc_torch.utils.grid import as_origin
from intent_mpc_torch.utils.rounding import fma, recip32, sqrt32

_M4 = (
    (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0, 0.0),
    (-3.0 / 6.0, 0.0, 3.0 / 6.0, 0.0),
    (3.0 / 6.0, -6.0 / 6.0, 3.0 / 6.0, 0.0),
    (-1.0 / 6.0, 3.0 / 6.0, -3.0 / 6.0, 1.0 / 6.0),
)

# optax.adam's defaults
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class BsplineConfig(NamedTuple):
    dt: float = 0.1
    max_vel: float = 5.0
    max_acc: float = 20.0
    clearance: float = 0.8
    w_smooth: float = 1.0
    w_collision: float = 20.0
    w_dynamic: float = 30.0
    w_feasibility: float = 1.0
    iters: int = 100
    lr: float = 0.15


class BsplineTrajectory(NamedTuple):
    ctrl: torch.Tensor    # (S, M, 3) control points
    dt: float             # knot spacing, seconds
    cost: torch.Tensor    # (S,)


def fit_control_points(path: torch.Tensor) -> torch.Tensor:
    """Control points from waypoint paths (S, L, 3): the waypoints with
    each end tripled, so that the cubic spline interpolates them
    ((Q0 + 4 Q1 + Q2) / 6 = p0 when Q0 = Q1 = Q2 = p0): (S, L + 4, 3)."""
    first = path[:, :1]
    last = path[:, -1:]
    return torch.cat([first, first, path, last, last], dim=1)


def evaluate(traj: BsplineTrajectory, t: torch.Tensor) -> torch.Tensor:
    """Spline positions at times t (S, T), t in [0, (M - 3) dt]: (S, T, 3)."""
    M = traj.ctrl.shape[1]
    dev = traj.ctrl.device
    x = t / f32(traj.dt, dev)
    seg = torch.clamp(torch.floor(x).to(torch.int64), 0, M - 4)
    u = torch.clamp(x - seg, 0.0, 1.0)
    ub = (torch.ones_like(u), u, u * u, u * u * u)
    m4 = constant(_M4, dev)
    idx = seg[..., None] + torch.arange(4, device=dev)       # (S, T, 4)
    S, T = idx.shape[:2]
    pts = torch.gather(traj.ctrl, 1, idx.reshape(S, T * 4, 1).expand(
        S, T * 4, 3)).reshape(S, T, 4, 3)
    # the basis products summed in a fixed order (the same bits on the card
    # and the CPU, where a matrix product's order is the library's)
    out = 0.0
    for j in range(4):
        w = ub[0] * m4[0, j] + ub[1] * m4[1, j] + ub[2] * m4[2, j] \
            + ub[3] * m4[3, j]
        out = out + w[..., None] * pts[..., j, :]
    return out


def esdf_at(esdf_grid: torch.Tensor, origin: torch.Tensor,
            resolution: float, p: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolated ESDF (S, nx, ny, nz) at points p (S, ..., 3),
    1e3 outside the grid's interior cells; differentiable in p, so the
    collision penalty gets spatial gradients."""
    x = (p - origin) * recip32(resolution) - 0.5
    dims = esdf_grid.shape[1:]
    i0 = torch.floor(x).to(torch.int64)
    frac = x - i0.to(x.dtype)
    inside = torch.ones(x.shape[:-1], dtype=torch.bool, device=p.device)
    ic = []
    for a in range(3):
        inside = inside & (i0[..., a] >= 0) & (i0[..., a] < dims[a] - 1)
        ic.append(torch.clamp(i0[..., a], 0, dims[a] - 2))
    S = esdf_grid.shape[0]
    sc = torch.arange(S, device=p.device).reshape((S,) + (1,) * (x.dim() - 2))
    v = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dz else 1 - frac[..., 2]))
                v = v + w * esdf_grid[sc, ic[0] + dx, ic[1] + dy, ic[2] + dz]
    return torch.where(inside, v, f32(1e3, p.device))


def _cost(cfg: BsplineConfig, c: torch.Tensor, esdf, obstacles):
    """The per-scenario cost (S,) of control points c (S, M, 3)."""
    dev = c.device
    jerk = c[:, 3:] - 3 * c[:, 2:-1] + 3 * c[:, 1:-2] - c[:, :-3]
    cost = cfg.w_smooth * torch.sum(jerk ** 2, dim=(1, 2))

    inv_dt = recip32(cfg.dt)
    v = (c[:, 1:] - c[:, :-1]) * inv_dt
    a = (v[:, 1:] - v[:, :-1]) * inv_dt
    cost = cost + cfg.w_feasibility * (
        torch.sum(torch.clamp(torch.abs(v) - cfg.max_vel, min=0.0) ** 2,
                  dim=(1, 2))
        + torch.sum(torch.clamp(torch.abs(a) - cfg.max_acc, min=0.0) ** 2,
                    dim=(1, 2)))

    if esdf is not None:
        grid, origin, res = esdf
        d = esdf_at(grid, origin, res, c)
        pen = torch.clamp(cfg.clearance - d, min=0.0)
        cost = cost + cfg.w_collision * torch.sum(pen ** 2, dim=1)

    if obstacles is not None:
        # control point i is associated with spline time i * dt
        pos, size = obstacles                               # (S, K, P, 3)
        M, P = c.shape[1], pos.shape[2]
        ti = torch.clamp(torch.arange(M, device=dev), max=P - 1)
        op, os_ = pos[:, :, ti], size[:, :, ti]              # (S, K, M, 3)
        dd = (c[:, None] - op) / (os_ * 0.5 + cfg.clearance)
        f = torch.sum(dd ** 2, dim=-1)
        cost = cost + cfg.w_dynamic * torch.sum(
            torch.clamp(1.0 - f, min=0.0) ** 2, dim=(1, 2))
    return cost


def bias_correction(decay: float, count: int) -> float:
    """optax's 1 - decay^count in float32, decay^count rounded once."""
    p = np.float32(np.float64(np.float32(decay)) ** count)
    return float(np.float32(1.0) - p)


def adam_step(lr: float, params: torch.Tensor, grad: torch.Tensor,
              mu: torch.Tensor, nu: torch.Tensor, count: int):
    """One optax.adam(lr) step as XLA compiles it (the count-th, from 1):
    returns (params, mu, nu)."""
    dev = params.device
    mu = fma(f32(1.0 - ADAM_B1, dev), grad, f32(ADAM_B1, dev) * mu)
    nu = fma(f32(1.0 - ADAM_B2, dev), grad * grad, f32(ADAM_B2, dev) * nu)
    c1 = f32(bias_correction(ADAM_B1, count), dev)
    c2 = f32(bias_correction(ADAM_B2, count), dev)
    step = mu / (c1 * (sqrt32(nu / c2) + ADAM_EPS))
    return fma(f32(-lr, dev), step, params), mu, nu


def optimize(cfg: BsplineConfig, init_ctrl: torch.Tensor,
             esdf_grid: Optional[torch.Tensor] = None,
             esdf_origin=None, esdf_resolution: float = 0.15,
             obstacle_pos: Optional[torch.Tensor] = None,
             obstacle_size: Optional[torch.Tensor] = None
             ) -> BsplineTrajectory:
    """Optimize control points init_ctrl (S, M, 3) for `cfg.iters` Adam
    steps. The first and last 3 control points, which pin the start and
    end state of a cubic spline, stay fixed.

    esdf_grid (S, nx, ny, nz) with its origin and resolution: the static
    collision term (optional). obstacle_pos / obstacle_size (S, K, P, 3):
    predicted obstacle series (optional)."""
    dev = init_ctrl.device
    M = init_ctrl.shape[1]
    free_mask = torch.ones((1, M, 1), device=dev)
    free_mask[:, :3] = 0.0
    free_mask[:, -3:] = 0.0
    esdf = None
    if esdf_grid is not None:
        esdf = (esdf_grid, as_origin(esdf_origin, dev), esdf_resolution)
    obstacles = None
    if obstacle_pos is not None:
        obstacles = (obstacle_pos, obstacle_size)

    def pinned(ctrl):
        return init_ctrl + (ctrl - init_ctrl) * free_mask

    ctrl = init_ctrl.detach().clone()
    mu = torch.zeros_like(ctrl)
    nu = torch.zeros_like(ctrl)
    for k in range(1, cfg.iters + 1):
        x = ctrl.detach().requires_grad_(True)
        cost = _cost(cfg, pinned(x), esdf, obstacles)
        (g,) = torch.autograd.grad(cost.sum(), x)
        ctrl, mu, nu = adam_step(cfg.lr, ctrl, g, mu, nu, k)
    ctrl = pinned(ctrl)
    with torch.no_grad():
        cost = _cost(cfg, ctrl, esdf, obstacles)
    return BsplineTrajectory(ctrl=ctrl, dt=cfg.dt, cost=cost)
