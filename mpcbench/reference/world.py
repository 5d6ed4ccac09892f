"""World clock and obstacle motion.

The simulation clock is float32 by the configuration's definition (the
engine's cycle time t0 = f32(cycle) * f32(0.1), tick times added in
float32), so the times are formed in float32 exactly as defined and
everything computed from them is float64 (or the precision asked for).
"""

from __future__ import annotations

import numpy as np
import torch


def f32(x) -> np.float32:
    return np.float32(x)


def cycle_time(cfg: dict, cycle: int) -> np.float32:
    e = cfg["engine"]
    cycle_dt = e["control_dt"] * e["ticks_per_cycle"]
    return f32(f32(float(cycle)) * f32(cycle_dt))


def tick_time(cfg: dict, t0: np.float32, k: int) -> np.float32:
    """The start of control tick k of a cycle (t0 + k dt in float32)."""
    return f32(t0 + f32(k * cfg["engine"]["control_dt"]))


def tick_end(cfg: dict, t0: np.float32, k: int) -> np.float32:
    return f32(tick_time(cfg, t0, k) + f32(cfg["engine"]["control_dt"]))


def obstacle_state(sc: dict, t: float):
    """Trefoil positions and velocities at time t (dynus_obstacles_node
    trefoil: x = sx/6 (sin tt + 2 sin 2tt) + x0, y = sy/5 (cos tt - 2 cos
    2tt) + y0, z = -sz/2 sin 3tt + z0, tt = t / slower + offset); static
    obstacles hold their origin. sc holds (S, N, ...) tensors."""
    static = sc["is_static"]
    slower = torch.where(static, torch.ones_like(sc["slower"]), sc["slower"])
    tt = t / slower + sc["offset"]
    sx, sy, sz = sc["scale"][..., 0], sc["scale"][..., 1], sc["scale"][..., 2]
    o = sc["origin"]
    pos = torch.stack([
        sx / 6.0 * (torch.sin(tt) + 2.0 * torch.sin(2.0 * tt)) + o[..., 0],
        sy / 5.0 * (torch.cos(tt) - 2.0 * torch.cos(2.0 * tt)) + o[..., 1],
        -sz / 2.0 * torch.sin(3.0 * tt) + o[..., 2]], dim=-1)
    return torch.where(static[..., None], o, pos)
