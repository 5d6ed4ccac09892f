"""Ground-truth detector: history ring buffers + finite-difference state
(port of intent_mpc_tpu/models/detector.py).

Reference: onboardDetector::fakeDetector (onboard_detector/fakeDetector.cpp).
  * fd_update: velocity = (pos - last_pos)/dT, acceleration =
    (vel - last_vel)/dT, refreshed when dT >= fd_period (stateCB :176-209)
  * hist_push: ring-buffer unshift, newest at index 0 (histCB :337-347)
  * query: robot-size inflation of sizes, z-velocity zeroed, 2D range gate
    (getDynamicObstaclesHist :525-553, isObstacleInSensorRange :482-500)

Every tensor may carry leading scenario axes (...) before the obstacle
axis O; scalars of the JAX version become (...)-shaped tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from intent_mpc_torch.utils.config import DetectorConfig
from intent_mpc_torch.utils.device import constant


class DetectorState(NamedTuple):
    pos_hist: torch.Tensor    # (..., O, Hh, 3) newest at index 0
    vel_hist: torch.Tensor    # (..., O, Hh, 3)
    acc_hist: torch.Tensor    # (..., O, Hh, 3)
    hist_len: torch.Tensor    # (...) int32
    last_pos: torch.Tensor    # (..., O, 3) position at last FD update
    vel: torch.Tensor         # (..., O, 3) currently-published FD velocity
    acc: torch.Tensor         # (..., O, 3)
    last_fd_time: torch.Tensor  # (...)


def init_detector(num_obstacles: int, cfg: DetectorConfig,
                  pos0: torch.Tensor) -> DetectorState:
    """pos0 (..., O, 3) obstacle positions at t = 0."""
    lead = pos0.shape[:-2]
    O, Hh = num_obstacles, cfg.history_size
    kw = dict(dtype=torch.float32, device=pos0.device)
    return DetectorState(
        pos_hist=torch.zeros(lead + (O, Hh, 3), **kw),
        vel_hist=torch.zeros(lead + (O, Hh, 3), **kw),
        acc_hist=torch.zeros(lead + (O, Hh, 3), **kw),
        hist_len=torch.zeros(lead, dtype=torch.int32, device=pos0.device),
        last_pos=pos0,
        vel=torch.zeros(lead + (O, 3), **kw),
        acc=torch.zeros(lead + (O, 3), **kw),
        last_fd_time=torch.zeros(lead, **kw),
    )


def fd_update(cfg: DetectorConfig, st: DetectorState, pos_now: torch.Tensor,
              t) -> DetectorState:
    """Finite-difference velocity/acceleration when dT >= fd_period."""
    dT = t - st.last_fd_time                          # (...)
    due = (dT >= cfg.fd_period - 1e-9)[..., None, None]
    safe_dT = torch.clamp(dT, min=1e-9)[..., None, None]
    vel_new = (pos_now - st.last_pos) / safe_dT
    acc_new = (vel_new - st.vel) / safe_dT
    t_b = torch.as_tensor(t, dtype=st.last_fd_time.dtype,
                          device=st.last_fd_time.device)
    return st._replace(
        vel=torch.where(due, vel_new, st.vel),
        acc=torch.where(due, acc_new, st.acc),
        last_pos=torch.where(due, pos_now, st.last_pos),
        last_fd_time=torch.where(due[..., 0, 0], t_b, st.last_fd_time),
    )


def _push(hist: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    return torch.cat([row[..., None, :], hist[..., :-1, :]], dim=-2)


def hist_push(st: DetectorState, pos_now: torch.Tensor) -> DetectorState:
    """Unshift the current snapshot into the ring buffers."""
    Hh = st.pos_hist.shape[-2]
    return st._replace(
        pos_hist=_push(st.pos_hist, pos_now),
        vel_hist=_push(st.vel_hist, st.vel),
        acc_hist=_push(st.acc_hist, st.acc),
        hist_len=torch.clamp(st.hist_len + 1, max=Hh),
    )


def query_history(cfg: DetectorConfig, st: DetectorState, bbox: torch.Tensor,
                  robot_pos: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    """getDynamicObstaclesHist: histories + robot-inflated sizes + range mask.

    bbox (..., O, 3); robot_pos (..., 3). Returns (pos, vel, acc, size,
    hist_len (..., O), visible (..., O))."""
    shape = st.pos_hist.shape
    O, Hh = shape[-3], shape[-2]
    robot = constant(tuple(cfg.robot_size), bbox.device, bbox.dtype)
    size = (bbox[..., None, :] + robot).expand(shape)

    def zero_z(h):
        return torch.cat([h[..., 0:2], torch.zeros_like(h[..., 2:3])], dim=-1)

    vel = zero_z(st.vel_hist)
    acc = zero_z(st.acc_hist)
    d2 = torch.linalg.vector_norm(
        st.pos_hist[..., 0, 0:2] - robot_pos[..., None, 0:2], dim=-1)
    visible = (d2 <= cfg.sensor_range) & (st.hist_len > 0)[..., None]
    hist_len = st.hist_len[..., None].expand(shape[:-3] + (O,))
    return st.pos_hist, vel, acc, size, hist_len, visible
