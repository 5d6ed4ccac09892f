"""Tracking controller: cascaded PID -> commanded acceleration (port of
the acceleration mode of intent_mpc_tpu/models/controller.py).

Reference: tracking_controller trackingController.cpp:426-523
(computeAttitudeAndAccRef) + :411-423 (publishCommand): accRef =
accTarget + PID(posErr) + PID(velErr) + g, published as accRef - g.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from intent_mpc_torch.utils.config import ControlConfig
from intent_mpc_torch.utils.device import constant


class ControllerState(NamedTuple):
    pos_err_int: torch.Tensor   # (..., 3)
    vel_err_int: torch.Tensor   # (..., 3)
    prev_pos_err: torch.Tensor  # (..., 3)
    prev_vel_err: torch.Tensor  # (..., 3)
    first: torch.Tensor         # (...) bool


def init_controller(batch=(), device="cpu") -> ControllerState:
    z = torch.zeros(tuple(batch) + (3,), dtype=torch.float32, device=device)
    return ControllerState(z, z, z, z,
                           torch.ones(tuple(batch), dtype=torch.bool,
                                      device=device))


def acc_command(cfg: ControlConfig, st: ControllerState,
                pos: torch.Tensor, vel: torch.Tensor,
                target_pos: torch.Tensor, target_vel: torch.Tensor,
                target_acc: torch.Tensor, dt: float
                ) -> Tuple[torch.Tensor, ControllerState]:
    """One 100 Hz control step; returns commanded world-frame acceleration."""
    pos_err = target_pos - pos
    vel_err = target_vel - vel
    pos_int = st.pos_err_int + dt * pos_err
    vel_int = st.vel_err_int + dt * vel_err
    first = st.first[..., None]
    zero = torch.zeros_like(pos_err)
    d_pos = torch.where(first, zero, (pos_err - st.prev_pos_err) / dt)
    d_vel = torch.where(first, zero, (vel_err - st.prev_vel_err) / dt)

    def gain(v):
        return constant(tuple(v), pos.device, pos.dtype)

    feedback = (gain(cfg.position_p) * pos_err + gain(cfg.position_i) * pos_int
                + gain(cfg.position_d) * d_pos
                + gain(cfg.velocity_p) * vel_err + gain(cfg.velocity_i) * vel_int
                + gain(cfg.velocity_d) * d_vel)
    acc_cmd = target_acc + feedback   # gravity added then re-subtracted (:497,:418)

    new = ControllerState(pos_err_int=pos_int, vel_err_int=vel_int,
                          prev_pos_err=pos_err, prev_vel_err=vel_err,
                          first=torch.zeros_like(st.first))
    return acc_cmd, new
