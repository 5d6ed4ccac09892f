"""Tracking controller: cascaded PID -> commanded acceleration, and the
attitude / body-rate output modes with the hover-thrust estimator (port
of intent_mpc_tpu/models/controller.py).

Reference: tracking_controller trackingController.cpp:426-523
(computeAttitudeAndAccRef) + :411-423 (publishCommand): accRef =
accTarget + PID(posErr) + PID(velErr) + g, published as accRef - g. The
closed loop flies the acceleration mode; the attitude and body-rate
modes (:500-550) and the thrust estimator (:279-370) feed PX4 on the
vehicle and `models/quad_plant.quad_step_bodyrate` here. Every function
takes any leading batch axes.
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


# ---------------------------------------------------------------------------
# Attitude / body-rate output modes + hover-thrust estimation
# (trackingController.cpp:500-550, :279-370)
# ---------------------------------------------------------------------------

GRAVITY = 9.8


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def acc_to_attitude(acc_ref_world: torch.Tensor, yaw: torch.Tensor
                    ) -> torch.Tensor:
    """Desired attitude quaternion (..., 4) as (w, x, y, z) from the total
    reference acceleration (..., 3), gravity included, and a heading (...)
    (computeAttitudeAndAccRef :500-513): body z along accRef, body x
    toward the heading projected onto the plane."""
    z_d = acc_ref_world / torch.clamp(_norm(acc_ref_world), min=1e-9)
    heading = torch.stack([torch.cos(yaw), torch.sin(yaw),
                           torch.zeros_like(yaw)], dim=-1)
    y_d = _cross(z_d, heading)
    y_d = y_d / torch.clamp(_norm(y_d), min=1e-9)
    x_d = _cross(y_d, z_d)
    x_d = x_d / torch.clamp(_norm(x_d), min=1e-9)
    return rot_to_quat(torch.stack([x_d, y_d, z_d], dim=-1))


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) (w, x, y, z),
    stable enough for the near-hover attitudes the controller commands."""
    w = 0.5 * torch.sqrt(torch.clamp(
        1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], min=1e-9))
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    return torch.stack([w, x, y, z], dim=-1)


def quat_mult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def body_rate_command(curr_quat: torch.Tensor, ref_quat: torch.Tensor,
                      acc_ref_world: torch.Tensor, hover_thrust,
                      attitude_tau: float = 0.3) -> torch.Tensor:
    """Body rates + thrust percent (computeBodyRate :525-550):
    rate = (2/tau) sign(q_err_w) q_err_vec; thrust = |accRef| scaled by
    the hover thrust. Returns (..., 4): (wx, wy, wz, thrust_pct)."""
    inv = curr_quat * constant((1.0, -1.0, -1.0, -1.0), curr_quat.device)
    qe = quat_mult(inv, ref_quat)
    s = torch.sign(qe[..., 0]) + (qe[..., 0] == 0).to(qe.dtype)
    rates = (2.0 / attitude_tau) * s[..., None] * qe[..., 1:4]
    thrust = _norm(acc_ref_world)
    pct = torch.clamp(thrust / (GRAVITY / hover_thrust), 0.0, 1.0)
    return torch.cat([rates, pct], dim=-1)


class ThrustEstimator(NamedTuple):
    """Scalar hover-thrust Kalman filter per batch entry (thrustEstimateCB
    :279-370)."""
    hover_thrust: torch.Tensor
    var: torch.Tensor


def init_thrust_estimator(hover_thrust: float = 0.7, var: float = 0.05,
                          batch=(), device="cpu") -> ThrustEstimator:
    kw = dict(dtype=torch.float32, device=device)
    return ThrustEstimator(hover_thrust=torch.full(tuple(batch), hover_thrust,
                                                   **kw),
                           var=torch.full(tuple(batch), var, **kw))


def thrust_estimate_step(est: ThrustEstimator, cmd_thrust, world_acc_z,
                         process_var: float = 1e-6,
                         measure_var: float = 0.3) -> ThrustEstimator:
    """One estimator step: z = a_z - g; H = -cmd g / hover^2."""
    h = est.hover_thrust
    var = est.var + process_var
    H = -(cmd_thrust * GRAVITY) / (h * h)
    z = world_acc_z - GRAVITY
    innov_var = torch.clamp(H * var * H + measure_var, min=measure_var)
    K = var * H / innov_var
    innov = z - (cmd_thrust / h - 1.0) * GRAVITY
    new_h = h + K * innov
    new_var = (1.0 - K * H) * var
    ok = (new_h > 0.0) & (new_h < 1.0)
    return ThrustEstimator(hover_thrust=torch.where(ok, new_h, h),
                           var=new_var)
