"""Quadrotor rigid-body plant: the Gazebo quadcopterPlugin as tensors
(port of intent_mpc_tpu/models/quad_plant.py).

The reference closes its sim loop through a Gazebo model plugin
(uav_simulator/src/quadcopterPlugin.cpp): the tracking controller
publishes world-frame acceleration + yaw commands, and the plugin's
acc-control branch (UpdateDynamics, quadcopterPlugin.cpp:370+) turns them
into a body z-force and body torques through cascaded PIDs, which Gazebo
integrates as a rigid body. `EngineConfig.plant = "quadrotor"` selects
this plant in place of the engine's double integrator.

  * PID with setpoint limit + first-order input filter + wrap-aware yaw
    variant: pidController.cpp:32-105 (with time_constant = 0 the
    filtered-input derivative term is identically zero, as there).
  * acc-control force/torque law: desired body acc = R^T a_cmd;
    pitch_cmd = PID_accXY(des.x)/g, roll_cmd = -PID_accXY(des.y)/g;
    torques from the roll/pitch and yaw-rate PIDs scaled by inertia;
    Fz = m (PID_accZ(des.z) + load_factor g), load_factor = 1/cos(tilt),
    clamped to [0, maxForce].
  * gains and inertia: urdf/quadcopter.urdf:4-63.
  * rigid-body step: semi-implicit Euler with the gyroscopic term
    omega x I omega and quaternion attitude integration; 10 substeps per
    100 Hz control tick give Gazebo's 1 kHz physics rate, and the whole
    cascade re-evaluates every substep, as the plugin does on every
    world update.

Every function takes a leading scenario axis S: vectors are (S, 3),
quaternions (S, 4) as (w, x, y, z) body->world, and each PID state leaf
is (S,). The state lives on the device its tensors lie on.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from intent_mpc_torch.utils.device import constant


class PIDParams(NamedTuple):
    p: float
    d: float = 0.0
    i: float = 0.0
    limit: float = -1.0        # setpoint clamp; <= 0 disables
    time_constant: float = 0.0


class PIDState(NamedTuple):
    input: torch.Tensor   # (S,) filtered setpoint
    dinput: torch.Tensor  # (S,) filtered setpoint derivative
    i_acc: torch.Tensor   # (S,) integral accumulator


def pid_init(batch: int, device="cpu") -> PIDState:
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return PIDState(input=z, dinput=z, i_acc=z)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def pid_update(par: PIDParams, st: PIDState, new_input, x, dx, dt: float,
               is_yaw: bool = False) -> Tuple[torch.Tensor, PIDState]:
    """PIDController::update (pidController.cpp:32-105). Returns (output,
    new state). is_yaw: wrap-aware errors, P-only output. `dx` may be a
    float (the yaw-rate loop passes 0)."""
    if is_yaw:
        new_input = _wrap(torch.where(torch.isnan(new_input),
                                      torch.zeros_like(new_input), new_input))
        dx = _wrap(dx)
        x = _wrap(x)
    if par.limit > 0.0:
        new_input = torch.clamp(new_input, -par.limit, par.limit)
    denom = dt + par.time_constant
    inp = (dt * new_input + par.time_constant * st.input) / denom
    if is_yaw:
        inp = _wrap(inp * denom) / denom  # the reference wraps the numerator
    dinp = (new_input - inp) / denom
    if is_yaw:
        dinp = _wrap(new_input - inp) / denom
        p = _wrap(inp - x)
        i_acc = _wrap(st.i_acc + dt * p)
        out = par.p * p  # the yaw-angle controller is P-only (:95)
    else:
        p = inp - x
        d = dinp - dx
        i_acc = st.i_acc + dt * p
        out = par.p * p + par.d * d + par.i * i_acc
    return out, PIDState(input=inp, dinput=dinp, i_acc=i_acc)


class QuadPlantConfig(NamedTuple):
    """quadcopter.urdf:4-63 values."""
    mass: float = 1.54
    inertia: Tuple[float, float, float] = (0.1152, 0.1152, 0.218)
    gravity: float = 9.8
    max_force: float = 60.0
    substeps: int = 10
    acc_xy: PIDParams = PIDParams(p=15.0)
    acc_z: PIDParams = PIDParams(p=0.5)
    rollpitch: PIDParams = PIDParams(p=10.0, d=5.0, limit=1.0)
    yaw_rate: PIDParams = PIDParams(p=1.5, d=1.0, limit=1.5)
    yaw_angle: PIDParams = PIDParams(p=3.0, limit=3.15)


class QuadState(NamedTuple):
    pos: torch.Tensor           # (S, 3) world
    vel: torch.Tensor           # (S, 3) world
    quat: torch.Tensor          # (S, 4) w,x,y,z body->world
    omega: torch.Tensor         # (S, 3) body angular velocity
    prev_vel: torch.Tensor      # (S, 3) world vel at the last physics step
    prev_body_acc: torch.Tensor  # (S, 3)
    pid_acc_x: PIDState
    pid_acc_y: PIDState
    pid_acc_z: PIDState
    pid_roll: PIDState
    pid_pitch: PIDState
    pid_yaw: PIDState
    pid_yaw_angle: PIDState


def quad_init(pos: torch.Tensor, vel=None, yaw: float = 0.0) -> QuadState:
    """Hover state at pos (S, 3), heading `yaw` (a float), at rest unless
    vel (S, 3) is given."""
    S, dev = pos.shape[0], pos.device
    kw = dict(dtype=torch.float32, device=dev)
    pos = pos.to(torch.float32)
    vel = torch.zeros((S, 3), **kw) if vel is None else vel.to(torch.float32)
    half = torch.tensor(0.5 * yaw, dtype=torch.float32)
    q = torch.stack([torch.cos(half), torch.zeros(()), torch.zeros(()),
                     torch.sin(half)]).to(dev)
    return QuadState(
        pos=pos, vel=vel, quat=q.expand(S, 4).contiguous(),
        omega=torch.zeros((S, 3), **kw), prev_vel=vel,
        prev_body_acc=torch.zeros((S, 3), **kw),
        pid_acc_x=pid_init(S, dev), pid_acc_y=pid_init(S, dev),
        pid_acc_z=pid_init(S, dev), pid_roll=pid_init(S, dev),
        pid_pitch=pid_init(S, dev), pid_yaw=pid_init(S, dev),
        pid_yaw_angle=pid_init(S, dev))


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_to_euler(q: torch.Tensor):
    """ZYX (roll about x, pitch about y, yaw about z), the ignition
    Quaternion::Euler convention the plugin uses. Returns three (...)."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sp = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sp)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def _mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v for (..., 3, 3) and (..., 3)."""
    return torch.matmul(R, v[..., None])[..., 0]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _cascade_substep(cfg: QuadPlantConfig, st: QuadState,
                     acc_cmd: torch.Tensor, yaw_cmd: torch.Tensor,
                     h: float) -> QuadState:
    """One physics step: the whole PID cascade + rigid-body integration at
    step h, the plugin's Update() granularity (it runs on every Gazebo
    world update, quadcopterPlugin.cpp:334-350, at max_step_size 0.001)."""
    g = cfg.gravity
    m = cfg.mass
    dev = st.pos.device
    inertia = constant(cfg.inertia, dev)
    gw = constant((0.0, 0.0, -g), dev)
    R = _quat_to_mat(st.quat)
    Rt = R.transpose(-1, -2)
    roll, pitch, yaw = quat_to_euler(st.quat)

    # FD world acceleration over the last physics step (plugin :382-384)
    acc_world = (st.vel - st.prev_vel) / h
    body_acc = _mv(Rt, acc_world)
    accchange = body_acc - st.prev_body_acc

    # load factor = 1 / cos(tilt) (plugin "Get gravity" block), guarded
    # near-inverted as the JAX version is (the benchmark never tilts there)
    cos_tilt = torch.sum(gw * _mv(R, gw.expand_as(st.pos)), dim=-1) / (g * g)
    load_factor = 1.0 / torch.clamp(cos_tilt, min=0.2)

    # yaw-angle -> yaw-rate setpoint (P-only, wrapped)
    yaw_rate_sp, pid_yaw_angle = pid_update(
        cfg.yaw_angle, st.pid_yaw_angle, yaw_cmd, yaw, yaw_cmd - yaw, h,
        is_yaw=True)

    des_body = _mv(Rt, acc_cmd)
    pitch_cmd, pid_acc_x = pid_update(cfg.acc_xy, st.pid_acc_x,
                                      des_body[:, 0], body_acc[:, 0],
                                      accchange[:, 0], h)
    roll_cmd, pid_acc_y = pid_update(cfg.acc_xy, st.pid_acc_y,
                                     des_body[:, 1], body_acc[:, 1],
                                     accchange[:, 1], h)
    pitch_cmd = pitch_cmd / g
    roll_cmd = -roll_cmd / g

    tq_x, pid_roll = pid_update(cfg.rollpitch, st.pid_roll, roll_cmd,
                                roll, st.omega[:, 0], h)
    tq_y, pid_pitch = pid_update(cfg.rollpitch, st.pid_pitch, pitch_cmd,
                                 pitch, st.omega[:, 1], h)
    fz_pid, pid_acc_z = pid_update(cfg.acc_z, st.pid_acc_z, des_body[:, 2],
                                   body_acc[:, 2], accchange[:, 2], h)
    tq_z, pid_yaw = pid_update(cfg.yaw_rate, st.pid_yaw, yaw_rate_sp,
                               st.omega[:, 2], 0.0, h)
    tq_z = torch.where(torch.isnan(tq_z), torch.zeros_like(tq_z), tq_z)

    torque = inertia * torch.stack([tq_x, tq_y, tq_z], dim=-1)
    fz = torch.clamp(m * (fz_pid + load_factor * g), 0.0, cfg.max_force)

    pos, vel, quat, omega = _rigid_step(cfg, st, fz, torque, h)
    return QuadState(
        pos=pos, vel=vel, quat=quat, omega=omega,
        prev_vel=st.vel, prev_body_acc=body_acc,
        pid_acc_x=pid_acc_x, pid_acc_y=pid_acc_y, pid_acc_z=pid_acc_z,
        pid_roll=pid_roll, pid_pitch=pid_pitch, pid_yaw=pid_yaw,
        pid_yaw_angle=pid_yaw_angle)


def quad_step(cfg: QuadPlantConfig, st: QuadState, acc_cmd: torch.Tensor,
              yaw_cmd: torch.Tensor, dt: float) -> QuadState:
    """One 100 Hz control tick: the held (acc_cmd (S, 3), yaw_cmd (S,))
    command drives `substeps` full cascade + integration physics steps."""
    h = dt / cfg.substeps
    for _ in range(cfg.substeps):
        st = _cascade_substep(cfg, st, acc_cmd, yaw_cmd, h)
    return st


def _rigid_step(cfg: QuadPlantConfig, st: QuadState, fz: torch.Tensor,
                torque: torch.Tensor, h: float):
    """One rigid-body physics step (the Gazebo ODE step): semi-implicit
    Euler with the gyroscopic term and quaternion attitude."""
    dev = st.pos.device
    inertia = constant(cfg.inertia, dev)
    gw = constant((0.0, 0.0, -cfg.gravity), dev)
    quat, omega = st.quat, st.omega
    Rk = _quat_to_mat(quat)
    zf = torch.zeros_like(fz)
    a = _mv(Rk, torch.stack([zf, zf, fz], dim=-1)) / cfg.mass + gw
    vel = st.vel + a * h
    pos = st.pos + vel * h
    omega_dot = (torque - _cross(omega, inertia * omega)) / inertia
    omega = omega + omega_dot * h
    dq = _quat_mul(quat, torch.cat([torch.zeros_like(omega[:, :1]), omega],
                                   dim=-1))
    quat = quat + 0.5 * dq * h
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    return pos, vel, quat, omega


def _integrate(cfg: QuadPlantConfig, st: QuadState, fz, torque, dt: float):
    """Substepped rigid-body integration with force and torque held over
    the control tick (the body-rate branch's plant)."""
    h = dt / cfg.substeps
    cur = st
    for _ in range(cfg.substeps):
        pos, vel, quat, omega = _rigid_step(cfg, cur, fz, torque, h)
        cur = cur._replace(pos=pos, vel=vel, quat=quat, omega=omega)
    return cur.pos, cur.vel, cur.quat, cur.omega


def quad_step_bodyrate(cfg: QuadPlantConfig, st: QuadState,
                       rate_sp: torch.Tensor, thrust_pct: torch.Tensor,
                       hover_thrust, dt: float,
                       rate_p: float = 20.0) -> QuadState:
    """One control tick consuming the tracking controller's body-rate
    output (controller.body_rate_command: rates (S, 3) + thrust percent
    (S,), trackingController.cpp:525-550). The inner rate loop, PX4's on
    the vehicle, is a rate P-loop here; thrust percent maps through the
    hover calibration: Fz = pct * m g / hover."""
    inertia = constant(cfg.inertia, st.pos.device)
    torque = inertia * rate_p * (rate_sp - st.omega)
    fz = torch.clamp(thrust_pct, 0.0, 1.0) \
        * (cfg.mass * cfg.gravity / hover_thrust)
    fz = torch.clamp(fz, 0.0, cfg.max_force)
    # FD bookkeeping as in the acc branch
    acc_world = (st.vel - st.prev_vel) / dt
    body_acc = _mv(_quat_to_mat(st.quat).transpose(-1, -2), acc_world)
    pos, vel, quat, omega = _integrate(cfg, st, fz, torque, dt)
    return st._replace(pos=pos, vel=vel, quat=quat, omega=omega,
                       prev_vel=st.vel, prev_body_acc=body_acc)
