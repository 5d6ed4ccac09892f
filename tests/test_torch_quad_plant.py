"""Port parity: the quadrotor rigid-body plant (models/quad_plant.py) and
the controller's attitude / body-rate / thrust-estimator modes against
the JAX package, on numpy-seeded inputs, per tick and over 100 ticks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import controller as jctl
from intent_mpc_tpu.models import quad_plant as jqp
from intent_mpc_torch.models import controller as tctl
from intent_mpc_torch.models import quad_plant as tqp

torch.set_num_threads(1)

S = 16
CFG_J = jqp.QuadPlantConfig()
CFG_T = tqp.QuadPlantConfig()


def _rng(seed):
    return np.random.default_rng(seed)


def _unit_quats(rng, tilt=0.3):
    """Seeded attitudes within `tilt` rad of level, any heading."""
    yaw = rng.uniform(-np.pi, np.pi, S)
    axis = rng.normal(size=(S, 3)) * np.array([1.0, 1.0, 0.0])
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(0.0, tilt, S)
    qt = np.concatenate([np.cos(ang / 2)[:, None],
                         np.sin(ang / 2)[:, None] * axis], axis=-1)
    qy = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    w1, x1, y1, z1 = qy.T
    w2, x2, y2, z2 = qt.T
    q = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                  w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                  w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)
    return q.astype(np.float32)


def _pid_np(rng):
    return [rng.normal(size=S).astype(np.float32) for _ in range(3)]


def _state_np(seed):
    """A perturbed flying state: attitude, rates, velocities, FD history
    and PID memories all nonzero."""
    rng = _rng(seed)
    f = np.float32
    return dict(
        pos=rng.normal(size=(S, 3)).astype(f) * 5,
        vel=rng.normal(size=(S, 3)).astype(f),
        quat=_unit_quats(rng),
        omega=rng.normal(size=(S, 3)).astype(f) * 0.3,
        prev_vel=rng.normal(size=(S, 3)).astype(f),
        prev_body_acc=rng.normal(size=(S, 3)).astype(f),
        pids=[_pid_np(rng) for _ in range(7)])


def _jstate(d):
    pids = [jqp.PIDState(*(jnp.asarray(a) for a in p)) for p in d["pids"]]
    return jqp.QuadState(*(jnp.asarray(d[k]) for k in
                           ("pos", "vel", "quat", "omega", "prev_vel",
                            "prev_body_acc")), *pids)


def _tstate(d):
    pids = [tqp.PIDState(*(torch.as_tensor(a) for a in p))
            for p in d["pids"]]
    return tqp.QuadState(*(torch.as_tensor(d[k]) for k in
                           ("pos", "vel", "quat", "omega", "prev_vel",
                            "prev_body_acc")), *pids)


# the filtered setpoint derivative of a PID with time_constant 0: a
# difference of float32 ulps over the 1 ms physics step (see
# test_pid_update_matches_jax), rounding noise in both packages
DINPUT_TOL = 2e-3


def _assert_state(t, j, atol, rtol=0.0, what=""):
    """Every leaf of the port's QuadState against the vmapped JAX one;
    each PID's dinput leaf within DINPUT_TOL."""
    from intent_mpc_torch.engine.checkpoint import flatten
    jl = jax.tree.leaves(j)
    tl = flatten(t)
    assert len(jl) == len(tl) == 6 + 7 * 3
    for i, (a, b) in enumerate(zip(tl, jl)):
        dinput = i >= 6 and (i - 6) % 3 == 1
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=DINPUT_TOL if dinput else atol,
                                   rtol=rtol, err_msg="%s leaf %d" % (what, i))


@pytest.mark.parametrize("is_yaw", [False, True], ids=["plain", "yaw"])
@pytest.mark.parametrize("par", [tqp.PIDParams(p=15.0),
                                 tqp.PIDParams(p=10.0, d=5.0, limit=1.0),
                                 tqp.PIDParams(p=1.5, d=1.0, i=0.3,
                                               limit=1.5,
                                               time_constant=0.02)],
                         ids=["p", "pd_limit", "pid_filtered"])
def test_pid_update_matches_jax(par, is_yaw):
    """One PIDController::update on 16 seeded setpoints, states and
    measurements (angles up to +-6 rad for the wrap-aware yaw variant, and
    a NaN setpoint there), within 1e-6 relative + 1e-6 absolute; the
    setpoint derivative, and the output where d > 0, within 2e-3: with
    time_constant 0 the derivative is (setpoint - filtered setpoint) / dt,
    a difference of a few float32 ulps (the two packages' sin/cos in the
    wrap round apart) over dt = 1e-3, 2.4e-4 per ulp of a setpoint near
    2."""
    rng = _rng(3)
    scale = 6.0 if is_yaw else 2.0
    new_in, x, dx = (rng.normal(size=S).astype(np.float32) * scale
                     for _ in range(3))
    if is_yaw:
        new_in[0] = np.nan
    st = _pid_np(rng)
    jpar = jqp.PIDParams(*par)
    jout, jst = jax.vmap(lambda s, a, b, c: jqp.pid_update(
        jpar, jqp.PIDState(*s), a, b, c, 0.001, is_yaw=is_yaw))(
        tuple(jnp.asarray(a) for a in st), new_in, x, dx)
    tout, tst = tqp.pid_update(par, tqp.PIDState(*map(torch.as_tensor, st)),
                               torch.as_tensor(new_in), torch.as_tensor(x),
                               torch.as_tensor(dx), 0.001, is_yaw=is_yaw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=DINPUT_TOL if par.d > 0 else 1e-6)
    for f, a, b in zip(tst._fields, tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=DINPUT_TOL if f == "dinput" else 1e-6,
                                   err_msg=f)


def _commands(rng):
    acc = (rng.normal(size=(S, 3)) * 2.0).astype(np.float32)
    yaw = rng.uniform(-3.0, 3.0, S).astype(np.float32)
    return acc, yaw


@pytest.mark.parametrize("seed", [0, 1])
def test_quad_step_one_tick_matches_jax(seed):
    """One 100 Hz tick (10 cascade substeps) from a perturbed flying state
    under seeded acceleration and yaw commands: every state leaf within
    2e-5 relative + 2e-5 absolute (the quaternion, trig and 3x3 products
    round differently in XLA and ATen), each PID's dinput within
    DINPUT_TOL."""
    d = _state_np(seed)
    acc, yaw = _commands(_rng(seed + 100))
    j = jax.vmap(lambda s, a, y: jqp.quad_step(CFG_J, s, a, y, 0.01))(
        _jstate(d), acc, yaw)
    t = tqp.quad_step(CFG_T, _tstate(d), torch.as_tensor(acc),
                      torch.as_tensor(yaw), 0.01)
    _assert_state(t, j, atol=2e-5, rtol=2e-5, what="quad_step")


def test_quad_step_hundred_ticks_matches_jax():
    """100 ticks (1 s, 1000 physics steps) from hover at the engine's start
    state, flying a seeded smooth acceleration and heading profile: the
    position within 1e-3 m, the velocity within 1e-3 m/s, the attitude
    within 1e-3 (rounding accumulates over the cascade's feedback)."""
    rng = _rng(7)
    amp = (rng.normal(size=(S, 3)) * 1.5).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (S, 3)).astype(np.float32)
    yaw_rate = rng.uniform(-1.0, 1.0, S).astype(np.float32)
    start = np.tile(np.array([0.0, 0.0, 2.0], np.float32), (S, 1))
    jst = jax.vmap(jqp.quad_init)(jnp.asarray(start))
    tst = tqp.quad_init(torch.as_tensor(start))
    jstep = jax.jit(jax.vmap(lambda s, a, y: jqp.quad_step(
        CFG_J, s, a, y, 0.01)))
    for k in range(100):
        t = np.float32(k * 0.01)
        acc = (amp * np.sin(2.0 * t + phase)).astype(np.float32)
        yaw = (yaw_rate * t).astype(np.float32)
        jst = jstep(jst, acc, yaw)
        tst = tqp.quad_step(CFG_T, tst, torch.as_tensor(acc),
                            torch.as_tensor(yaw), 0.01)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=1e-3)
    np.testing.assert_allclose(tst.vel.numpy(), np.asarray(jst.vel),
                               atol=1e-3)
    np.testing.assert_allclose(tst.quat.numpy(), np.asarray(jst.quat),
                               atol=1e-3)
    assert np.abs(np.asarray(jst.pos) - start).max() > 0.05  # it flew


@pytest.mark.parametrize("ticks", [1, 100])
def test_quad_step_bodyrate_matches_jax(ticks):
    """The body-rate branch (held force and torque over 10 rigid substeps)
    from a perturbed state under seeded rate and thrust commands: after
    one tick within 2e-5, after 100 within 1e-3."""
    d = _state_np(11)
    rng = _rng(12)
    rate = (rng.normal(size=(S, 3)) * 0.5).astype(np.float32)
    pct = rng.uniform(0.5, 0.9, S).astype(np.float32)
    jst, tst = _jstate(d), _tstate(d)
    jstep = jax.jit(jax.vmap(lambda s, r, p: jqp.quad_step_bodyrate(
        CFG_J, s, r, p, 0.7, 0.01)))
    for _ in range(ticks):
        jst = jstep(jst, rate, pct)
        tst = tqp.quad_step_bodyrate(CFG_T, tst, torch.as_tensor(rate),
                                     torch.as_tensor(pct), 0.7, 0.01)
    tol = 2e-5 if ticks == 1 else 1e-3
    _assert_state(tst, jst, atol=tol, rtol=tol, what="bodyrate")


def test_quat_to_euler_matches_jax():
    q = _unit_quats(_rng(5), tilt=1.2)
    j = jax.vmap(jqp.quat_to_euler)(jnp.asarray(q))
    t = tqp.quat_to_euler(torch.as_tensor(q))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_controller_attitude_modes_match_jax():
    """acc_to_attitude, rot_to_quat (through it), quat_mult and
    body_rate_command on seeded reference accelerations (gravity
    included), headings and current attitudes, within 1e-6 (the rates,
    which carry a 2/tau = 6.7 gain, within 1e-5)."""
    rng = _rng(21)
    acc = (rng.normal(size=(S, 3)) * 2.0 + np.array([0.0, 0.0, 9.8])
           ).astype(np.float32)
    yaw = rng.uniform(-3.0, 3.0, S).astype(np.float32)
    cur = _unit_quats(rng)
    jref = jax.vmap(jctl.acc_to_attitude)(jnp.asarray(acc), jnp.asarray(yaw))
    tref = tctl.acc_to_attitude(torch.as_tensor(acc), torch.as_tensor(yaw))
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), atol=1e-6)
    jm = jax.vmap(jctl.quat_mult)(jnp.asarray(cur), jref)
    tm = tctl.quat_mult(torch.as_tensor(cur), tref)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    jb = jax.vmap(lambda c, r, a: jctl.body_rate_command(c, r, a, 0.7))(
        jnp.asarray(cur), jref, jnp.asarray(acc))
    tb = tctl.body_rate_command(torch.as_tensor(cur), tref,
                                torch.as_tensor(acc), 0.7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)


def test_thrust_estimator_matches_jax():
    """100 steps of the hover-thrust Kalman filter on seeded commanded
    thrust and measured vertical acceleration, within 1e-5."""
    rng = _rng(31)
    cmd = rng.uniform(0.5, 0.9, (100, S)).astype(np.float32)
    az = (9.8 + rng.normal(size=(100, S))).astype(np.float32)
    je = jax.vmap(lambda _: jctl.init_thrust_estimator())(jnp.arange(S))
    te = tctl.init_thrust_estimator(batch=(S,))
    jstep = jax.jit(jax.vmap(jctl.thrust_estimate_step))
    for k in range(100):
        je = jstep(je, cmd[k], az[k])
        te = tctl.thrust_estimate_step(te, torch.as_tensor(cmd[k]),
                                       torch.as_tensor(az[k]))
    np.testing.assert_allclose(te.hover_thrust.numpy(),
                               np.asarray(je.hover_thrust), atol=1e-5)
    np.testing.assert_allclose(te.var.numpy(), np.asarray(je.var), atol=1e-5)
