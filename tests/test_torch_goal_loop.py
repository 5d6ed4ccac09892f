"""Port parity: the closed loop in goal mode (EngineConfig.goal_mode with
ref_mode "linspace", "minsnap" and "global") per cycle against the JAX
package on the wall world of benchmark/ref_modes.py, and per seed over
whole episodes (slow).

The per-cycle cases start two scenarios (seeds 0 and 2, each with its own
wall and RRT key PRNGKey(1000 + seed)) 1.5 m before the wall with a
committed trajectory straight through it, so three cycles cover the stop
and replan (cycle 0), the build of the composed input trajectory
(cycle 1; linspace solves) and the first solve from the new trajectory
(cycle 2). The min-snap budget is ref_poly_iters 20, as in
tests/test_torch_goal_mode.py (the 400-iteration float32 solve parts by
centimetres from JAX's on these routes; that file's float64 test holds
the algorithm)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.benchmark import ref_modes as jrm
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.utils.config import small_config as jsmall
from intent_mpc_torch.benchmark import ref_modes as trm
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.utils import convert, prng

torch.set_num_threads(1)

SEEDS = (0, 2)
CYCLES = 3
POLY_ITERS = 20
L = trm.WALL_L


def _jax_cfg(mode, timeout=2.0, iters=POLY_ITERS):
    cfg = jsmall(num_obstacles=1, horizon=10, timeout=timeout,
                 max_obstacles=1, hist=12).replace(goal=(8.0, 0.0, 2.0))
    return cfg.replace(engine=dataclasses.replace(
        cfg.engine, goal_mode=True, ref_mode=mode, ref_vel=1.5,
        ref_bounds_margin=2.5, ref_angular_vel=2.0, ref_poly_iters=iters))


def _torch_cfg(mode, timeout=2.0, iters=POLY_ITERS):
    cfg = trm.wall_cfg(mode, timeout)
    return cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                  ref_poly_iters=iters))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(trees):
    return jax.tree.map(lambda *a: jnp.stack(a), *trees)


def _start_carry(jc, H):
    """1.5 m before the wall, holding a committed trajectory through it."""
    pos = jnp.broadcast_to(jnp.asarray([1.5, 0.0, 2.0]), jc.pos.shape)
    line = 1.5 + 0.5 * jnp.arange(H, dtype=jnp.float32)
    ss = jc.planner.states_sol.at[:, :, 0].set(line).at[:, :, 1].set(0.0) \
        .at[:, :, 2].set(2.0)
    yes = jnp.ones_like(jc.traj_ready)
    return jc._replace(
        pos=pos, stop_pos=pos, ref_anchor=pos,
        quad=jc.quad._replace(pos=pos), traj_ready=yes,
        planner=jc.planner._replace(states_sol=ss, has_solution=yes,
                                    first_time=~yes))


def _jax_cycles(mode):
    """The JAX engine's carries before and after each of CYCLES cycles,
    vmapped over the scenarios and their grids."""
    jcfg = _jax_cfg(mode)
    worlds = [jrm.wall_world(s) for s in SEEDS]
    jsc, jg = _stack([w[0] for w in worlds]), _stack([w[1] for w in worlds])
    keys = jnp.stack([jax.random.PRNGKey(1000 + s) for s in SEEDS])
    ref = jnp.zeros((L, 3), jnp.float32)
    jc = jax.vmap(lambda s: jcl.init_carry(jcfg, s, ref_len=L))(jsc)
    step = jax.jit(lambda cc, i: jax.vmap(
        lambda x, s, g, k: jcl.episode_step(jcfg, s, ref, jnp.asarray(L), g,
                                            x, i, ref_key=k))(
        cc, jsc, jg, keys)[0])
    carries = [_start_carry(jc, jcfg.planner.horizon)]
    for i in range(CYCLES):
        carries.append(step(carries[-1], jnp.asarray(i, jnp.int32)))
    return [_np(c) for c in carries]


def _check(tc, jc, msg):
    """pos within 1e-4 m; vel within 5e-4 m/s (at the first solve after
    the reset JAX's own step moves the velocity by 1.3e-4 m/s for a 1e-6 m
    nudge of the position, so rounding-level differences reach ~2e-4);
    the replan, solve and monitor counts, the readiness and the composed
    state equal, the built input trajectory within 1e-3 m."""
    np.testing.assert_allclose(tc.pos.numpy(), jc.pos, atol=1e-4,
                               err_msg=msg + " pos")
    np.testing.assert_allclose(tc.vel.numpy(), jc.vel, atol=5e-4,
                               err_msg=msg + " vel")
    np.testing.assert_allclose(tc.ref_anchor.numpy(), jc.ref_anchor,
                               atol=1e-4, err_msg=msg + " anchor")
    for f in ("stop_replans", "solve_attempts", "solve_successes",
              "traj_collision_cycles"):
        np.testing.assert_array_equal(getattr(tc.metrics, f).numpy(),
                                      getattr(jc.metrics, f),
                                      err_msg=msg + " " + f)
    for f in ("traj_ready", "stopping", "traj_age"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      getattr(jc, f), err_msg=msg + " " + f)
    if jc.ref_len is not None:
        np.testing.assert_array_equal(tc.ref_len.numpy(), jc.ref_len,
                                      err_msg=msg + " ref_len")
        np.testing.assert_array_equal(tc.need_ref.numpy(), jc.need_ref,
                                      err_msg=msg + " need_ref")
        np.testing.assert_allclose(tc.ref_traj.numpy(), jc.ref_traj,
                                   atol=1e-3, err_msg=msg + " ref_traj")


@pytest.mark.parametrize("mode", ["linspace", "minsnap", "global"])
def test_goal_mode_episode_steps_match_jax(mode):
    """Three goal-mode cycles (stop+replan, build, solve) on two wall
    worlds stepped as one batch. Each cycle starts from JAX's carry of
    that cycle and is held to it (_check); the port's own run from the
    same starting carry is held to JAX's positions too (1e-4 m)."""
    jcs = _jax_cycles(mode)
    tcfg = _torch_cfg(mode)
    tsc, tg, _ = trm.wall_batch(SEEDS, "cpu")
    key = prng.prng_key(torch.tensor([1000 + s for s in SEEDS]))
    ref = torch.zeros((L, 3))
    free = convert.carry_from_numpy(jcs[0])
    for i in range(CYCLES):
        tc, _ = tcl.episode_step(tcfg, tsc, ref, L, tg,
                                 convert.carry_from_numpy(jcs[i]), i,
                                 ref_key=key)
        _check(tc, jcs[i + 1], "%s cycle %d" % (mode, i))
        free, _ = tcl.episode_step(tcfg, tsc, ref, L, tg, free, i,
                                   ref_key=key)
        np.testing.assert_allclose(free.pos.numpy(), jcs[i + 1].pos,
                                   atol=1e-4)
    # the cases cover what they say: a stop+replan at cycle 0 and, in the
    # composed modes, a committed build at cycle 1 that no MPC solve used
    assert jcs[1].metrics.stop_replans.tolist() == [1, 1]
    assert not jcs[1].traj_ready.any() and jcs[-1].traj_ready.all()
    if mode != "linspace":
        assert jcs[1].need_ref.all() and not jcs[2].need_ref.any()
        assert (jcs[2].ref_len > 2).all()
        assert jcs[2].metrics.solve_attempts.tolist() == [0, 0]
        assert jcs[3].metrics.solve_attempts.tolist() == [1, 1]


def test_goal_mode_stops_at_an_occupied_goal():
    """goalHasCollision: a goal inside the wall is invalid, the flight
    stops for good at the first cycle and never solves, in both
    packages."""
    jcfg = _jax_cfg("linspace").replace(goal=(4.0, 0.0, 2.0))
    tcfg = _torch_cfg("linspace").replace(goal=(4.0, 0.0, 2.0))
    jsc, jg, _ = jrm.wall_world(0)
    jc = jcl.init_carry(jcfg, jsc, ref_len=L)
    ref = jnp.zeros((L, 3), jnp.float32)
    step = jax.jit(lambda c, i: jcl.episode_step(jcfg, jsc, ref,
                                                 jnp.asarray(L), jg, c, i)[0])
    for i in range(2):
        jc = step(jc, jnp.asarray(i, jnp.int32))
    tsc, tg, _ = trm.wall_batch([0], "cpu")
    tc = tcl.init_carry(tcfg, tsc, device="cpu", ref_len=L)
    for i in range(2):
        tc, _ = tcl.episode_step(tcfg, tsc, torch.zeros((L, 3)), L, tg, tc, i)
    assert bool(tc.stopping[0]) and bool(jc.stopping)
    assert int(tc.metrics.solve_attempts[0]) == int(jc.metrics.solve_attempts)
    np.testing.assert_allclose(tc.pos[0].numpy(), np.asarray(jc.pos),
                               atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["linspace", "global"])
def test_goal_mode_wall_seeds_match_jax(mode):
    """Whole wall-world episodes at the ref_modes script's flags (20 s,
    the full 400-iteration min-snap), seeds 0-3: goal and collision equal
    per seed, the JAX package one seed per episode against the port's one
    batch."""
    seeds = [0, 1, 2, 3]
    jcfg = _jax_cfg(mode, timeout=20.0, iters=400)
    want = []
    for s in seeds:
        jsc, jg, _ = jrm.wall_world(s)
        carry, _ = jcl.run_episode(jcfg, jsc, jnp.zeros((L, 3)),
                                   jnp.asarray(L), occ=jg,
                                   ref_key=jax.random.PRNGKey(1000 + s))
        want.append(jcl.summarize(jcfg, carry))
    tcfg = _torch_cfg(mode, timeout=20.0, iters=400)
    tsc, tg, _ = trm.wall_batch(seeds, "cpu")
    got, _ = trm.run_mode(tcfg, tsc, tg, seeds, L, "cpu")
    for key in ("goal_reached", "collision"):
        assert [r[key] for r in got] == [r[key] for r in want], key
