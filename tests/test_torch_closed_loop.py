"""Port parity: the closed loop (intent_mpc_torch.engine.closed_loop) per
cycle against the JAX package on the `__graft_entry__` config, and per seed on
the production DYNUS config (slow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_setup
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.parallel import sharding as jsh
from intent_mpc_tpu.utils.config import IntentMPCConfig as JConfig
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as tsh
from intent_mpc_torch.utils import convert
from intent_mpc_torch.utils.config import IntentMPCConfig, small_config

torch.set_num_threads(1)


def _tiny_torch_config():
    """The port's copy of __graft_entry__._tiny_setup's config."""
    return small_config(num_obstacles=4, horizon=8, timeout=0.5,
                        max_obstacles=4, hist=8).replace(goal=(6.0, 0.0, 2.0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's jitted episode_step, compiled once per module."""
    jcfg, sc, ref = _tiny_setup()
    L = jnp.asarray(ref.shape[0])
    step = jax.jit(lambda s, c, i: jcl.episode_step(jcfg, s, ref, L, jempty(),
                                                    c, i))
    jax.block_until_ready(step(sc, jcl.init_carry(jcfg, sc),
                               jnp.asarray(0, jnp.int32)))
    return jcfg, ref, step


def _compare_carry(tc, jcs, cycle):
    """pos/vel atol 1e-4 per cycle (30 float32 ADMM iterations a cycle on a
    problem whose iterates the two packages round differently); the
    metric counters must be equal."""
    tn = convert.carry_to_numpy(tc)
    for s, jc in enumerate(jcs):
        np.testing.assert_allclose(tn.pos[s], np.asarray(jc.pos), atol=1e-4,
                                   err_msg="pos, cycle %d" % cycle)
        np.testing.assert_allclose(tn.vel[s], np.asarray(jc.vel), atol=1e-4,
                                   err_msg="vel, cycle %d" % cycle)
        for f in ("solve_attempts", "solve_successes", "samples",
                  "jerk_samples", "vel_violations", "acc_violations",
                  "jerk_violations", "collision_count",
                  "traj_collision_cycles", "goal_reached", "collision"):
            assert getattr(tn.metrics, f)[s] == np.asarray(
                getattr(jc.metrics, f)), (f, cycle)
        assert tn.traj_age[s] == np.asarray(jc.traj_age)
        assert tn.traj_ready[s] == np.asarray(jc.traj_ready)


@pytest.mark.parametrize("seeds", [(0,), (0, 1)], ids=["one", "batched"])
def test_episode_steps_match_jax(jax_step, seeds):
    """3 cycles of episode_step from identical carries: one scenario, and
    two scenarios stepped as one batch."""
    jcfg, ref, step = jax_step
    tcfg = _tiny_torch_config()
    jscs = [jworld.generate_scenario(s, jcfg.world) for s in seeds]
    jcs = [jcl.init_carry(jcfg, s) for s in jscs]
    tsc = convert.scenario_from_numpy(
        _np(jax.tree.map(lambda *a: jnp.stack(a), *jscs)))
    tc = convert.carry_from_numpy(
        _np(jax.tree.map(lambda *a: jnp.stack(a), *jcs)))
    tref = torch.as_tensor(np.array(ref))
    for i in range(3):
        jcs = [step(s, c, jnp.asarray(i, jnp.int32))[0]
               for s, c in zip(jscs, jcs)]
        tc, _ = tcl.episode_step(tcfg, tsc, tref, int(ref.shape[0]),
                                 empty_grid(), tc, i)
        _compare_carry(tc, jcs, i)


def test_init_carry_matches_jax():
    """The port's fresh carry equals the JAX package's, leaf by leaf."""
    jcfg, sc, _ = _tiny_setup()
    jc = _np(jcl.init_carry(jcfg, sc))
    tc = convert.carry_to_numpy(tcl.init_carry(
        _tiny_torch_config(), convert.scenario_from_numpy(
            _np(sc), add_batch_axis=True), device="cpu"))
    for f in tcl.EngineCarry._fields:
        a, b = getattr(jc, f), getattr(tc, f)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(
                tuple(b) if isinstance(b, tuple) else b)):
            np.testing.assert_array_equal(np.asarray(y)[0], x, err_msg=f)


def test_run_episode_and_summary_on_cpu():
    """run_episode / batch_rollout / summarize through the public entry
    points on two scenarios."""
    cfg = _tiny_torch_config()
    scen = tsh.stack_scenarios(cfg, [0, 1], device="cpu")
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    carry, path = tcl.run_episode(cfg, scen, ref, ref.shape[0], num_cycles=4,
                                  record_path=True, device="cpu")
    assert path.shape == (2, 4, 3)
    summ = tcl.summarize(cfg, carry)
    assert len(summ) == 2 and all(s["mpc_solve_count"] == 4 for s in summ)
    metrics, agg = tsh.batch_rollout(cfg, scen, ref, ref.shape[0],
                                     num_cycles=4, device="cpu")
    assert agg["episodes"] == 2.0 and agg["solve_attempts"] == 8.0
    assert tsh.aggregate_summary(agg)["num_episodes"] == 2


@pytest.mark.slow
def test_dynus_seeds_success_and_collision_match_jax():
    """Whole DYNUS episodes on seeds 0-7 at the production config: each
    seed must end with the same success and collision outcome in both
    packages (per-cycle states are not compared: the 100-iteration ADMM
    iterate of the infeasible QPs amplifies rounding, see
    intent_mpc_torch/benchmark/sensitivity.py)."""
    seeds = list(range(8))
    jcfg = JConfig()
    jref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, 2.5)
    jscen = jsh.stack_scenarios(jcfg, seeds)
    jm, _ = jsh.batch_rollout(jcfg, jscen, jref, jnp.asarray(jref.shape[0]))
    cfg = IntentMPCConfig()
    tscen = tsh.stack_scenarios(cfg, seeds, device="cpu")
    tref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5)
    tm, _ = tsh.batch_rollout(cfg, tscen, tref, tref.shape[0], device="cpu")
    np.testing.assert_array_equal(tm.goal_reached.numpy(),
                                  np.asarray(jm.goal_reached))
    np.testing.assert_array_equal(tm.collision.numpy(),
                                  np.asarray(jm.collision))
