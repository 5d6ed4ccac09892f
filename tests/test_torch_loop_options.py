"""Port parity: the closed loop's flight and solver options (the rigid-body
quadrotor plant, goal relax, the camera-FOV rows, the constant-obstacle
MPC, the stale predictor history, perfect tracking, path repetition, the
monitor off, the velocity-heading yaw, the flat iteration, stationary
refinement, the drift-aware factor refresh), per cycle against the JAX
package on the `__graft_entry__` config from identical carries; and the
solver's remaining unported options."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_setup
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.ops import pallas_fused as jpf
from intent_mpc_tpu.ops import qp as jqp
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.ops import fleet as tfl
from intent_mpc_torch.ops import qp as tqp
from intent_mpc_torch.utils import convert
from intent_mpc_torch.utils.config import IntentMPCConfig, small_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(ROOT)

# Each case: engine and solver fields, and how its starting carry differs
# from init_carry's (the same change on both packages' carry). "stall":
# goal relax starts scenario 0 past the grace (40 cycles stalled, so the
# anneal is live) and scenario 1 at 0, with a radius and speed that count
# both as stalled on the tiny map. "near_goal": path repetition starts
# 0.1 m from the goal after 5 s of tracking, so the first cycle's goal
# stop re-tracks the path. The drift threshold splits the scenarios at
# cycle 2: one refreshes its factor early and the other reuses it
# (test_drift_refresh_decides_per_scenario). The constant-obstacle case
# factors each QP on its own and refines once, as the per-candidate case
# of tests/test_torch_solver_options.py does: at refine_iters 0 the
# x-update is Minv rhs alone and carries each package's float32 factor
# rounding into x (1.9e-4 m/s at cycle 0). The stationary case (2 steps,
# the harness's --refine-mode stationary) is held to 1e-4 + 1e-4 |x|:
# its recurrence does not settle within its steps on the constrained
# cycles (the velocity after cycle 2 reads 4.42, 3.00 and 3.93 m/s at 2,
# 3 and 6 steps), so the shared factor's rounding reaches x; the packages
# read 1.1e-4 m/s apart at 4.4 m/s (2.5e-5 relative) at cycle 2.
DRIFT_T = 0.018
OPTIONS = {
    "quadrotor": dict(engine=dict(plant="quadrotor")),
    "quadrotor_fused": dict(engine=dict(plant="quadrotor"),
                            solver=dict(fused_solve=True)),
    "goal_relax": dict(engine=dict(goal_relax=True, goal_relax_radius=10.0,
                                   goal_relax_speed=5.0), carry="stall"),
    "use_fov": dict(engine=dict(use_fov=True)),
    "use_fov_fused": dict(engine=dict(use_fov=True),
                          solver=dict(fused_solve=True)),
    "no_predictor": dict(engine=dict(use_predictor=False),
                         solver=dict(refine_iters=1)),
    "predictor_stale": dict(engine=dict(predictor_stale_hist=True)),
    "perfect_tracking": dict(engine=dict(perfect_tracking=True)),
    "repeat_path": dict(engine=dict(repeat_path=2), carry="near_goal"),
    "no_replan_check": dict(engine=dict(replan_check=False)),
    "velocity_yaw": dict(engine=dict(yaw_lookahead=0.0, use_fov=True)),
    "flat_iter": dict(solver=dict(flat_iter=True)),
    "stationary": dict(solver=dict(shared_refine_mode="stationary"),
                       rtol=1e-4),
    "drift_refresh": dict(solver=dict(factor_drift_refresh=DRIFT_T)),
}
SEEDS = (0, 1)
SHIFT = 30.0
CYCLES = 3
RECORD = ("pos", "vel", "yaw", "succ", "hits", "repeats", "stall", "quat")


def with_options(cfg, engine=None, solver=None):
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 **(engine or {})))
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                **(solver or {}))))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _start_carry(jc, kind, goal):
    """The case's starting carry from the stacked JAX init_carry."""
    if kind == "stall":
        return jc._replace(stall_cycles=jnp.asarray([40, 0], jnp.int32))
    if kind == "near_goal":
        pos = jnp.broadcast_to(jnp.asarray(goal) - jnp.asarray([0.1, 0, 0]),
                               jc.pos.shape)
        return jc._replace(pos=pos, stop_pos=pos,
                           tracking_start=jnp.full_like(jc.tracking_start,
                                                        -5.0))
    return jc


def _jax_setup(case):
    """The JAX config, stacked scenarios, reference and starting carry."""
    opt = OPTIONS[case]
    jcfg, _, ref = _tiny_setup()
    jcfg = with_options(jcfg, opt.get("engine"), opt.get("solver"))
    jsc = jax.tree.map(lambda *a: jnp.stack(a),
                       *[jworld.generate_scenario(s, jcfg.world)
                         for s in SEEDS])
    # the obstacles 30 m closer to the start: within sensor range, so the
    # QPs carry obstacle rows from cycle 1 on (seed 0 has one 2.3 m ahead)
    jsc = jsc._replace(origin=jsc.origin - jnp.asarray([SHIFT, 0.0, 0.0]))
    jc = jax.vmap(lambda s: jcl.init_carry(jcfg, s))(jsc)
    return jcfg, jsc, ref, _start_carry(jc, opt.get("carry"), jcfg.goal)


def _record(rec, c):
    for k, v in (("pos", c.pos), ("vel", c.vel), ("yaw", c.yaw),
                 ("succ", c.metrics.solve_successes),
                 ("hits", c.metrics.traj_collision_cycles),
                 ("repeats", c.repeats_left),
                 ("stall", (c.stall_cycles if c.stall_cycles is not None
                            else c.repeats_left * 0)),
                 ("quat", c.quad.quat)):
        rec[k].append(np.asarray(v))


def _jax_cycles(case, out):
    """CYCLES cycles of the JAX engine, vmapped over the scenarios (the
    fused cases reach the fleet kernel, in interpret mode on the CPU)."""
    jcfg, jsc, ref, jc = _jax_setup(case)
    L = jnp.asarray(ref.shape[0])
    occ = jempty()
    step = jax.jit(lambda cc, i: jax.vmap(lambda x, s: jcl.episode_step(
        jcfg, s, ref, L, occ, x, i))(cc, jsc)[0])
    rec = {k: [] for k in RECORD}
    for i in range(CYCLES):
        jc = step(jc, jnp.asarray(i, jnp.int32))
        _record(rec, jc)
    np.savez(out, **{k: np.stack(v) for k, v in rec.items()})


def _torch_setup(case):
    jcfg, jsc, ref, jc = _jax_setup(case)
    opt = OPTIONS[case]
    tcfg = with_options(small_config(num_obstacles=4, horizon=8, timeout=0.5,
                                     max_obstacles=4, hist=8).replace(
        goal=(6.0, 0.0, 2.0)), opt.get("engine"), opt.get("solver"))
    return (tcfg, convert.scenario_from_numpy(_np(jsc)),
            torch.as_tensor(np.array(ref)), convert.carry_from_numpy(_np(jc)))


# the cases of this file's parity test; the solver options' cases run in
# tests/test_torch_loop_solver_options.py (the two files spread the child
# interpreters over test workers)
SOLVER_CASES = ("flat_iter", "stationary", "drift_refresh")
ENGINE_CASES = tuple(c for c in OPTIONS if c not in SOLVER_CASES)


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_option_episode_steps_match_jax(case, tmp_path):
    check_case(case, tmp_path)


def check_case(case, tmp_path):
    """3 cycles of episode_step on two scenarios from identical carries:
    the JAX engine vmapped over them (in a child interpreter per case, as
    tests/test_torch_solver_options.py runs it) against the port stepping
    the same batch. Per cycle: positions and velocities within 1e-4 m
    (m/s), as tests/test_torch_closed_loop.py holds the default path
    (stationary refinement: 1e-4 + 1e-4 |x|, see OPTIONS); the yaw and
    the rigid body's attitude within 1e-4; the solve counts, the
    monitor's hits, the path repetitions left and the goal-relax stall
    counts equal.

    use_fov_fused pins a JAX quirk the port keeps: the fleet solve packs
    only the obstacle rows' lower bounds (pallas_fused.py:249, in the port
    ops/fleet.py pack_fleet), so the FOV row a1 x + b1 y <= c1 (lower
    bound -inf) is inert there (test_fused_fov_upper_bound_is_inert)."""
    out = str(tmp_path / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, os.path.abspath(__file__), case, out],
                   check=True, env=env, cwd=ROOT, timeout=600)
    want = np.load(out)
    tcfg, tsc, tref, tc = _torch_setup(case)
    rec = {k: [] for k in RECORD}
    for i in range(CYCLES):
        tc, _ = tcl.episode_step(tcfg, tsc, tref, int(tref.shape[0]),
                                 empty_grid(), tc, i)
        _record(rec, tc)
    rtol = OPTIONS[case].get("rtol", 0.0)
    for i in range(CYCLES):
        msg = "%s, cycle %d" % (case, i)
        for k in ("pos", "vel", "yaw", "quat"):
            np.testing.assert_allclose(rec[k][i], want[k][i], atol=1e-4,
                                       rtol=rtol,
                                       err_msg="%s, %s" % (msg, k))
        for k in ("succ", "hits", "repeats", "stall"):
            np.testing.assert_array_equal(rec[k][i], want[k][i],
                                          err_msg="%s, %s" % (msg, k))
    moved = {
        "goal_relax": lambda: rec["stall"][-1].tolist() == [43, 3],
        "repeat_path": lambda: rec["repeats"][0].tolist() == [1, 1],
        "quadrotor": lambda: np.abs(rec["quat"][-1]
                                    - rec["quat"][0]).max() > 0,
        "velocity_yaw": lambda: np.abs(rec["yaw"][-1]).max() > 0,
    }
    assert moved.get(case, lambda: True)(), (case, rec)


def test_fused_fov_upper_bound_is_inert():
    """The JAX quirk use_fov_fused pins, at its source: the FOV rows'
    QPs as build_qp makes them (first row: lower bound -inf, upper bound
    c1 finite) packed for the fleet solve carry the lower bound only,
    -1e30 on that row in both packages, so the kernel's projection
    max(z, lo) never binds it; the second row's lower bound c2 is
    packed."""
    tcfg, tsc, tref, tc = _torch_setup("use_fov_fused")
    pcfg = tcfg.planner
    S, W, K = 2, pcfg.mpc_window, pcfg.max_obstacles + 3
    g = np.random.default_rng(0)
    half_max = torch.as_tensor(g.normal(size=(S, 1, 3)).astype(np.float32))
    half_min = torch.as_tensor(g.normal(size=(S, 1, 3)).astype(np.float32))
    x0 = torch.zeros((S, 1, 6))
    xref = torch.zeros((S, 1, pcfg.horizon, 3))
    qpos = torch.as_tensor(g.normal(size=(S, 6, W, K, 3)).astype(np.float32))
    ones = torch.ones((S, 6, W, K))
    qps = tqp.build_qp(pcfg, x0, xref, qpos, ones[..., None].expand(
        S, 6, W, K, 3), ones * 0, ones, ones, torch.zeros((S, 1, W, 3)),
        fov_rows=(half_max, half_min))
    assert torch.isinf(qps.l.obs[..., K - 2]).all()
    assert torch.isfinite(qps.u.obs[..., K - 2]).all()
    warm = torch.zeros((S, 6, pcfg.num_vars))
    fp, fac = tfl.fleet_setup(pcfg, qps, warm)
    assert (fp.lo_obs[:, :6, :, K - 2] == -tfl.BIG).all()
    assert (fp.lo_obs[:, :6, :, K - 1] > -tfl.BIG).all()
    jcfg, *_ = _jax_setup("use_fov_fused")
    def j(t):
        if isinstance(t, tqp.ConVec):
            return jqp.ConVec(*map(j, t))
        return jnp.asarray(t.numpy())
    jq = jqp.QPData(*map(j, qps))
    jfp = jpf.pack_fleet(jcfg.planner, jq, j(fac.Minv), j(fac.D), j(fac.E),
                         j(fac.c), j(warm))
    jlo = convert.fleet_problem_from_lanes(_np(jfp)).lo_obs
    np.testing.assert_array_equal(jlo[:, :6, :, K - 2].numpy(),
                                  fp.lo_obs[:, :6, :, K - 2].numpy())


def test_check_supported_raises_for_exactly_the_options_left():
    """engine/closed_loop.check_supported accepts every option this port
    runs, real perception, static clustering, goal mode with each of its
    three input-trajectory modes and the TPU-tuned solver knobs among
    them: no option is left. It raises only for values that name no mode
    (ValueError), each by name."""
    base = IntentMPCConfig()
    for opt in OPTIONS.values():
        tcl.check_supported(with_options(base, opt.get("engine"),
                                         opt.get("solver")))
    tcl.check_supported(with_options(base, dict(use_fake_detector=False),
                                     None))
    tcl.check_supported(base.replace(planner=dataclasses.replace(
        base.planner, static_clustering=True)))
    for mode in ("linspace", "minsnap", "global"):
        tcl.check_supported(with_options(
            base, dict(goal_mode=True, ref_mode=mode), None))
    for solver in (dict(woodbury_candidates=True), dict(block_refine=True),
                   dict(folded_refine=True), dict(minv_dtype="bf16"),
                   dict(shared_refine_warm_frac=0.5)):
        tcl.check_supported(with_options(base, None, solver))
    with pytest.raises(ValueError, match="ref_mode"):
        tcl.check_supported(with_options(
            base, dict(goal_mode=True, ref_mode="spline"), None))
    for name, solver in (("shared_refine_mode",
                          dict(shared_refine_mode="jacobi")),
                         ("minv_dtype", dict(minv_dtype="f16"))):
        with pytest.raises(ValueError, match=name):
            tcl.check_supported(with_options(base, None, solver))


@pytest.mark.slow
def test_quadrotor_dynus_seeds_match_jax():
    """Whole DYNUS episodes on seeds 0-3 with the rigid-body plant, at the
    harness run's flags (--plant quadrotor --timeout 60 --max-obstacles
    32): each seed ends with the same goal and collision outcome in both
    packages (per-cycle states are not compared at this size, see
    tests/test_torch_closed_loop.py)."""
    from intent_mpc_tpu.benchmark import harness as JH
    from intent_mpc_tpu.utils.config import IntentMPCConfig as JConfig
    from intent_mpc_torch.benchmark import harness as H

    def configure(cfg):
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, plant="quadrotor", timeout=60.0))
        return cfg.replace(planner=dataclasses.replace(cfg.planner,
                                                       max_obstacles=32))
    seeds = list(range(4))
    jrows = JH.run_trials(configure(JConfig()), seeds)
    trows = H.run_trials(configure(IntentMPCConfig()), seeds, device="cpu")
    for key in ("goal_reached", "collision"):
        assert [r[key] for r in trows] == [r[key] for r in jrows], key


@pytest.mark.slow
def test_stationary_refinement_dynus_rejections_match_jax():
    """Stationary refinement on the production DYNUS config (seeds 0 and
    1, 7 cycles): the recurrence diverges on some constrained cycles,
    every candidate is rejected and the chosen one's residual is not
    finite, in both packages alike (ROADMAP queue 3): the same solve
    counts, and prim_res_sum non-finite in both."""
    from intent_mpc_tpu.parallel import sharding as jsh
    from intent_mpc_tpu.utils.config import IntentMPCConfig as JConfig
    from intent_mpc_torch.benchmark.capture import run_loop
    opt = dict(solver=dict(shared_refine_mode="stationary"))
    jcfg = with_options(JConfig(), **opt)
    jref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, 2.5)
    jm, _ = jsh.batch_rollout(jcfg, jsh.stack_scenarios(jcfg, [0, 1]), jref,
                              jnp.asarray(jref.shape[0]), num_cycles=7)
    carry, _, _ = run_loop(with_options(IntentMPCConfig(), **opt), 2, 7,
                           "cpu")
    np.testing.assert_array_equal(carry.metrics.solve_successes.numpy(),
                                  np.asarray(jm.solve_successes))
    assert int(carry.metrics.solve_successes.min()) < 7
    assert not np.isfinite(np.asarray(jm.prim_res_sum)).any()
    assert not torch.isfinite(carry.metrics.prim_res_sum).any()


if __name__ == "__main__":
    _jax_cycles(sys.argv[1], sys.argv[2])
