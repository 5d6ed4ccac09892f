"""Port parity: the closed loop with the OSQP-semantics solver options
(truncation="osqp", a factor per candidate with in-solve adaptive rho,
temporal rho, the polish), per cycle against the JAX package on the
`__graft_entry__` config, and per seed on the production DYNUS config
(slow)."""

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
from intent_mpc_tpu.parallel import sharding as jsh
from intent_mpc_tpu.utils.config import IntentMPCConfig as JConfig
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as tsh
from intent_mpc_torch.utils import convert
from intent_mpc_torch.utils.config import IntentMPCConfig, small_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# solver options of each closed-loop case; "rho0" starts the carried rho
# away from SolverConfig.rho = 0.1 (the per-candidate case at 1.0, so that
# its in-solve rule adapts). The per-candidate case refines once,
# as tests/test_torch_admm.py holds that path: with refine_iters = 0 the
# x-update is Minv rhs alone and carries each package's float32 factor
# rounding straight into x (1.8e-4 m at cycle 0). The fused temporal-rho
# case starts at 0.2: its factor's rho then differs from its rows' (the
# JAX quirk below) and the stationary refinement contracts at ~1/2 per
# step; at 0.3 (~2/3 per step) the two packages' factor rounding reads
# 1.3e-4 m at cycle 0.
OPTIONS = {
    "truncation_osqp": dict(truncation="osqp"),
    "per_candidate_adaptive_temporal": dict(
        shared_factor=False, adaptive_rho=True, temporal_rho=True,
        max_iter=50, refine_iters=1, rho0=1.0),
    "temporal_rho": dict(temporal_rho=True, rho0=3.0),
    "temporal_rho_fused": dict(temporal_rho=True, fused_solve=True,
                               rho0=0.2),
    "polish": dict(polish=True),
    "polish_fused": dict(polish=True, fused_solve=True),
}
SEEDS = (0, 1)
CYCLES = 3


def with_solver(cfg, **kw):
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver, **kw)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_setup(case):
    """The JAX config, stacked scenarios, reference and initial carry of a
    case (the carried rho set to the case's rho0)."""
    kw = dict(OPTIONS[case])
    rho0 = kw.pop("rho0", None)
    jcfg, _, ref = _tiny_setup()
    jcfg = with_solver(jcfg, **kw)
    jsc = jax.tree.map(lambda *a: jnp.stack(a),
                       *[jworld.generate_scenario(s, jcfg.world)
                         for s in SEEDS])
    jc = jax.vmap(lambda s: jcl.init_carry(jcfg, s))(jsc)
    if rho0 is not None:
        jc = jc._replace(planner=jc.planner._replace(
            rho=jnp.full_like(jc.planner.rho, rho0)))
    return jcfg, jsc, ref, jc, kw


def _jax_cycles(case, out):
    """CYCLES cycles of the JAX engine, vmapped over the scenarios (so the
    fused cases reach the fleet kernel, in interpret mode on the CPU);
    writes each cycle's pos, vel, solve successes and carried rho."""
    jcfg, jsc, ref, jc, _ = _jax_setup(case)
    L = jnp.asarray(ref.shape[0])
    occ = jempty()
    step = jax.jit(lambda cc, i: jax.vmap(lambda x, s: jcl.episode_step(
        jcfg, s, ref, L, occ, x, i))(cc, jsc)[0])
    rec = {k: [] for k in ("pos", "vel", "succ", "rho")}
    for i in range(CYCLES):
        jc = step(jc, jnp.asarray(i, jnp.int32))
        for k, v in (("pos", jc.pos), ("vel", jc.vel),
                     ("succ", jc.metrics.solve_successes),
                     ("rho", jc.planner.rho)):
            rec[k].append(np.asarray(v))
    np.savez(out, **{k: np.stack(v) for k, v in rec.items()})


@pytest.mark.parametrize("case", list(OPTIONS))
def test_option_episode_steps_match_jax(case, tmp_path):
    """3 cycles of episode_step on two scenarios from identical carries:
    the JAX engine vmapped over them against the port stepping the same
    batch. The JAX cycles run in a child interpreter, one per case: in
    one process the JAX package's jit cache hands the polish case's
    executable to the fused polish case's step, which then fails on its
    buffer count. Per cycle: positions and velocities within 1e-4 m
    (m/s), as tests/test_torch_closed_loop.py holds the default path;
    the solve counts equal; the carried rho within rtol 1e-2 (read: 5e-3
    at most). The rho suggestion is sqrt(prim_rel / dual_rel), and the
    dual residual ||P x + q + A^T y|| ~0.1 is what is left of terms ~3e3
    (position weight 1000), so a 1e-5 relative difference in x moves it
    by tens of percent: from a carried rho of 0.3 or 1.0 the two
    packages' second suggestions differed by 6% and 3%, and the next
    cycle's positions by 5e-4 and 7e-4 m. The temporal-rho case starts
    at 3.0, where they agree. The fused temporal-rho case starts at 0.2:
    the fleet solve factors with the carried rho while its rows use
    SolverConfig.rho (a JAX quirk the port keeps), and its rho suggestion
    is SolverConfig.rho, so the carry returns to 0.1 after the first
    cycle in both packages. The temporal-rho cases must move the carried
    rho."""
    out = str(tmp_path / "jax.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, os.path.abspath(__file__), case, out],
                   check=True, env=env, cwd=ROOT, timeout=600)
    want = np.load(out)
    jcfg, jsc, ref, jc, kw = _jax_setup(case)
    tcfg = with_solver(small_config(num_obstacles=4, horizon=8, timeout=0.5,
                                    max_obstacles=4, hist=8).replace(
        goal=(6.0, 0.0, 2.0)), **kw)
    tsc = convert.scenario_from_numpy(_np(jsc))
    tc = convert.carry_from_numpy(_np(jc))
    tref = torch.as_tensor(np.array(ref))
    rhos = []
    for i in range(CYCLES):
        tc, _ = tcl.episode_step(tcfg, tsc, tref, int(ref.shape[0]),
                                 empty_grid(), tc, i)
        msg = "%s, cycle %d" % (case, i)
        np.testing.assert_allclose(tc.pos.numpy(), want["pos"][i],
                                   atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(tc.vel.numpy(), want["vel"][i],
                                   atol=1e-4, err_msg=msg)
        np.testing.assert_array_equal(tc.metrics.solve_successes.numpy(),
                                      want["succ"][i], err_msg=msg)
        np.testing.assert_allclose(tc.planner.rho.numpy(), want["rho"][i],
                                   rtol=1e-2, err_msg=msg)
        rhos.append(tc.planner.rho.tolist())
    if case == "temporal_rho_fused":
        assert rhos[0] == pytest.approx([0.1, 0.1])
    if case == "temporal_rho":
        assert rhos[0] != pytest.approx([3.0, 3.0]), rhos
    if case == "per_candidate_adaptive_temporal":
        assert any(r != pytest.approx(0.1) for c in rhos for r in c), rhos


def test_polished_episode_reaches_goal():
    """Port of tests/test_closed_loop.py::test_episode_with_polish on the
    port: with polish=True the clear-path episode (its setup: 6 obstacles
    parked 30 m off the corridor, 3 s, 60 ADMM iterations) still reaches
    the goal with no collision, and its path length stays within 0.2 m
    of the unpolished run's (the polish refines the same optimum)."""
    cfg = small_config(num_obstacles=6, horizon=10, timeout=3.0,
                       max_obstacles=6, hist=12).replace(goal=(8.0, 0.0, 2.0))
    sc = jworld.generate_scenario(seed=1, cfg=dataclasses.replace(
        JConfig().world, num_obstacles=6))
    sc = sc._replace(origin=sc.origin + jnp.array([0.0, 30.0, 0.0]))
    scen = convert.scenario_from_numpy(_np(sc), add_batch_axis=True)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    out = {}
    for polish in (True, False):
        c = with_solver(cfg, polish=polish)
        carry, _ = tcl.run_episode(c, scen, ref, ref.shape[0],
                                   solver_iters=60, device="cpu")
        out[polish] = tcl.summarize(c, carry)[0]
    s, s0 = out[True], out[False]
    assert s["goal_reached"] and not s["collision"], s
    assert abs(s["path_length"] - s0["path_length"]) < 0.2, (s, s0)


@pytest.mark.slow
def test_osqp_truncation_dynus_seeds_match_jax():
    """Whole DYNUS episodes on seeds 0-3 at the production config with
    truncation="osqp": each seed ends with the same success and collision
    outcome in both packages (per-cycle states are not compared, see
    tests/test_torch_closed_loop.py)."""
    seeds = list(range(4))
    jcfg = with_solver(JConfig(), truncation="osqp")
    jref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, 2.5)
    jm, _ = jsh.batch_rollout(jcfg, jsh.stack_scenarios(jcfg, seeds), jref,
                              jnp.asarray(jref.shape[0]))
    cfg = with_solver(IntentMPCConfig(), truncation="osqp")
    tref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5)
    tm, _ = tsh.batch_rollout(cfg, tsh.stack_scenarios(cfg, seeds,
                                                       device="cpu"),
                              tref, tref.shape[0], device="cpu")
    np.testing.assert_array_equal(tm.goal_reached.numpy(),
                                  np.asarray(jm.goal_reached))
    np.testing.assert_array_equal(tm.collision.numpy(),
                                  np.asarray(jm.collision))


if __name__ == "__main__":
    _jax_cycles(sys.argv[1], sys.argv[2])
