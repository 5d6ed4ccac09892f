"""Port parity: the fleet-fused solve (intent_mpc_torch.ops.fleet) against
the JAX package's ops/pallas_fused.py, whose Pallas kernel runs here in
interpret mode, as tests/test_pallas_fused.py runs it.

Config of tests/test_pallas_fused.py:44-47: horizon 10, 4 obstacle slots
(3 active), 4 scenarios x 6 candidates, 60 iterations, stationary
refinement x3."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.ops import pallas_fused as jpf
from intent_mpc_tpu.ops.admm import admm_factor as jadmm_factor
from intent_mpc_tpu.parallel import sharding as jsh
from intent_mpc_tpu.utils.config import small_config as jsmall_config
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.ops import admm as tadmm
from intent_mpc_torch.ops import fleet as tf
from intent_mpc_torch.ops import qp as tqp
from intent_mpc_torch.parallel import sharding as tsh
from intent_mpc_torch.utils import convert
from intent_mpc_torch.utils.config import small_config

from test_torch_qp import build_both, configs, stack_jax, to_torch

torch.set_num_threads(1)

S = 4
ITERS, REFINE = 60, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fleet():
    """The (S, 6) candidate QPs of test_pallas_fused._fleet in both
    packages, the JAX per-scenario factors and the JAX packed problem."""
    jcfg, tcfg = configs(max_iter=ITERS, shared_refine_mode="stationary",
                         shared_refine_iters=REFINE)
    per_scen = [stack_jax([build_both(jcfg, tcfg, 4, 3, seed=10 * s + c)[0]
                           for c in range(6)]) for s in range(S)]
    jqps = stack_jax(per_scen)
    rng = np.random.RandomState(5)
    warm = (0.1 * rng.randn(S, 6, jcfg.num_vars)).astype(np.float32)
    jmean = jax.tree.map(lambda a: jnp.mean(a, axis=1), jqps)._replace(
        obs_active=jnp.max(jqps.obs_active, axis=1))
    jfac = jax.vmap(lambda q: jadmm_factor(jcfg, q))(jmean)
    jfp = jpf.pack_fleet(jcfg, jqps, jfac.Minv, jfac.D, jfac.E, jfac.c,
                         jnp.asarray(warm))
    return dict(jcfg=jcfg, tcfg=tcfg, jqps=jqps,
                tqps=to_torch(jqps, tqp.QPData), warm=warm, jfac=jfac,
                jfp=jfp)


@pytest.mark.parametrize("horizon,max_obstacles", [(10, 4), (30, 64)],
                         ids=["small", "production"])
def test_a_ext_matches_jax(horizon, max_obstacles):
    """The static operator is built entry by entry in the same order:
    bit-equal, and its CSR arrays rebuild it exactly."""
    jcfg, tcfg = configs(horizon=horizon, max_obstacles=max_obstacles)
    K = max_obstacles + 1
    a = tf.a_ext(tcfg, K)
    np.testing.assert_array_equal(a, np.asarray(jpf._a_ext(jcfg, K, 16)))
    for m in (a, a.T):
        ptr, col, val = tf.csr(m)
        dense = np.zeros_like(m)
        for r in range(m.shape[0]):
            dense[r, col[ptr[r]:ptr[r + 1]]] = val[ptr[r]:ptr[r + 1]]
            assert np.all(np.diff(col[ptr[r]:ptr[r + 1]]) > 0)
        np.testing.assert_array_equal(dense, m)


def test_pack_fleet_matches_jax(fleet):
    """pack_fleet from identical QPs, factors and warm starts: leaf by leaf
    within 1e-6 relative (the same float32 operations in the same order;
    in practice bit-equal)."""
    f = fleet
    fac = f["jfac"]
    got = tf.pack_fleet(
        f["tcfg"], f["tqps"], torch.as_tensor(np.array(fac.Minv)),
        torch.as_tensor(np.array(fac.D)),
        tqp.ConVec(*(torch.as_tensor(np.array(e)) for e in fac.E)),
        torch.as_tensor(np.array(fac.c)), torch.as_tensor(f["warm"]))
    want = convert.fleet_problem_from_lanes(_np(f["jfp"]))
    for name, a, b in zip(tf.FleetProblem._fields, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("iters", [1, ITERS])
def test_fleet_solve_reference_matches_jax(fleet, iters):
    """The plain version against the Pallas kernel (interpret mode) on the
    same packed problem, carried across by convert: x within 1e-3, the
    duals within 1e-3 of their scale. Every lane is compared, inert
    slots included."""
    f = fleet
    jx = jpf.fleet_solve(f["jcfg"], f["jfp"], iters, REFINE, interpret=True)
    fp = convert.fleet_problem_from_lanes(_np(f["jfp"]))
    got = convert.fleet_outputs_to_lanes(
        *tf.fleet_solve_reference(f["tcfg"], fp, iters, REFINE))
    assert float(np.max(np.abs(got[0] - np.asarray(jx[0])))) < 1e-3
    for a, b in zip(got[1:], jx[1:]):
        b = np.asarray(b)
        assert float(np.max(np.abs(a - b))) / (np.max(np.abs(b)) + 1.0) < 1e-3


def test_fleet_admm_matches_jax(fleet):
    """The port's fleet_admm (its own factor, pack, solve and unpack)
    against JAX fleet_admm(interpret=True), with the tolerances of
    test_pallas_fused.py:52-58: x 1e-3, prim_res 1e-3, duals 1e-3 of
    their (rho_eq-amplified) scale."""
    f = fleet
    warm = f["warm"]
    ref = jpf.fleet_admm(f["jcfg"], f["jqps"], jnp.asarray(warm),
                         interpret=True)
    out = tf.fleet_admm(f["tcfg"], f["tqps"], torch.as_tensor(warm))
    assert out.x.shape == (S, 6, f["tcfg"].num_vars)
    assert float(np.max(np.abs(out.x.numpy() - np.asarray(ref.x)))) < 1e-3
    np.testing.assert_allclose(out.prim_res.numpy(), np.asarray(ref.prim_res),
                               atol=1e-3)
    np.testing.assert_array_equal(out.solved.numpy(), np.asarray(ref.solved))
    for a, b in zip(out.y, ref.y):
        b = np.asarray(b)
        assert float(np.max(np.abs(a.numpy() - b))) / (np.max(np.abs(b))
                                                       + 1.0) < 1e-3
    assert np.all(np.isnan(out.dual_res.numpy()))
    np.testing.assert_array_equal(out.rho_suggest.numpy(),
                                  np.full((S, 6), f["tcfg"].solver.rho,
                                          np.float32))


def test_fleet_solve_on_cpu_is_the_plain_version(fleet):
    """On CPU tensors fleet_solve runs the plain version and launches no
    kernel."""
    f = fleet
    fp = convert.fleet_problem_from_lanes(_np(f["jfp"]))
    before = tf.FLEET_LAUNCHES
    got = tf.fleet_solve(f["tcfg"], fp, 5, REFINE)
    want = tf.fleet_solve_reference(f["tcfg"], fp, 5, REFINE)
    assert tf.FLEET_LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bad = fp._replace(q=fp.q[:, :6].contiguous())
    with pytest.raises(ValueError, match="shape"):
        tf.fleet_solve(f["tcfg"], bad, 1, REFINE)


@pytest.mark.parametrize("horizon,max_obstacles", [(10, 4), (30, 65)],
                         ids=["small", "production"])
def test_obstacle_records_unpack_to_the_fleet_problem(horizon,
                                                       max_obstacles):
    """The kernel's obstacle records, (S, 6, W, K, 8) with the eight
    read-only per-slot arrays side by side, unpack bit for bit to the
    FleetProblem fields pack_fleet built, the inert slots' fills and the
    padded slots past the QPs' own count included."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import small_fleet_qps
    from intent_mpc_torch.utils.config import PlannerConfig
    pcfg = PlannerConfig(horizon=horizon, max_obstacles=max_obstacles)
    qps = small_fleet_qps(pcfg, 2, "cpu")
    fp, _ = tf.fleet_setup(pcfg, qps, torch.zeros((2, 6, pcfg.num_vars)))
    d = tf.fleet_dims(pcfg, max_obstacles, 2)
    assert d.K > max_obstacles             # the K padding is in the records
    rec = tf.pack_obstacle_records(fp)
    assert rec.shape == (2, tf.LIVE, d.W, d.K, 8)
    assert rec.dtype == torch.float32 and rec.is_contiguous()
    # unpack: each field's live slots from the record, the inert slots 6
    # and 7 with pack_fleet's fills
    fills = dict(gx=0.0, gy=0.0, gz=0.0, s3=0.0, s4=0.0, rho_obs=1e-6,
                 ir_obs=1e6, lo_obs=-tf.BIG)
    for i, name in enumerate(tf.OBS_FIELDS):
        inert = torch.full((2, tf.LANES - tf.LIVE, d.W, d.K), fills[name])
        back = torch.cat([rec[..., i], inert], dim=1)
        want = getattr(fp, name)
        assert torch.equal(back.view(torch.int32),
                           want.view(torch.int32)), name
    # the fills the records carry in the padded slots
    assert bool((rec[..., 5][..., max_obstacles:] == np.float32(1e-6)).all())
    assert bool((rec[..., 7][..., max_obstacles:] == -tf.BIG).all())


def test_layout_maps_problem_p_to_scenario_and_slot():
    """The TPU layout's problem p = 8 s + c is the port's [s, c]."""
    a = np.arange(5 * 2 * 8, dtype=np.float32).reshape(5, 16)
    fp = tf.FleetProblem(*([a] * len(tf.FleetProblem._fields)))
    port = convert.fleet_problem_from_lanes(fp).q
    assert port.shape == (2, 8, 5)
    for s in range(2):
        for c in range(8):
            np.testing.assert_array_equal(port[s, c].numpy(), a[:, 8 * s + c])
    np.testing.assert_array_equal(convert.fleet_outputs_to_lanes(port)[0], a)


def _fused(cfg, **solver):
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                **solver)))


def test_fused_solve_options_accepted():
    """The fused path takes every solver option (the JAX planner's fused
    branch never reads those only admm_solve reads): stationary
    refinement, polish and temporal rho, the two-phase refinement, and
    the bf16 factor, which the fleet solve reads as float32
    (tests/test_torch_solver_knobs.py); admm_solve takes them too."""
    cfg = small_config()
    fused = _fused(cfg, fused_solve=True, shared_refine_mode="stationary",
                   shared_refine_x0="minv", factor_reuse_cycles=1)
    tcl.check_supported(fused)
    tadmm.check_supported(fused.planner.solver)
    tcl.check_supported(_fused(cfg, fused_solve=True))
    tcl.check_supported(_fused(cfg, fused_solve=True, polish=True,
                               temporal_rho=True))
    warm = _fused(cfg, fused_solve=True, shared_refine_warm_frac=0.5)
    tcl.check_supported(warm)
    tadmm.check_supported(warm.planner.solver)
    tcl.check_supported(_fused(cfg, fused_solve=True, minv_dtype="bf16"))


# the small closed-loop config of tests/test_pallas_fused.py:72-84
_LOOP = dict(fused_solve=True, shared_refine_mode="stationary",
             shared_refine_iters=3, shared_refine_x0="minv",
             factor_reuse_cycles=1)


def test_fused_closed_loop_matches_jax():
    """6 cycles of the engine with fused_solve=True on 4 scenarios, 40 ADMM
    iterations a cycle: the JAX engine vmapped over the scenarios (so its
    custom_vmap reaches fleet_admm and the Pallas kernel) against the
    port stepping the same batch. Positions agree to 1e-4 m per cycle."""
    kw = dict(num_obstacles=6, horizon=10, timeout=1.0, max_obstacles=6,
              hist=12)
    jcfg = _fused(jsmall_config(**kw).replace(goal=(8.0, 0.0, 2.0)), **_LOOP)
    tcfg = _fused(small_config(**kw).replace(goal=(8.0, 0.0, 2.0)), **_LOOP)
    ref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, spacing=0.5)
    jsc = jsh.stack_scenarios(jcfg, range(S))
    occ = jempty()
    L = jnp.asarray(ref.shape[0])
    step = jax.jit(lambda cc, i: jax.vmap(lambda x, s: jcl.episode_step(
        jcfg, s, ref, L, occ, x, i, solver_iters=40))(cc, jsc)[0])
    jc = jax.vmap(lambda s: jcl.init_carry(jcfg, s))(jsc)
    tsc = convert.scenario_from_numpy(_np(jsc))
    tc = convert.carry_from_numpy(_np(jc))
    tref = torch.as_tensor(np.array(ref))
    tf.FLEET_LAUNCHES = 0
    for i in range(6):
        jc = step(jc, jnp.asarray(i, jnp.int32))
        tc, _ = tcl.episode_step(tcfg, tsc, tref, int(ref.shape[0]),
                                 empty_grid(), tc, i, solver_iters=40)
        np.testing.assert_allclose(tc.pos.numpy(), np.asarray(jc.pos),
                                   atol=1e-4, err_msg="cycle %d" % i)
        np.testing.assert_array_equal(
            tc.metrics.solve_successes.numpy(),
            np.asarray(jc.metrics.solve_successes))
    assert tf.FLEET_LAUNCHES == 0      # CPU tensors: the plain version ran


def test_fused_plan_leaves_carried_factor_unchanged():
    """The fused branch factors every cycle and carries no factor: with the
    default factor_reuse_cycles = 4 the carried fac_* fields keep their
    initial values through the cycles."""
    cfg = _fused(small_config(num_obstacles=4, horizon=8, timeout=0.5,
                              max_obstacles=4, hist=8).replace(
        goal=(6.0, 0.0, 2.0)), fused_solve=True)
    scen = tsh.stack_scenarios(cfg, [0, 1], device="cpu")
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    c0 = tcl.init_carry(cfg, scen, device="cpu")
    c = c0
    for i in range(3):
        c, _ = tcl.episode_step(cfg, scen, ref, ref.shape[0], empty_grid(),
                                c, i)
    assert torch.equal(c.planner.fac_minv, c0.planner.fac_minv)
    assert torch.equal(c.planner.fac_d, c0.planner.fac_d)
    assert int(c.metrics.solve_successes.sum()) > 0
    assert bool(torch.isfinite(c.pos).all())


@pytest.mark.slow
def test_fused_dynus_seeds_success_and_collision_match_jax():
    """Whole DYNUS episodes on seeds 0-7 at the production config with
    fused_solve=True: each seed ends with the same success and collision
    outcome in both packages (the JAX engine vmapped, so its Pallas fleet
    kernel runs in interpret mode; the port's plain version)."""
    from intent_mpc_tpu.utils.config import IntentMPCConfig as JConfig
    from intent_mpc_torch.utils.config import IntentMPCConfig
    seeds = list(range(8))
    jcfg = _fused(JConfig(), fused_solve=True)
    jref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, 2.5)
    jm, _ = jsh.batch_rollout(jcfg, jsh.stack_scenarios(jcfg, seeds), jref,
                              jnp.asarray(jref.shape[0]))
    cfg = _fused(IntentMPCConfig(), fused_solve=True)
    tref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5)
    tm, _ = tsh.batch_rollout(cfg, tsh.stack_scenarios(cfg, seeds,
                                                       device="cpu"),
                              tref, tref.shape[0], device="cpu")
    print({"seeds": seeds, "jax_goal": np.asarray(jm.goal_reached).tolist(),
           "port_goal": tm.goal_reached.tolist(),
           "jax_collision": np.asarray(jm.collision).tolist(),
           "port_collision": tm.collision.tolist()})
    np.testing.assert_array_equal(tm.goal_reached.numpy(),
                                  np.asarray(jm.goal_reached))
    np.testing.assert_array_equal(tm.collision.numpy(),
                                  np.asarray(jm.collision))
