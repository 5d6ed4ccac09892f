"""Port parity: goal mode's modules (models/global_planner.py's RRT and
shortcut, models/pwl_traj.py, ops/dense_admm.py, models/poly_traj.py,
models/poly_planner.py, engine/ref_builder.py, the engine's
goal_region_occupied and the wall world of benchmark/ref_modes.py) against
the JAX package on the CPU, from the same inputs; and goal-mode
checkpoint/resume.

Each test states its tolerance. The dense min-snap solve is the one place
where float32 rounding is amplified: on the 8 m wall routes its sampled
reference parts from JAX's by up to 0.35 m at the full 400 iterations and
by up to 4 cm at 40, because OSQP's rho-adaptation rule is a threshold on
a ratio of residuals that the two packages' rounding can put on either
side; at 20 iterations (5 per rho block) the references of four starts on
three wall worlds agree within 2e-5 m. In float64 the two solves agree to
5e-11 at 400 iterations (test_solve_dense_qp_and_poly_plan_match_jax_in_
float64). The float32 build tests therefore run ref_poly_iters 20, the
only reduction made (no width is changed); the 400-iteration DYNUS build is
held by the properties it commits (tests/test_torch_goal_loop.py and the card tests)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.benchmark import ref_modes as jrm
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.engine import ref_builder as jrb
from intent_mpc_tpu.models import global_planner as jgp
from intent_mpc_tpu.models import poly_planner as jpp
from intent_mpc_tpu.models import poly_traj as jpt
from intent_mpc_tpu.models import pwl_traj as jpwl
from intent_mpc_tpu.models.occupancy import (build_from_static_obstacles as
                                             jbuild_grid)
from intent_mpc_tpu.ops import dense_admm as jda
from intent_mpc_torch.benchmark import ref_modes as trm
from intent_mpc_torch.engine import checkpoint as ckpt
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.engine import ref_builder as trb
from intent_mpc_torch.models import global_planner as tgp
from intent_mpc_torch.models import poly_planner as tpp
from intent_mpc_torch.models import poly_traj as tpt
from intent_mpc_torch.models import pwl_traj as tpwl
from intent_mpc_torch.ops import dense_admm as tda
from intent_mpc_torch.utils import convert, prng

torch.set_num_threads(1)

START = np.float32([1.0, 2.0, 1.5])
GOAL = np.float32([9.0, 2.0, 1.5])
LO = np.float32([0.3, 0.3, 0.5])
HI = np.float32([9.7, 9.7, 2.5])
KEYS = (0, 3, 7)
# the min-snap iteration budget of the float32 build tests (see above)
POLY_ITERS = 20


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _shared_grid(jgrid):
    g = convert.grid_from_numpy(_np(jgrid))
    return g._replace(grid=g.grid[0])


@pytest.fixture(scope="module")
def walled_map():
    """tests/test_global_planner.py's map: 10 x 10 x 3 m, a wall at x = 5
    leaving a gap at y in [7, 9]."""
    j = jbuild_grid(origin=(0, 0, 0), size_m=(10, 10, 3), resolution=0.25,
                    centers=[[5.0, 3.5, 1.5]], bboxes=[[0.5, 7.0, 3.0]],
                    inflation=[0.2, 0.2, 0.2])
    return j, _shared_grid(j)


def _batch(a, S):
    return torch.as_tensor(a).expand(S, *np.shape(a)).contiguous()


@pytest.mark.parametrize("iters", [200, 800])
def test_rrt_plan_matches_jax(walled_map, iters):
    """Goal-biased RRT + shortcut on the walled map for three keys as one
    batch: path within 1e-5 m, length and success equal (the tree's every
    decision, nearest node, edge and goal tests, follows JAX's)."""
    jgrid, tgrid = walled_map
    cfg = jgp.RRTConfig(max_iters=iters)
    f = jax.jit(jax.vmap(lambda k: jgp.rrt_plan(jgrid, START, GOAL, LO, HI,
                                                k, cfg)))
    jr = f(jnp.stack([jax.random.PRNGKey(k) for k in KEYS]))
    S = len(KEYS)
    tr = tgp.rrt_plan(tgrid, _batch(START, S), _batch(GOAL, S),
                      _batch(LO, S), _batch(HI, S),
                      prng.prng_key(torch.tensor(KEYS)), tgp.RRTConfig(*cfg))
    np.testing.assert_array_equal(tr.success.numpy(), np.asarray(jr.success))
    np.testing.assert_array_equal(tr.length.numpy(), np.asarray(jr.length))
    np.testing.assert_allclose(tr.path.numpy(), np.asarray(jr.path),
                               atol=1e-5)
    assert tr.success.any()


def test_rrt_nodes_and_shortcut_match_jax(walled_map):
    """The tree itself (the draws and every appended node) and the
    shortcut of a zig-zag path: nodes within 1e-5 m, the shortcut's path
    within 1e-5 m and its length equal."""
    jgrid, tgrid = walled_map
    cfg = jgp.RRTConfig(max_iters=300)
    key = jax.random.PRNGKey(5)
    q = jax.vmap(lambda it: jnp.where(
        jax.random.uniform(jax.random.split(jax.random.fold_in(key, it))[0])
        < cfg.connect_goal_ratio, GOAL,
        jax.random.uniform(jax.random.split(jax.random.fold_in(key, it))[1],
                           (3,)) * (HI - LO) + LO))(jnp.arange(300))
    tq = tgp.rrt_draws(prng.prng_key(torch.tensor([5])), 300,
                       cfg.connect_goal_ratio, _batch(LO, 1), _batch(HI, 1),
                       _batch(GOAL, 1))
    np.testing.assert_allclose(tq[0].numpy(), np.asarray(q), atol=1e-5)

    zig = np.float32([[1, 2, 1.5], [2, 4, 1.5], [3, 6, 1.5], [4, 8, 1.5],
                      [6, 8, 1.5], [7, 6, 1.5], [8, 4, 1.5], [9, 2, 1.5]])
    path = np.concatenate([zig, np.repeat(zig[-1:], 8, axis=0)])
    for n in (8, 5):
        jp, jn = jax.jit(lambda p: jgp._shortcut(jgrid, p, jnp.asarray(n),
                                                 cfg))(path)
        tp, tn = tgp._shortcut(tgrid, torch.tensor(path)[None],
                               torch.tensor([n]), tgp.RRTConfig(*cfg))
        assert int(tn[0]) == int(jn), n
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), atol=1e-5)


def test_occupied_at_refuses_an_octree():
    """Despite its name, this pins that occupied_at ACCEPTS an octree: an
    OctoMap goes to octo.is_blocked, whose out-of-map answer (blocked for a
    conservative map) differs from the OccupancyGrid's (free). The name is
    kept from when occupied_at refused an octree, so that the test's id
    stays the same across the change that replaced the refusal."""
    from intent_mpc_torch.models import octo
    from intent_mpc_torch.models.occupancy import OccupancyGrid
    grid = OccupancyGrid(grid=torch.zeros((4, 4, 4), dtype=torch.int8),
                         origin=torch.zeros(3), resolution=torch.tensor(0.5))
    o = octo.from_occupancy_grid(grid, levels=2)._replace(
        ignore_unknown=False)
    p = torch.tensor([[[1.0, 1.0, 1.0], [-3.0, 1.0, 1.0]]])
    assert tgp.occupied_at(o, p)[0].tolist() == [False, True]
    assert tgp.occupied_at(grid, p[0]).tolist() == [False, False]


def test_pwl_plan_and_sample_match_jax():
    """The failsafe: knots within 1e-5 s, positions within 1e-5 m and
    yaws within 1e-5 at times across and past the plan."""
    g = np.random.default_rng(0)
    wps = g.uniform(-5, 5, (3, 6, 3)).astype(np.float32)
    wps[2, 3] = wps[2, 2]                    # a zero-length segment
    ts = np.linspace(-0.5, 30.0, 97).astype(np.float32)
    tt = tpwl.plan(torch.tensor(wps), 1.5, 2.0)
    tpos, tyaw = tpwl.sample(tt, torch.tensor(ts).expand(3, -1).contiguous())
    for s in range(3):
        jt = jpwl.plan(jnp.asarray(wps[s]), 1.5, 2.0)
        np.testing.assert_allclose(tt.knots[s].numpy(), np.asarray(jt.knots),
                                   atol=1e-5)
        jpos, jyaw = jax.vmap(lambda t: jpwl.sample(jt, t))(ts)
        np.testing.assert_allclose(tpos[s].numpy(), np.asarray(jpos),
                                   atol=1e-5)
        np.testing.assert_allclose(tyaw[s].numpy(), np.asarray(jyaw),
                                   atol=1e-5)
    np.testing.assert_allclose(
        tpwl.discretize(tt, 0.1, 40)[0].numpy(),
        np.asarray(jpwl.discretize(jpwl.plan(jnp.asarray(wps[0]), 1.5, 2.0),
                                   0.1, 40)), atol=1e-5)


def _wall_waypoints():
    """Waypoints of the 8 m wall route (tests/test_ref_builder.py's wall
    world, the RRT's resampled route from (0, 0, 2) with key 1)."""
    sc, grid = jrm.wall_world(0)[:2]
    cfg = _goal_cfg("global")
    e = cfg.engine
    start, goal = np.float32([0, 0, 2]), np.float32(cfg.goal)
    lo = np.minimum(start, goal) - e.ref_bounds_margin
    hi = np.maximum(start, goal) + e.ref_bounds_margin
    lo[2] = max(lo[2], e.ref_z_min)
    rrt = jgp.rrt_plan(grid, start, goal, lo, hi, jax.random.PRNGKey(1),
                       jgp.RRTConfig(max_iters=e.ref_rrt_iters,
                                     incremental_dist=e.ref_rrt_step,
                                     max_shortcut_dist=e.ref_rrt_shortcut))
    path = rrt.path.at[rrt.length].set(goal)
    wps, _ = jrb.resample_path(path, rrt.length + 1, e.ref_waypoints)
    return np.asarray(wps), grid


def _x64_child(inp, out):
    """JAX's dense solve and poly plan in float64 (a child interpreter:
    jax_enable_x64 is process-wide)."""
    jax.config.update("jax_enable_x64", True)
    z = np.load(inp)
    jr = jax.vmap(lambda a, b: jda.solve_dense_qp(
        z["P"], jnp.zeros(z["P"].shape[0]), z["A"], a, b))(z["l"], z["u"])
    jt = jpt.plan(jnp.asarray(z["wps"]), 1.5, jpt.PolyTrajConfig(),
                  corridor_r=jnp.asarray(z["r"]))
    np.savez(out, x=np.asarray(jr.x), prim=np.asarray(jr.prim_res),
             dual=np.asarray(jr.dual_res), coeffs=np.asarray(jt.coeffs),
             times=np.asarray(jt.times))


def test_solve_dense_qp_and_poly_plan_match_jax_in_float64(tmp_path):
    """The corridor min-snap of the 8 m wall route at its full 400
    iterations, both packages in float64 (JAX with x64 in a child
    interpreter): solve_dense_qp's x within 1e-8 (x up to ~8) and its
    residuals within 1e-8 from the same P, q, A, l, u, and poly_traj.plan's
    knot times and coefficients within 1e-8. In float32 the two parts by
    up to 0.35 m on this route (see the module docstring), which the
    float64 run shows is rounding: the algorithms are the same to 5e-11."""
    import os
    import subprocess
    import sys
    wps, _ = _wall_waypoints()
    w64 = torch.tensor(wps, dtype=torch.float64)[None]
    r64 = torch.full((1, wps.shape[0] - 1), 0.5, dtype=torch.float64)
    cap = {}
    solve = tpt.solve_dense_qp

    def spy(P, q, A, l, u, **kw):
        cap.update(P=P[0], A=A[0], l=l, u=u)
        return solve(P, q, A, l, u, **kw)
    tpt.solve_dense_qp = spy
    try:
        tt = tpt.plan(w64, 1.5, tpt.PolyTrajConfig(), corridor_r=r64)
    finally:
        tpt.solve_dense_qp = solve
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, wps=w64[0].numpy(), r=r64[0].numpy(),
             **{k: v.numpy() for k, v in cap.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    subprocess.run([sys.executable, os.path.abspath(__file__), "x64", inp,
                    out], check=True, env=env, cwd=root, timeout=600)
    want = np.load(out)
    B = 3
    P, A = cap["P"], cap["A"]
    tr = tda.solve_dense_qp(P.expand(B, *P.shape),
                            torch.zeros((B, P.shape[0]), dtype=torch.float64),
                            A.expand(B, *A.shape), cap["l"], cap["u"])
    assert tr.x.dtype == torch.float64 and abs(want["x"]).max() > 1.0
    np.testing.assert_allclose(tr.x.numpy(), want["x"], atol=1e-8)
    np.testing.assert_allclose(tr.prim_res.numpy(), want["prim"], atol=1e-8)
    np.testing.assert_allclose(tr.dual_res.numpy(), want["dual"], atol=1e-8)
    np.testing.assert_allclose(tt.times[0].numpy(), want["times"], atol=1e-12)
    np.testing.assert_allclose(tt.coeffs[0].numpy(), want["coeffs"],
                               atol=1e-8)


def test_poly_planner_plan_matches_jax():
    """The corridor-shrink loop on the wall route against the wall map and
    on the 2-waypoint route through the wall (no collision-free polynomial,
    the failsafe): valid and used_failsafe equal, samples within 1e-3 m."""
    wps, grid = _wall_waypoints()
    tgrid = _shared_grid(grid)
    ppcfg = jpp.PolyPlanConfig(poly=jpt.PolyTrajConfig(max_iter=POLY_ITERS),
                               angular_vel=2.0)
    tcfg = tpp.PolyPlanConfig(*ppcfg[:-1], poly=tpt.PolyTrajConfig(
        *ppcfg.poly))
    straight = np.float32([[0, 0, 2], [8, 0, 2]])
    for w in (wps, straight):
        jr = jpp.plan(ppcfg, jnp.asarray(w), 1.5, grid)
        tr = tpp.plan(tcfg, torch.tensor(w)[None], 1.5, tgrid)
        assert bool(tr.valid[0]) == bool(jr.valid)
        assert bool(tr.used_failsafe[0]) == bool(jr.used_failsafe)
        ts = np.linspace(0, 12, 61).astype(np.float32)
        jp = jax.vmap(lambda t: jpp.sample(jr, t))(ts)
        tp = tpp.sample(tr, torch.tensor(ts)[None])
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), atol=1e-3)
    assert bool(tpp.plan(tcfg, torch.tensor(wps)[None], 1.5, tgrid).valid[0])


def test_resample_path_matches_jax():
    g = np.random.default_rng(1)
    path = g.uniform(-3, 3, (4, 16, 3)).astype(np.float32)
    n = np.int32([2, 5, 16, 9])
    tp, tot = trb.resample_path(torch.tensor(path), torch.tensor(n), 12)
    for s in range(4):
        jp, jt = jrb.resample_path(path[s], n[s], 12)
        np.testing.assert_allclose(tp[s].numpy(), np.asarray(jp), atol=1e-5)
        np.testing.assert_allclose(float(tot[s]), float(jt), rtol=1e-6)


def test_linspace_matches_jax_bits():
    """The linspace reference of goal mode is rounded as JAX rounds it."""
    g = np.random.default_rng(2)
    a = (g.normal(size=(16, 3)) * 20).astype(np.float32)
    b = np.float32([105.0, 0.0, 3.0])
    for L in (2, 96, 384):
        j = jax.jit(jax.vmap(lambda s: jnp.linspace(s, jnp.asarray(b), L)))(a)
        t = trb.linspace(torch.tensor(a), torch.tensor(b).expand(16, 3), L)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _goal_cfg(mode, iters=None):
    """The wall world's goal-mode config in the JAX package (the JAX
    ref_modes script's), with the min-snap budget `iters` if given."""
    from intent_mpc_tpu.utils.config import small_config
    cfg = small_config(num_obstacles=1, horizon=10, timeout=2.0,
                       max_obstacles=1, hist=12).replace(goal=(8.0, 0.0, 2.0))
    e = dataclasses.replace(cfg.engine, goal_mode=True, ref_mode=mode,
                            ref_vel=1.5, ref_bounds_margin=2.5,
                            ref_angular_vel=2.0)
    if iters is not None:
        e = dataclasses.replace(e, ref_poly_iters=iters)
    return cfg.replace(engine=e)


@pytest.mark.parametrize("mode", ["global", "minsnap"])
def test_build_goal_ref_matches_jax(mode):
    """The composed input trajectories of four starts on the wall world
    (each with its own RRT key) at ref_poly_iters 20: ref_traj within
    1e-3 m, traj_len, poly_ok and route_ok equal."""
    cfg = _goal_cfg(mode, POLY_ITERS)
    tcfg = trm.wall_cfg(mode, 2.0)
    tcfg = tcfg.replace(engine=dataclasses.replace(tcfg.engine,
                                                   ref_poly_iters=POLY_ITERS))
    _, grid, _ = jrm.wall_world(0)
    starts = np.float32([[0, 0, 2], [1.0, 0.5, 1.8], [2.0, -1.0, 2.2],
                         [-0.5, 0.3, 2.0]])
    keys = [1, 7, 1003, 1004]
    L = 160
    goal = np.float32(cfg.goal)
    jr = jax.jit(jax.vmap(lambda s, k: jrb.build_goal_ref(
        cfg.engine, grid, s, jnp.asarray(goal), k, L)))(
        jnp.asarray(starts), jnp.stack([jax.random.PRNGKey(k) for k in keys]))
    tr = trb.build_goal_ref(tcfg.engine, _shared_grid(grid),
                            torch.tensor(starts), torch.tensor(goal),
                            prng.prng_key(torch.tensor(keys)), L)
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), atol=1e-3)
    for a, b in zip(tr[1:], jr[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if mode == "global":
        assert tr[2].all() and tr[3].all()


def test_wall_world_and_goal_region_match_jax():
    """benchmark/ref_modes.wall_world builds the JAX script's grids and
    scenario; goal_region_occupied agrees with JAX's on goals inside,
    beside and clear of the wall, per scenario of a stacked grid."""
    seeds = (0, 2, 7)
    tsc, tg, gaps = trm.wall_batch(seeds, "cpu")
    goals = np.float32([[8.0, 0.0, 2.0], [4.0, 0.0, 2.0], [3.2, 0.0, 2.0],
                        [4.0, 5.0, 2.0]])
    for i, s in enumerate(seeds):
        jsc, jg, jgap = jrm.wall_world(s)
        np.testing.assert_array_equal(tg.grid[i].numpy(), np.asarray(jg.grid))
        np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
        assert round(float(jgap), 6) == round(float(gaps[i]), 6)
        for f in jsc._fields:
            np.testing.assert_array_equal(getattr(tsc, f)[i].numpy(),
                                          np.asarray(getattr(jsc, f)))
    for goal in goals:
        t = tcl.goal_region_occupied(tg, torch.tensor(goal), len(seeds))
        for i, s in enumerate(seeds):
            j = jcl.goal_region_occupied(jrm.wall_world(s)[1],
                                         jnp.asarray(goal))
            assert bool(t[i]) == bool(j), (s, goal)
    assert tcl.goal_region_occupied(tg, torch.tensor(goals[1]), 3).all()
    assert not tcl.goal_region_occupied(tg, torch.tensor(goals[0]), 3).any()


def test_composed_init_carry_needs_ref_len_as_in_jax():
    """A composed ref_mode without ref_len raises the ValueError of JAX's
    init_carry, with its message; with it the carry holds the allocation."""
    for mode in ("minsnap", "global"):
        jcfg = _goal_cfg(mode)
        jsc = jrm.wall_world(0)[0]
        with pytest.raises(ValueError) as je:
            jcl.init_carry(jcfg, jsc)
        tsc = trm.wall_batch([0], "cpu")[0]
        with pytest.raises(ValueError) as te:
            tcl.init_carry(trm.wall_cfg(mode, 2.0), tsc, device="cpu")
        assert str(te.value) == str(je.value)
        c = tcl.init_carry(trm.wall_cfg(mode, 2.0), tsc, device="cpu",
                           ref_len=96)
        assert c.ref_traj.shape == (1, 96, 3)
        assert c.ref_len.tolist() == [2] and c.need_ref.tolist() == [True]


@pytest.mark.parametrize("mode", ["linspace", "global"])
def test_goal_mode_checkpoint_resumes_bit_exactly(mode, tmp_path):
    """Goal mode on the wall world (two seeds, ref_poly_iters 20 so the
    CPU run stays short): 4 cycles uninterrupted against 2 cycles, a
    checkpoint through engine/checkpoint.py (the composed mode's input
    trajectory, its length and the build flag among the leaves), and 2
    more cycles from the loaded carry: every leaf equal."""
    cfg = trm.wall_cfg(mode, 2.0)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 ref_poly_iters=POLY_ITERS))
    seeds = [0, 1]
    scen, occ, _ = trm.wall_batch(seeds, "cpu")
    L = trm.WALL_L
    ref = torch.zeros((L, 3))
    key = prng.prng_key(torch.tensor([1000 + s for s in seeds]))

    def steps(carry, cycles):
        for i in cycles:
            carry, _ = tcl.episode_step(cfg, scen, ref, L, occ, carry, i,
                                        ref_key=key)
        return carry
    c0 = tcl.init_carry(cfg, scen, device="cpu", ref_len=L)
    whole = steps(c0, range(4))
    half = steps(c0, range(2))
    path = str(tmp_path / "goal")
    ckpt.save_checkpoint(path, half, 2, seeds)
    loaded, cycle, saved, _ = ckpt.load_checkpoint(path, cfg, device="cpu",
                                                   ref_len=L)
    assert cycle == 2 and saved.tolist() == seeds
    resumed = steps(loaded, range(2, 4))
    for a, b in zip(ckpt.flatten(whole), ckpt.flatten(resumed)):
        assert torch.equal(a, b)
    if mode == "global":
        assert not whole.need_ref.any() and (whole.ref_len > 2).all()


if __name__ == "__main__":
    import sys
    if sys.argv[1] == "x64":
        _x64_child(*sys.argv[2:])
