"""Port parity: the octree map (intent_mpc_torch.models.octo) and the
planners over it (global_planner.occupied_at's OctoMap branch) against the
JAX package's models/octo.py on the same maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import global_planner as jgp
from intent_mpc_tpu.models import mapping as jmap
from intent_mpc_tpu.models import octo as jocto
from intent_mpc_tpu.models import occupancy as jocc
from intent_mpc_torch.models import global_planner as tgp
from intent_mpc_torch.models import mapping as tmap
from intent_mpc_torch.models import octo as tocto
from intent_mpc_torch.models import occupancy as tocc
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.convert import (grid_from_numpy, map_from_numpy,
                                            octo_from_numpy)

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def _wall_log_odds():
    """tests/test_octo.py's 6 x 6 x 3 m map at 0.3 m: everything observed
    free except a wall slab at x in [2.4, 3.0) and an unobserved block at
    y in [4.5, 6.0), the wall inside it unknown too."""
    cfg = jmap.MappingConfig(resolution=0.3)
    m = jmap.init_map((0.0, 0.0, 0.0), (6.0, 6.0, 3.0), cfg)
    lo = np.zeros(m.log_odds.shape, np.float32)
    lo[:] = cfg.l_min
    lo[8:10, :, :] = cfg.l_max
    lo[:, 15:, :] = 0.0
    lo[8:10, 15:, :] = 0.0
    return cfg, m._replace(log_odds=jnp.asarray(lo))


def _maps(levels=3, ignore_unknown=True):
    """(JAX OctoMap, port OctoMap) of the wall map."""
    cfg, m = _wall_log_odds()
    jo = jocto.from_log_odds(m, cfg, levels=levels,
                             ignore_unknown=ignore_unknown)
    tcfg = tmap.MappingConfig(resolution=0.3)
    tm = map_from_numpy(jmap.LogOddsMap(*(np.asarray(x) for x in m)))
    return jo, tocto.from_log_odds(tm, tcfg, levels=levels,
                                   ignore_unknown=ignore_unknown)


def _jax_blocked(jo, pts):
    """JAX's is_blocked with the pyramid passed as jit arguments (so the
    resolution is a run-time divisor, as in the port)."""
    ign = jo.ignore_unknown
    f = jax.jit(lambda lo, lu, org, res, p: jocto.is_blocked(
        jocto.OctoMap(lo, lu, org, res, ign), p))
    return np.asarray(f(jo.levels_occ, jo.levels_unk, jo.origin,
                        jo.resolution, pts))


def _random_points(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform([-1.0, -1.0, -0.5], [7.0, 7.0, 3.5],
                       (n, 3)).astype(np.float32)


@pytest.mark.parametrize("ignore_unknown", [True, False])
def test_tri_state_point_queries(ignore_unknown):
    """is_blocked equals JAX's on 2000 seeded points in and around the map;
    free, wall, unknown and out-of-map points answer as tests/test_octo.py
    reads them (out-of-map and unknown blocked only for the conservative
    map)."""
    jo, to = _maps(ignore_unknown=ignore_unknown)
    pts = _random_points(0, 2000)
    got = tocto.is_blocked(to, T(pts)[None])[0].numpy()
    np.testing.assert_array_equal(got, _jax_blocked(jo, pts))
    q = T([[1.0, 1.0, 1.0], [2.6, 1.0, 1.0], [1.0, 5.0, 1.0],
           [-5.0, 1.0, 1.0]])[None]
    want = [False, True, not ignore_unknown, not ignore_unknown]
    assert tocto.is_blocked(to, q)[0].tolist() == want


def test_pyramid_inner_max_policy():
    """The port's pyramids equal JAX's level by level, and a coarse cell is
    occupied iff a base voxel below it is (octomap inner-node max)."""
    jo, to = _maps(levels=3)
    for lvl in range(3):
        np.testing.assert_array_equal(to.levels_occ[lvl][0].numpy(),
                                      np.asarray(jo.levels_occ[lvl]))
        np.testing.assert_array_equal(to.levels_unk[lvl][0].numpy(),
                                      np.asarray(jo.levels_unk[lvl]))
    base = to.levels_occ[0][0].numpy()
    for lvl in (1, 2):
        s = 1 << lvl
        c = to.levels_occ[lvl][0].numpy()
        blk = base.reshape(c.shape[0], s, c.shape[1], s, c.shape[2], s)
        np.testing.assert_array_equal(c, blk.max(axis=(1, 3, 5)))


def test_search_depth_levels():
    """search at levels 0-2 equals JAX's on seeded points; the free voxel
    beside the wall is free at level 0 and occupied at level 2."""
    jo, to = _maps(levels=3)
    pts = _random_points(1, 500)
    f = jax.jit(lambda lo, lu, org, res, p, l: jocto.search(
        jocto.OctoMap(lo, lu, org, res, True), p, l), static_argnums=5)
    for lvl in range(3):
        got = tocto.search(to, T(pts)[None], lvl)
        want = f(jo.levels_occ, jo.levels_unk, jo.origin, jo.resolution,
                 pts, lvl)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    p = T([[3.15, 1.0, 1.0]])[None]
    assert int(tocto.search(to, p, 0)[0]) == 0
    assert int(tocto.search(to, p, 2)[0]) == 1
    assert int(tocto.search(to, T([[0.5, 1.0, 1.0]])[None], 2)[0]) == 0


@pytest.mark.parametrize("ignore_unknown", [True, False])
def test_segment_free_and_box_blocked_match_jax(ignore_unknown):
    """segment_free (coarse pass and fine pass selected per segment) and
    box_blocked equal JAX's on seeded segments and points; through the wall
    blocked, along it free."""
    jo, to = _maps(ignore_unknown=ignore_unknown)
    rng = np.random.default_rng(2)
    a = rng.uniform([0.2, 0.2, 0.3], [5.8, 5.8, 2.7], (300, 3)) \
        .astype(np.float32)
    b = rng.uniform([0.2, 0.2, 0.3], [5.8, 5.8, 2.7], (300, 3)) \
        .astype(np.float32)
    ign = jo.ignore_unknown
    args = (jo.levels_occ, jo.levels_unk, jo.origin, jo.resolution)
    seg = jax.jit(jax.vmap(lambda lo, lu, org, res, a, b: jocto.segment_free(
        jocto.OctoMap(lo, lu, org, res, ign), a, b, checks=32),
        in_axes=(None, None, None, None, 0, 0)))
    got = tocto.segment_free(to, T(a)[None], T(b)[None], checks=32)[0]
    want = np.asarray(seg(*args, a, b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)
    box = jax.jit(jax.vmap(lambda lo, lu, org, res, p: jocto.box_blocked(
        jocto.OctoMap(lo, lu, org, res, ign), p, (0.8, 0.8, 0.4), 4),
        in_axes=(None, None, None, None, 0)))
    got = tocto.box_blocked(to, T(a), (0.8, 0.8, 0.4), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(box(*args, a)))
    p0 = T([[0.5, 1.0, 1.0]])
    assert not bool(tocto.segment_free(to, p0, T([[5.5, 1.0, 1.0]]), 32)[0])
    assert bool(tocto.segment_free(to, p0, T([[0.5, 3.5, 1.0]]), 32)[0])
    assert bool(tocto.box_blocked(to, T([[2.1, 1.0, 1.0]]), (0.8, 0.8, 0.4),
                                  4)[0])
    assert not bool(tocto.box_blocked(to, T([[1.0, 1.0, 1.0]]),
                                      (0.8, 0.8, 0.4), 4)[0])


def test_cast_ray_first_hit():
    """First blocked sample along seeded rays equals JAX's; the ray at
    the wall hits its front face (x in [2.3, 2.8])."""
    jo, to = _maps()
    rng = np.random.default_rng(3)
    a = rng.uniform([0.2, 0.2, 0.3], [2.0, 5.8, 2.7], (64, 3)) \
        .astype(np.float32)
    b = rng.uniform([3.2, 0.2, 0.3], [5.8, 5.8, 2.7], (64, 3)) \
        .astype(np.float32)
    a[0], b[0] = [0.5, 1.0, 1.0], [5.5, 1.0, 1.0]
    f = jax.jit(jax.vmap(lambda lo, lu, org, res, a, b: jocto.cast_ray(
        jocto.OctoMap(lo, lu, org, res, True), a, b),
        in_axes=(None, None, None, None, 0, 0)))
    jh, jp = f(jo.levels_occ, jo.levels_unk, jo.origin, jo.resolution, a, b)
    hit, p = tocto.cast_ray(to._replace(levels_occ=tuple(
        l.expand(64, -1, -1, -1) for l in to.levels_occ), levels_unk=tuple(
        l.expand(64, -1, -1, -1) for l in to.levels_unk)), T(a), T(b))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert bool(hit[0]) and 2.3 <= float(p[0, 0]) <= 2.8


def _rrt_both(jo, to, start, goal, keys, rcfg, lo, hi):
    S = len(keys)
    f = jax.jit(jax.vmap(lambda k: jgp.rrt_plan(jo, start, goal, lo, hi, k,
                                                rcfg)))
    jr = f(jnp.stack([jax.random.PRNGKey(k) for k in keys]))

    def b(x):
        return T(np.asarray(x, np.float32)).expand(S, 3).contiguous()
    tr = tgp.rrt_plan(to, b(start), b(goal), b(lo), b(hi),
                      prng.prng_key(torch.tensor(keys)), tgp.RRTConfig(*rcfg))
    return jr, tr


def test_rrt_unknown_space_semantics():
    """With the wall's gap inside the unknown block the optimistic map
    (ignore_unknown) routes through it and the conservative one finds no
    route (rrtOctomap ignoreUnknown_); paths, lengths and successes equal
    JAX's with the same threefry keys, paths within 1e-6 m."""
    cfg, m = _wall_log_odds()
    start = np.array([1.0, 5.2, 1.0], np.float32)
    goal = np.array([5.0, 5.2, 1.0], np.float32)
    rcfg = jgp.RRTConfig(max_iters=400, incremental_dist=0.4)
    lo, hi = (0.2, 0.2, 0.4), (5.8, 5.8, 2.6)
    tm = map_from_numpy(jmap.LogOddsMap(*(np.asarray(x) for x in m)))
    tcfg = tmap.MappingConfig(resolution=0.3)
    keys = [0, 1, 2]
    out = {}
    for ign in (True, False):
        jo = jocto.from_log_odds(m, cfg, levels=3, ignore_unknown=ign)
        to = tocto.from_log_odds(tm, tcfg, levels=3, ignore_unknown=ign)
        jr, tr = _rrt_both(jo, to, start, goal, keys, rcfg, lo, hi)
        np.testing.assert_array_equal(tr.success.numpy(),
                                      np.asarray(jr.success))
        np.testing.assert_array_equal(tr.length.numpy(),
                                      np.asarray(jr.length))
        np.testing.assert_allclose(tr.path.numpy(), np.asarray(jr.path),
                                   rtol=0, atol=1e-6)
        out[ign] = tr.success
    assert bool(out[True][0]) and not bool(out[False].any())


def test_from_occupancy_grid_matches_grid_queries():
    """An octree wrapping a grid answers as the grid (and as JAX's octree)
    on 256 seeded points; occupied_at dispatches to both backends alike."""
    args = dict(origin=(0, 0, 0), size_m=(4.0, 4.0, 2.0), resolution=0.2,
                centers=[(2.0, 2.0, 1.0)], bboxes=[(0.6, 0.6, 0.6)],
                inflation=(0.2, 0.2, 0.2))
    jg = jocc.build_from_static_obstacles(**args)
    g = tocc.build_from_static_obstacles(**args)
    o = tocto.from_occupancy_grid(g, levels=3)
    jo = jocto.from_occupancy_grid(jg, levels=3)
    pts = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (256, 3))
                     * jnp.array([4.0, 4.0, 2.0]))
    occ = tocc.is_occupied(g, T(pts))
    np.testing.assert_array_equal(tocto.is_blocked(o, T(pts)[None])[0],
                                  occ)
    np.testing.assert_array_equal(occ.numpy(), _jax_blocked(jo, pts))
    np.testing.assert_array_equal(tgp.occupied_at(o, T(pts)[None])[0],
                                  tgp.occupied_at(g, T(pts)))
    assert occ.any()
    per = grid_from_numpy([jg, jg])
    o2 = tocto.from_occupancy_grid(per, levels=3)
    assert o2.levels_occ[0].shape[0] == 2


def test_poly_planner_accepts_octo_backend():
    """polyTrajOctomap's role: the min-snap corridor planner runs over the
    octree through occupied_at, as JAX's does: a route clear of the wall
    is valid in both packages, one through it is not."""
    from intent_mpc_tpu.models import poly_planner as jpp
    from intent_mpc_torch.models import poly_planner as tpp
    jo, to = _maps()
    wps = np.array([[[0.5, 1.0, 1.0], [0.5, 5.0, 1.0]],
                    [[0.5, 1.0, 1.0], [5.5, 1.0, 1.0]]], np.float32)
    res = tpp.plan(tpp.PolyPlanConfig(), T(wps), desired_vel=1.0,
                   occ=to._replace(levels_occ=tuple(
                       l.expand(2, -1, -1, -1) for l in to.levels_occ),
                       levels_unk=tuple(l.expand(2, -1, -1, -1)
                                        for l in to.levels_unk)))
    want = [bool(jpp.plan(jpp.PolyPlanConfig(), jnp.asarray(w),
                          desired_vel=1.0, occ=jo).valid) for w in wps]
    assert res.valid.tolist() == want == [True, False]


def test_octo_carries_across_packages():
    """octo_from_numpy stacks JAX pyramids into one port batch unchanged."""
    jo, to = _maps()
    npo = jocto.OctoMap(tuple(np.asarray(l) for l in jo.levels_occ),
                        tuple(np.asarray(l) for l in jo.levels_unk),
                        np.asarray(jo.origin), np.asarray(jo.resolution),
                        jo.ignore_unknown)
    o2 = octo_from_numpy([npo, npo])
    for a, b in zip(o2.levels_occ + o2.levels_unk,
                    to.levels_occ + to.levels_unk):
        assert a.shape[0] == 2 and torch.equal(a[1], b[0])
    assert o2.resolution == to.resolution


def test_rrt_over_mapped_octree_matches_jax():
    """The slice's path from camera to route: 6 depth frames of a seeded
    box world rendered along a line, each package projecting them and
    integrating its own 10 x 6 x 3 m log-odds map at 0.2 m, an octree of
    each map in both semantics, and the RRT over it to a goal 8 m ahead.
    The log-odds are bit-equal to JAX's, and the routes' paths (within
    1e-6 m), lengths and successes equal; the conservative map has no
    route through the unobserved space beyond the camera's reach."""
    from intent_mpc_tpu.models import perception as jpc
    from intent_mpc_tpu.models import real_detector as jrd
    from intent_mpc_tpu.models import sensor as jsen
    from intent_mpc_tpu.utils.config import RealDetectorConfig as JRD
    from intent_mpc_torch.models import perception as tpc
    from intent_mpc_torch.models import real_detector as trd
    from intent_mpc_torch.utils.config import RealDetectorConfig as TRD
    rd = JRD()
    intr, tintr = jrd.intrinsics(rd), trd.intrinsics(TRD())
    rng = np.random.default_rng(7)
    cen = rng.uniform([3.0, 0.5, 0.5], [9.0, 5.5, 2.5], (6, 3)) \
        .astype(np.float32)
    size = rng.uniform(0.4, 1.2, (6, 3)).astype(np.float32)
    R = np.asarray(jsen.yaw_camera_rotation(jnp.asarray(0.0)))
    render = jax.jit(lambda c: jsen.render_depth(
        intr, rd.im_h, rd.im_w, c, R, cen, size, jnp.ones(6, bool),
        max_depth=rd.depth_max))
    project = jax.jit(lambda d, c: jpc.project_depth(intr, d, c, R))
    integ = jax.jit(jmap.integrate_cloud, static_argnums=(0,))
    cfg = tmap.MappingConfig(resolution=0.2)
    jcfg = jmap.MappingConfig(resolution=0.2)
    m = tmap.init_map((0.0, 0.0, 0.0), (10.0, 6.0, 3.0), cfg, device="cpu")
    jm = jmap.init_map((0.0, 0.0, 0.0), (10.0, 6.0, 3.0), jcfg)
    for f in range(6):
        cam = np.array([0.5 + 0.3 * f, 3.0, 1.5], np.float32)
        depth = np.asarray(render(cam))
        jp, jv = project(depth, cam)
        jm = integ(jcfg, jm, cam, jp, jv)
        tp, tv = tpc.project_depth(tintr, T(depth)[None], T(cam)[None],
                                   T(R)[None])
        m = tmap.integrate_cloud(cfg, m, T(cam)[None], tp, tv)
    np.testing.assert_array_equal(m.log_odds[0].numpy(),
                                  np.asarray(jm.log_odds))
    assert (m.log_odds > 0).sum() > 20
    start = np.array([2.0, 3.0, 1.5], np.float32)
    goal = np.array([9.5, 3.0, 1.5], np.float32)
    rcfg = jgp.RRTConfig(max_iters=600, incremental_dist=0.5)
    keys = [3, 4]
    succ = {}
    for ign in (True, False):
        jo = jocto.from_log_odds(jm, jcfg, levels=3, ignore_unknown=ign)
        to = tocto.from_log_odds(m, cfg, levels=3, ignore_unknown=ign)
        jr, tr = _rrt_both(jo, to, start, goal, keys, rcfg, (0.2, 0.2, 0.4),
                           (9.8, 5.8, 2.6))
        np.testing.assert_array_equal(tr.success.numpy(),
                                      np.asarray(jr.success))
        np.testing.assert_array_equal(tr.length.numpy(),
                                      np.asarray(jr.length))
        np.testing.assert_allclose(tr.path.numpy(), np.asarray(jr.path),
                                   rtol=0, atol=1e-6)
        succ[ign] = tr.success
    assert bool(succ[True].all()) and not bool(succ[False].any())
