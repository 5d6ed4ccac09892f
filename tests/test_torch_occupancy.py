"""Port parity: intent_mpc_torch.models.occupancy (the rasterized static
map, the per-scenario grid query, the local static cloud) and the
real_loop script's prebuilt DYNUS map against the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.benchmark import real_loop as jrl
from intent_mpc_tpu.models import occupancy as jocc
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.utils.config import WorldConfig as JWorld
from intent_mpc_torch.benchmark import real_loop as trl
from intent_mpc_torch.models import occupancy as tocc
from intent_mpc_torch.models.world import generate_scenario_numpy
from intent_mpc_torch.utils import convert
from intent_mpc_torch.utils.config import WorldConfig

torch.set_num_threads(1)

WALL = ((-1.0, -4.0, 0.0), (10.0, 8.0, 4.6), 0.2,
        np.array([[3.0, 0.0, 2.0], [6.0, 2.5, 1.0]], np.float32),
        np.array([[0.4, 4.0, 4.0], [1.0, 1.0, 2.0]], np.float32))


def test_build_from_static_obstacles_matches_jax():
    for infl in ((0.3, 0.3, 0.2), (0.0, 0.0, 0.0)):
        want = jocc.build_from_static_obstacles(*WALL, inflation=infl)
        got = tocc.build_from_static_obstacles(*WALL, inflation=infl)
        np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid))
        np.testing.assert_array_equal(got.origin.numpy(),
                                      np.asarray(want.origin))
        assert float(got.resolution) == float(want.resolution)


def test_static_grid_for_matches_jax():
    """The prebuilt DYNUS map of a seed (fixed extents, 560 x 165 x 38 at
    0.2 m), inflated and solid, equals the JAX script's."""
    sc = jworld.generate_scenario(5, JWorld())
    w = generate_scenario_numpy(5, WorldConfig())
    for infl in ((0.3, 0.3, 0.2), (0.0, 0.0, 0.0)):
        want = jrl.static_grid_for(sc, inflation=infl)
        got = trl.static_grid_for(w, inflation=infl)
        assert got.grid.shape == (560, 165, 38)
        np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid))


@pytest.mark.parametrize("center", [(1.0, 0.0, 2.0), (1.3, 0.1, 2.05),
                                    (3.0, 0.0, 2.0), (8.5, 3.5, 4.4)])
def test_local_occupied_points_matches_jax(center):
    """The nearest occupied voxel centers in the window, the same points in
    the same order: a wall symmetric about the query makes equal distances
    the rule, and both keep the lower window index first; the last center
    clamps the window at the grid's corner."""
    g = jocc.build_from_static_obstacles(*WALL, inflation=(0.3, 0.3, 0.2))
    want_p, want_v = jax.jit(functools.partial(
        jocc.local_occupied_points, window=(48, 48, 24), max_points=256))(
        g, jnp.array(center, jnp.float32))
    tg = tocc.build_from_static_obstacles(*WALL, inflation=(0.3, 0.3, 0.2))
    got_p, got_v = tocc.local_occupied_points(
        tg, torch.tensor([center]), (48, 48, 24), 256)
    np.testing.assert_array_equal(got_p[0].numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))
    assert int(want_v.sum()) > 50


def test_per_scenario_queries_equal_a_loop_over_scenarios():
    """A per-scenario grid (S, nx, ny, nz) answers each scenario's points
    from its own grid: is_occupied and local_occupied_points equal the
    queries against each scenario's grid alone."""
    rng = np.random.default_rng(0)
    grids = [tocc.build_from_static_obstacles(
        (-1.0, -4.0, 0.0), (10.0, 8.0, 4.6), 0.2,
        rng.uniform([0, -3, 0], [9, 3, 4], (4, 3)).astype(np.float32),
        rng.uniform(0.3, 2.0, (4, 3)).astype(np.float32), (0.3, 0.3, 0.2))
        for _ in range(3)]
    both = tocc.stack_grids(grids)
    pts = torch.as_tensor(rng.uniform([-2, -5, -1], [10, 5, 5],
                                      (3, 7, 11, 3)).astype(np.float32))
    occ = tocc.is_occupied(both, pts)
    centers = pts[:, 0, 0]
    lp, lv = tocc.local_occupied_points(both, centers, (20, 20, 10), 64)
    for i, g in enumerate(grids):
        assert torch.equal(occ[i], tocc.is_occupied(g, pts[i]))
        p1, v1 = tocc.local_occupied_points(g, centers[i:i + 1],
                                            (20, 20, 10), 64)
        assert torch.equal(lp[i], p1[0]) and torch.equal(lv[i], v1[0])
    assert occ.any() and not occ.all()


def test_grid_from_numpy_stacks_jax_grids():
    gs = [jocc.build_from_static_obstacles(*WALL, inflation=i)
          for i in ((0.3, 0.3, 0.2), (0.0, 0.0, 0.0))]
    got = convert.grid_from_numpy([jax.tree.map(np.asarray, g) for g in gs])
    assert got.grid.shape == (2,) + tuple(gs[0].grid.shape)
    for i, g in enumerate(gs):
        np.testing.assert_array_equal(got.grid[i].numpy(), np.asarray(g.grid))
