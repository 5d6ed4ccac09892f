"""Port parity: the PRM, RRT* and grid wavefront of
models/global_planner.py against the JAX package's on
tests/test_global_planner.py's walled map, and the port's copies of the
slice's configurations.

Tolerances: success and length equal, paths within 1e-5 m (every
decision of the tree and the roadmap follows JAX's); the wavefront's cost
field bit-equal (integers and 1e9), including its roll's wrap around the
grid's faces, which the port carries over from the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import bspline_traj as jbs
from intent_mpc_tpu.models import dep as jdep
from intent_mpc_tpu.models import exploration as jx
from intent_mpc_tpu.models import global_planner as jgp
from intent_mpc_tpu.models import traj_divider as jtd
from intent_mpc_tpu.models.occupancy import (build_from_static_obstacles as
                                             jbuild_grid)
from intent_mpc_torch.models import bspline_traj as tbs
from intent_mpc_torch.models import dep as tdep
from intent_mpc_torch.models import exploration as tx
from intent_mpc_torch.models import global_planner as tgp
from intent_mpc_torch.models import traj_divider as ttd
from intent_mpc_torch.utils import convert, prng

torch.set_num_threads(1)

START = np.float32([1.0, 2.0, 1.5])
GOAL = np.float32([9.0, 2.0, 1.5])
LO = np.float32([0.3, 0.3, 0.5])
HI = np.float32([9.7, 9.7, 2.5])
KEYS = (0, 1, 3)
# RRT* that reaches the goal behind the wall within 128 iterations
STAR_128 = dict(max_iters=128, incremental_dist=1.5, neighborhood_radius=2.5,
                goal_reach_dist=1.0)


@pytest.fixture(scope="module")
def walled_map():
    """tests/test_global_planner.py's map: 10 x 10 x 3 m at 0.25 m, a wall
    at x = 5 leaving a gap at y in [7, 9]."""
    j = jbuild_grid(origin=(0, 0, 0), size_m=(10, 10, 3), resolution=0.25,
                    centers=[[5.0, 3.5, 1.5]], bboxes=[[0.5, 7.0, 3.0]],
                    inflation=[0.2, 0.2, 0.2])
    g = convert.grid_from_numpy(jax.tree.map(np.asarray, j))
    return j, g._replace(grid=g.grid[0])


def _rows(a, S):
    return torch.as_tensor(a).expand(S, *np.shape(a)).contiguous()


def _jax_batch(plan, jgrid, cfg, keys=KEYS):
    f = jax.jit(jax.vmap(lambda k: plan(jgrid, START, GOAL, LO, HI, k, cfg)))
    return jax.tree.map(np.asarray,
                        f(jnp.stack([jax.random.PRNGKey(k) for k in keys])))


def _port_batch(plan, tgrid, cfg, keys=KEYS):
    S = len(keys)
    return plan(tgrid, _rows(START, S), _rows(GOAL, S), _rows(LO, S),
                _rows(HI, S), prng.prng_key(torch.tensor(keys)), cfg)


def _assert_routes(jr, tr):
    np.testing.assert_array_equal(tr.success.numpy(), jr.success)
    np.testing.assert_array_equal(tr.length.numpy(), jr.length)
    np.testing.assert_allclose(tr.path.numpy(), jr.path, atol=1e-5)


def test_prm_matches_jax(walled_map):
    """The PRM at its defaults (258 nodes, 64 relaxations, 64-step descent)
    for three keys as one batch; every route goes through the gap."""
    jgrid, tgrid = walled_map
    jr = _jax_batch(jgp.prm_plan, jgrid, jgp.PRMConfig())
    tr = _port_batch(tgp.prm_plan, tgrid, tgp.PRMConfig())
    _assert_routes(jr, tr)
    assert bool(tr.success.all())
    for i in range(len(KEYS)):
        assert tr.path[i, :int(tr.length[i]), 1].max() > 6.0


@pytest.mark.parametrize("case", ["128_iterations", "800_iterations"])
def test_rrt_star_matches_jax(walled_map, case):
    """RRT* for three keys as one batch: 128 iterations with a 1.5 m step
    (every key reaches the goal), and tests/test_global_planner.py's 800
    iterations at the defaults: success, length and path as JAX's."""
    jgrid, tgrid = walled_map
    kw = STAR_128 if case == "128_iterations" else dict(max_iters=800)
    jr = _jax_batch(jgp.rrt_star_plan, jgrid, jgp.RRTStarConfig(**kw))
    tr = _port_batch(tgp.rrt_star_plan, tgrid, tgp.RRTStarConfig(**kw))
    _assert_routes(jr, tr)
    assert bool(tr.success.all())


def test_rrt_star_batch_equals_single_calls(walled_map):
    """Three problems (their own keys and goals) as one batch give exactly
    the routes of three single calls."""
    _, tgrid = walled_map
    cfg = tgp.RRTStarConfig(**STAR_128)
    goals = torch.tensor([[9.0, 2.0, 1.5], [8.5, 8.0, 1.0], [2.0, 8.0, 2.0]])
    keys = prng.prng_key(torch.tensor([5, 6, 7]))
    args = (_rows(START, 3), goals, _rows(LO, 3), _rows(HI, 3))
    batch = tgp.rrt_star_plan(tgrid, *args, keys, cfg)
    for i in range(3):
        one = tgp.rrt_star_plan(tgrid, *(a[i:i + 1] for a in args),
                                keys[i:i + 1], cfg)
        for a, b in zip(batch, one):
            assert torch.equal(a[i], b[0])


def test_grid_wavefront_bit_equal(walled_map):
    """tests/test_global_planner.py's wavefront (120 iterations toward
    voxel (36, 8, 6)) on the walled map, two goals as one batch: the cost
    fields equal JAX's exactly."""
    jgrid, _ = walled_map
    goals = [(36, 8, 6), (4, 30, 2)]
    want = np.stack([np.asarray(jgp.grid_wavefront(jgrid.grid, (0, 0, 0), g,
                                                   iters=120))
                     for g in goals])
    grid = torch.as_tensor(np.array(jgrid.grid))[None].expand(2, -1, -1, -1)
    got = tgp.grid_wavefront(grid, torch.tensor(goals), 120).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 36, 8, 6] == 0.0 and got[0, 20, 14, 6] == 1e9


def test_grid_wavefront_wraps_around_the_grid_as_jax_does():
    """A wall across the whole grid at x = 5 leaves the voxels beyond it no
    route inside the grid, yet both packages reach them through the roll's
    wrap from face x = 0 to face x = 19: x = 18 costs 3 steps from the goal
    at x = 1 (1 -> 0 -> 19 -> 18)."""
    occ = np.zeros((20, 6, 4), np.int8)
    occ[5] = 1
    want = np.asarray(jgp.grid_wavefront(jnp.asarray(occ), (0, 0, 0),
                                         (1, 2, 1), iters=40))
    got = tgp.grid_wavefront(torch.as_tensor(occ)[None],
                             torch.tensor([[1, 2, 1]]), 40)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got[18, 2, 1] == 3.0 and got[5, 2, 1] == 1e9


@pytest.mark.parametrize("pair", [
    (jx.ExplorationConfig, tx.ExplorationConfig),
    (jdep.DEPConfig, tdep.DEPConfig),
    (jgp.PRMConfig, tgp.PRMConfig),
    (jgp.RRTStarConfig, tgp.RRTStarConfig),
    (jbs.BsplineConfig, tbs.BsplineConfig),
    (jtd.DividerParams, ttd.DividerParams)],
    ids=lambda p: p[0].__name__)
def test_config_copies_equal_jax(pair):
    """The port's copy of each configuration of the slice has JAX's fields,
    in its order, with equal defaults (DEPConfig's nested
    ExplorationConfig field by field)."""
    j, t = pair
    assert j._fields == t._fields
    for f, a, b in zip(j._fields, j(), t()):
        if hasattr(a, "_fields"):
            assert tuple(a) == tuple(b) and a._fields == b._fields, f
        else:
            assert a == b, f
