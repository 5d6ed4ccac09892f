"""Port parity: the incremental exploration planner (models/dep.py) against
the JAX package's, on tests/test_dep.py's maps and configuration.

The JAX dep_step runs jitted, as tests/test_dep.py runs it, and the port
on the CPU from the same roadmap and keys. Tolerances: node positions
within 1e-6 m; valid, the gains and the per-yaw gains equal (sums of
ones, exact); the plan's path and viewpoint within 1e-5 m, its score
within 1e-5 relative, its best yaw within 1e-6 rad, its length, gain and
success equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import dep as jd
from intent_mpc_torch.models import dep as td
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.convert import roadmap_from_numpy

torch.set_num_threads(1)

RES = 0.5
ORIGIN = (0.0, 0.0, 0.0)
START = np.float32([1.0, 4.0, 1.5])


def _half_explored_map(wall=False):
    """tests/test_dep.py's map: x below half observed free, the rest
    unobserved; with `wall` an occupied slab at x in [4.5, 5.5) m (so that
    the line-of-sight samples and the edge checks meet occupancy)."""
    lo = np.zeros((24, 16, 6), np.float32)
    lo[:12] = -2.0
    if wall:
        lo[9:11, 2:12, :4] = 3.0
    return lo


def _cfg(**kw):
    """tests/test_dep.py's _cfg()."""
    base = dict(capacity=48, samples_per_step=12, dist_thresh=0.6,
                sensor_range=3.0, connect_radius=3.0, max_path_len=10,
                max_candidates=4, yaw_bins=16)
    base.update(kw)
    return base


def _key(k):
    return torch.as_tensor(np.asarray(k).astype(np.int64))[None]


def _jax_step(jcfg, lo):
    return jax.jit(lambda s, k: jd.dep_step(jcfg, jnp.asarray(lo), ORIGIN,
                                            RES, s, jnp.asarray(START),
                                            jnp.asarray(0.0), k))


def _port_step(tcfg, lo, st, key):
    return td.dep_step(tcfg, torch.as_tensor(lo)[None], ORIGIN, RES, st,
                       torch.as_tensor(START)[None], torch.zeros(1), key)


def _assert_state(js, ts):
    np.testing.assert_allclose(ts.pos[0].numpy(), np.asarray(js.pos),
                               atol=1e-6)
    for f in ("valid", "gain", "yaw_gain"):
        np.testing.assert_array_equal(getattr(ts, f)[0].numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def _assert_plan(jp, tp):
    np.testing.assert_allclose(tp.path[0].numpy(), np.asarray(jp.path),
                               atol=1e-5)
    np.testing.assert_allclose(tp.viewpoint[0].numpy(),
                               np.asarray(jp.viewpoint), atol=1e-5)
    np.testing.assert_allclose(tp.score[0].numpy(), np.asarray(jp.score),
                               rtol=1e-5)
    np.testing.assert_allclose(tp.best_yaw[0].numpy(),
                               np.asarray(jp.best_yaw), atol=1e-6)
    for f in ("path_len", "gain", "success"):
        np.testing.assert_array_equal(getattr(tp, f)[0].numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


@pytest.mark.parametrize("case", ["coarse_4_cycles", "line_of_sight_wall"])
def test_dep_steps_match_jax(case):
    """4 cycles on tests/test_dep.py's map and _cfg() (the roadmap grows
    from 1 to 42 nodes), and 2 cycles with los_samples=3 on the map with
    an occupied wall (no view scores in the first): roadmap and plan
    within the module's tolerances after every cycle."""
    los = case == "line_of_sight_wall"
    kw = _cfg(los_samples=3) if los else _cfg()
    lo = _half_explored_map(wall=los)
    jcfg, tcfg = jd.DEPConfig(**kw), td.DEPConfig(**kw)
    step = _jax_step(jcfg, lo)
    js = jd.dep_init(jcfg, jnp.asarray(START))
    ts = td.dep_init(tcfg, START[None], device="cpu")
    key = jax.random.PRNGKey(0)
    for i in range(2 if los else 4):
        k = jax.random.fold_in(key, i)
        js, jp = step(js, k)
        ts, tp = _port_step(tcfg, lo, ts, _key(k))
        _assert_state(js, ts)
        _assert_plan(jp, tp)
    assert bool(tp.success[0]) and int(ts.valid.sum()) > 10


@pytest.mark.parametrize("los_samples", [0, 3])
def test_windowed_node_gains_equal_jax_dense_count(los_samples):
    """The port counts a window of the map around each node, JAX every
    voxel: on a seeded map of unknown, free and occupied voxels (8 x 6 x 3
    m at 0.5 m, so the sensor window meets the grid's faces), nodes in
    the corners, on the faces, outside the map and inside it, the gains
    and per-yaw gains are equal (the nodes' voxels are off the yaw bins'
    edges)."""
    rng = np.random.default_rng(3)
    lo = rng.choice(np.float32([0.0, -1.5, 2.0]), size=(16, 12, 6),
                    p=[0.5, 0.4, 0.1])
    nodes = np.concatenate([
        np.float32([[0.1, 0.1, 0.1], [7.9, 5.9, 2.9], [0.05, 3.0, 1.5],
                    [4.0, 5.95, 0.2], [-0.5, 2.0, 1.0], [8.6, 3.0, 3.5]]),
        rng.uniform([0, 0, 0], [8, 6, 3], (26, 3)).astype(np.float32)])
    valid = np.ones(len(nodes), bool)
    valid[5] = False
    kw = _cfg(los_samples=los_samples)
    jg, jy = jax.jit(lambda l, n, v: jd.node_gains(
        jd.DEPConfig(**kw), l, jnp.asarray(ORIGIN), RES, n, v))(
            lo, nodes, valid)
    tg, ty = td.node_gains(td.DEPConfig(**kw), torch.as_tensor(lo)[None],
                           ORIGIN, RES, torch.as_tensor(nodes)[None],
                           torch.as_tensor(valid)[None])
    np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ty[0].numpy(), np.asarray(jy))
    assert float(tg.max()) > 0


def test_dep_batch_equals_single_calls():
    """Three explorers (their own maps, starts and keys) as one batch give
    exactly the roadmaps and plans of three single calls, over 2 cycles."""
    cfg = td.DEPConfig(**_cfg())
    maps = torch.stack([torch.as_tensor(_half_explored_map(wall=w))
                        for w in (False, True, False)])
    starts = torch.tensor([[1.0, 4.0, 1.5], [2.0, 6.0, 1.0], [3.0, 2.0, 2.0]])
    yaws = torch.tensor([0.0, 0.5, -1.0])
    keys = prng.prng_key(torch.tensor([4, 9, 2]))
    st = td.dep_init(cfg, starts, device="cpu")
    singles = [td.dep_init(cfg, starts[i:i + 1], device="cpu")
               for i in range(3)]
    for c in range(2):
        st, plan = td.dep_step(cfg, maps, ORIGIN, RES, st, starts, yaws,
                               prng.fold_in(keys, c))
        for i in range(3):
            singles[i], p1 = td.dep_step(
                cfg, maps[i:i + 1], ORIGIN, RES, singles[i],
                starts[i:i + 1], yaws[i:i + 1],
                prng.fold_in(keys[i:i + 1], c))
            for a, b in zip(st + plan, singles[i] + p1):
                assert torch.equal(a[i], b[0])


@pytest.mark.parametrize("batch_axis", [False, True])
def test_roadmap_from_numpy_resumes_a_jax_roadmap(batch_axis):
    """A JAX roadmap after 2 cycles, carried into the port (with or
    without a scenario axis), gives the JAX package's third cycle."""
    kw = _cfg()
    lo = _half_explored_map()
    jcfg = jd.DEPConfig(**kw)
    step = _jax_step(jcfg, lo)
    js = jd.dep_init(jcfg, jnp.asarray(START))
    key = jax.random.PRNGKey(7)
    for i in range(2):
        js, _ = step(js, jax.random.fold_in(key, i))
    tree = jax.tree.map(np.asarray, js)
    if batch_axis:
        tree = jax.tree.map(lambda a: a[None], tree)
    ts = roadmap_from_numpy(tree, device="cpu")
    assert ts.pos.shape == (1, 48, 3) and ts.valid.dtype == torch.bool
    k = jax.random.fold_in(key, 2)
    js, jp = step(js, k)
    ts, tp = _port_step(td.DEPConfig(**kw), lo, ts, _key(k))
    _assert_state(js, ts)
    _assert_plan(jp, tp)


def test_exploration_ends_when_nothing_is_unknown():
    """tests/test_dep.py's fully observed map: no frontier, so no node is
    added and no view succeeds, in both packages."""
    kw = _cfg()
    lo = np.full((24, 16, 6), -2.0, np.float32)
    js, jp = _jax_step(jd.DEPConfig(**kw), lo)(
        jd.dep_init(jd.DEPConfig(**kw), jnp.asarray(START)),
        jax.random.PRNGKey(3))
    cfg = td.DEPConfig(**kw)
    ts, tp = _port_step(cfg, lo, td.dep_init(cfg, START[None], device="cpu"),
                        _key(jax.random.PRNGKey(3)))
    assert int(ts.valid.sum()) == int(js.valid.sum()) == 1
    assert not bool(tp.success[0]) and not bool(jp.success)


@pytest.mark.parametrize("entry", ["dep_init", "roadmap_from_numpy"])
def test_roadmap_entry_points_need_a_card_by_default(entry):
    """Without device=..., dep_init and roadmap_from_numpy build on the
    card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = td.DEPConfig(**_cfg())
    calls = {
        "dep_init": lambda: td.dep_init(cfg, START[None]),
        "roadmap_from_numpy": lambda: roadmap_from_numpy(jax.tree.map(
            np.asarray, jd.dep_init(jd.DEPConfig(**_cfg()),
                                    jnp.asarray(START)))),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
