"""Port parity: intent_mpc_torch.models.clustering (DBSCAN, the 2-means
split, the orientation sweep and the refinement tree) against the JAX
package's jitted functions on numpy-seeded point clouds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import clustering as jclus
from intent_mpc_tpu.models import occupancy as jocc
from intent_mpc_torch.models import clustering as tclus
from intent_mpc_torch.utils import trace

torch.set_num_threads(1)


def _blobs(rng):
    a = rng.normal([0.0, 0.0, 1.0], 0.15, (40, 3))
    b = rng.normal([3.0, 1.0, 1.0], 0.15, (40, 3))
    return np.concatenate([a, b, rng.uniform(-5, 5, (20, 3))])


def _chain(rng):
    """200 points 0.3 m apart on a line, shuffled: the minimum index must
    travel the whole chain (about 200 rounds of plain min-label
    propagation)."""
    t = np.arange(200) * 0.3
    pts = np.stack([t, np.zeros(200), np.zeros(200)], axis=-1)
    return pts[rng.permutation(200)]


def _duplicates(rng):
    a = rng.normal([0.0, 0.0, 1.0], 0.2, (30, 3))
    return np.concatenate([a, a, a[:10]])


CLOUDS = {"blobs": (_blobs, 5), "noise": (lambda r: r.uniform(-5, 5, (100, 3)), 5),
          "chain": (_chain, 2), "duplicates": (_duplicates, 5)}


@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_dbscan_labels_match_jax(cloud):
    """Equal labels (the minimum core index of each cluster, -1 noise),
    the last three points masked invalid but on the chain; the host reads
    the changed flag once per block of rounds."""
    make, min_pts = CLOUDS[cloud]
    pts = make(np.random.default_rng(0)).astype(np.float32)
    valid = np.ones(len(pts), bool)
    if cloud != "chain":
        valid[-3:] = False
    want = np.asarray(jax.jit(jclus.dbscan, static_argnames=(
        "eps", "min_pts"))(pts, valid, eps=0.5, min_pts=min_pts))
    trace.reset("clustering.host_reads", "clustering.rounds")
    got = tclus.dbscan(torch.as_tensor(pts)[None], torch.as_tensor(valid)[None],
                       0.5, min_pts)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert got.dtype == torch.int32
    counts = trace.counters()
    reads = counts["clustering.host_reads"]
    assert counts["clustering.rounds"] == tclus.DBSCAN_BLOCK * reads
    if cloud == "chain":
        assert len(set(want.tolist())) == 1          # one cluster
        assert reads > 1


def test_dbscan_batched_rows_equal_single_rows():
    """A batch of clouds labels each cloud as it is labelled alone, though
    the batch runs as many rounds as its slowest cloud."""
    rng = np.random.default_rng(1)
    clouds = [_chain(rng)[:150], _blobs(rng)[:150], _duplicates(rng)[:70]]
    pts = np.zeros((3, 150, 3), np.float32)
    valid = np.zeros((3, 150), bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)] = c
        valid[i, :len(c)] = True
    both = tclus.dbscan(torch.as_tensor(pts), torch.as_tensor(valid), 0.5, 2)
    for i in range(3):
        one = tclus.dbscan(torch.as_tensor(pts[i:i + 1]),
                           torch.as_tensor(valid[i:i + 1]), 0.5, 2)
        assert torch.equal(both[i], one[0])


def test_kmeans_split_matches_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal([0, 0, 1], 0.3, (60, 3)),
                          rng.normal([2, 1, 1], 0.3, (60, 3))]).astype(
        np.float32)
    w = (rng.uniform(size=120) < 0.8).astype(np.float32)
    ja, jb = jax.jit(lambda p, w: jclus.kmeans_split(p, w, 10))(pts, w)
    ta, tb = tclus.kmeans_split(torch.as_tensor(pts)[None],
                                torch.as_tensor(w)[None, None], 10)
    np.testing.assert_array_equal(ta[0, 0].numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb[0, 0].numpy(), np.asarray(jb))


def _wall_cloud():
    g = jocc.build_from_static_obstacles(
        (-1.0, -4.0, 0.0), (10.0, 8.0, 4.6), 0.2,
        np.array([[3.0, 0.0, 2.0]], np.float32),
        np.array([[0.4, 4.0, 4.0]], np.float32), inflation=(0.3, 0.3, 0.2))
    pts, valid = jax.jit(functools.partial(
        jocc.local_occupied_points, window=(48, 48, 24), max_points=256))(
        g, jnp.array([1.0, 0.0, 2.0]))
    return np.array(pts), np.array(valid)


def _rotated_box_cloud():
    rng = np.random.default_rng(3)

    def box(n, c, size, yaw):
        p = rng.uniform(-0.5, 0.5, (n, 3)) * size
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        return p @ R.T + c
    pts = np.concatenate([box(200, [2, 1, 1], [3, 0.6, 1.5], 0.5),
                          box(150, [-2, -1, 1], [0.5, 2.5, 1], -0.3),
                          np.zeros((162, 3))]).astype(np.float32)
    return pts, np.arange(512) < 350


def _canonical(size, yaw):
    """A rotated box as (x extent, y extent, yaw mod pi/2): the orientation
    sweep's angles a and a + pi/2 describe the same box with x and y
    swapped, and their densities are equal up to rounding."""
    q = np.floor(yaw / (np.pi / 2))
    swap = (q % 2 == 1)[..., None]
    sxy = np.where(swap, size[..., [1, 0]], size[..., 0:2])
    return np.concatenate([sxy, size[..., 2:3]], -1), yaw - q * np.pi / 2


@pytest.mark.parametrize("cloud", ["wall", "rotated_box"])
def test_cluster_obstacles_matches_jax(cloud):
    """The engine's clustering config on a voxel wall (the local static
    cloud of a map) and on two rotated boxes: active slots equal; centroid
    within 1e-5; size and yaw within 1e-5 as boxes, where the orientation
    sweep's two equal-density angles a and a + pi/2 (same box, x and y
    extents swapped) may split differently on float32 rounding."""
    pts, valid = _wall_cloud() if cloud == "wall" else _rotated_box_cloud()
    kw = dict(max_clusters=4, tree_level=2, min_pts=8)
    want = jax.jit(lambda p, v: jclus.cluster_obstacles(
        jclus.ClusteringConfig(**kw), p, v))(pts, valid)
    got = tclus.cluster_obstacles(tclus.ClusteringConfig(**kw),
                                  torch.as_tensor(pts)[None],
                                  torch.as_tensor(valid)[None])
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active[0].numpy(), act)
    assert act.sum() >= 2
    np.testing.assert_allclose(got.centroid[0].numpy()[act],
                               np.asarray(want.centroid)[act], atol=1e-5)
    ts, ty = _canonical(got.size[0].numpy()[act], got.yaw[0].numpy()[act])
    js, jy = _canonical(np.asarray(want.size)[act],
                        np.asarray(want.yaw)[act])
    np.testing.assert_allclose(ts, js, atol=1e-5)
    np.testing.assert_allclose(ty, jy, atol=1e-5)


def test_engine_slots_and_batch_rows():
    """The engine's config gives cluster_slots = 4 * 2^2 = 16 slots, and a
    batch of two clouds clusters each as it clusters alone."""
    (wp, wv), (rp, rv) = _wall_cloud(), _rotated_box_cloud()
    ccfg = tclus.ClusteringConfig(max_clusters=4, tree_level=2, min_pts=8)
    pts = torch.as_tensor(np.stack([wp, rp[:256]]))
    valid = torch.as_tensor(np.stack([wv, rv[:256]]))
    both = tclus.cluster_obstacles(ccfg, pts, valid)
    assert both.centroid.shape == (2, 16, 3)
    for i in range(2):
        one = tclus.cluster_obstacles(ccfg, pts[i:i + 1], valid[i:i + 1])
        for a, b in zip(both, one):
            assert torch.equal(a[i], b[0])
