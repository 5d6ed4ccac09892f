"""Port parity: the log-odds mapper (intent_mpc_torch.models.mapping)
against the JAX package's models/mapping.py on numpy-seeded inputs.

The JAX functions run jitted with the map as an argument (so its
resolution is a run-time divisor, as when the map is carried through a
jitted loop). Log-odds are held bit-equal: the port computes each ray
sample's voxel with the CPU program's rounding (utils/rounding.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import mapping as jmap
from intent_mpc_tpu.models import perception as jpc
from intent_mpc_tpu.models import sensor as jsen
from intent_mpc_torch.models import mapping as tmap
from intent_mpc_torch.models import occupancy as tocc
from intent_mpc_torch.models import perception as tpc
from intent_mpc_torch.utils.convert import map_from_numpy

torch.set_num_threads(1)

CFG = tmap.MappingConfig(resolution=0.2, robot_size=(0.4, 0.4, 0.2))
JCFG = jmap.MappingConfig(resolution=0.2, robot_size=(0.4, 0.4, 0.2))

_integrate = jax.jit(jmap.integrate_cloud, static_argnums=(0, 5))


def T(a):
    return torch.as_tensor(np.array(a))


def _np_map(m):
    return jmap.LogOddsMap(*(np.asarray(x) for x in m))


def _clouds(seed, S, frames, P):
    """Rays from seeded sensor origins to seeded points, some beyond the
    5 m range, some outside the map, some invalid."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([0.5, 0.5, 0.5], [2.5, 5.5, 2.5],
                    (frames, S, 3)).astype(np.float32)
    p = rng.uniform([-0.5, -0.5, -0.2], [8.5, 6.5, 3.2],
                    (frames, S, P, 3)).astype(np.float32)
    v = rng.uniform(0, 1, (frames, S, P)) > 0.1
    return o, p, v


@pytest.mark.parametrize("res,S,F,P", [(0.2, 3, 6, 300), (0.05, 2, 3, 2000)])
def test_log_odds_bit_equal_to_jax_over_frames(res, S, F, P):
    """F frames of P seeded rays into S scenarios' 8 x 6 x 3 m maps: the
    log-odds equal JAX's bit for bit after every frame (each scenario
    against JAX on that scenario's frames). At 0.05 m the samples no longer
    cover each voxel twice, so a sample whose voxel the rounding moves
    shows: the fused ray end (a rounding JAX's program does not use at
    these sizes) parts the two maps by 4 voxels there."""
    cfg, jcfg = CFG._replace(resolution=res), JCFG._replace(resolution=res)
    o, p, v = _clouds(0, S, F, P)
    tm = tmap.init_map((0.0, 0.0, 0.0), (8.0, 6.0, 3.0), cfg, batch=S,
                       device="cpu")
    jms = [jmap.init_map((0.0, 0.0, 0.0), (8.0, 6.0, 3.0), jcfg)
           for _ in range(S)]
    for f in range(F):
        tm = tmap.integrate_cloud(cfg, tm, T(o[f]), T(p[f]), T(v[f]))
        for s in range(S):
            jms[s] = _integrate(jcfg, jms[s], o[f, s], p[f, s], v[f, s], 64)
            np.testing.assert_array_equal(tm.log_odds[s].numpy(),
                                          np.asarray(jms[s].log_odds))
    lo = tm.log_odds.numpy()
    assert (lo > 0).sum() > 50 and (lo < 0).sum() > 1000


def test_integration_marks_hits_and_misses():
    """A wall of points at x = 4 integrated 4 times: the hit voxel is
    occupied, the free space along the ray free, log-odds within [l_min,
    l_max]; bit-equal to JAX."""
    m = tmap.init_map((0, 0, 0), (6, 4, 2), CFG, device="cpu")
    jm = jmap.init_map((0, 0, 0), (6, 4, 2), JCFG)
    origin = np.array([0.5, 2.0, 1.0], np.float32)
    ys = np.linspace(0.5, 3.5, 30).astype(np.float32)
    pts = np.stack([np.full_like(ys, 4.0), ys, np.full_like(ys, 1.0)], -1)
    valid = np.ones(30, bool)
    for _ in range(4):
        m = tmap.integrate_cloud(CFG, m, T(origin)[None], T(pts)[None],
                                 T(valid)[None])
        jm = _integrate(JCFG, jm, origin, pts, valid, 64)
    np.testing.assert_array_equal(m.log_odds[0].numpy(),
                                  np.asarray(jm.log_odds))
    occ = tmap.occupancy(CFG, m)[0].numpy()
    res = 0.2
    assert occ[int(4.0 / res), int(2.0 / res), int(1.0 / res)] == 1
    assert occ[int(2.0 / res), int(2.0 / res), int(1.0 / res)] == 0
    lo = m.log_odds.numpy()
    assert lo.max() <= CFG.l_max + 1e-5 and lo.min() >= CFG.l_min - 1e-5
    np.testing.assert_array_equal(occ, np.asarray(jmap.occupancy(JCFG, jm)))


@pytest.mark.parametrize("robot", [(0.4, 0.4, 0.2), (0.5, 0.5, 0.3)])
def test_inflation_matches_jax(robot):
    """The max-pool inflation of a seeded sparse grid equals JAX's; a
    single voxel grows by the robot box (0.4 m -> one voxel each side)."""
    cfg = CFG._replace(robot_size=robot)
    jcfg = JCFG._replace(robot_size=robot)
    rng = np.random.default_rng(1)
    occ = (rng.uniform(0, 1, (2, 20, 18, 10)) > 0.97).astype(np.int8)
    got = tmap.inflate(cfg, T(occ), 0.2).numpy()
    for s in range(2):
        np.testing.assert_array_equal(
            got[s], np.asarray(jmap.inflate(jcfg, jnp.asarray(occ[s]), 0.2)))
    one = np.zeros((1, 20, 20, 10), np.int8)
    one[0, 10, 10, 5] = 1
    inf = tmap.inflate(CFG, T(one), 0.2)[0].numpy()
    assert inf[10, 10, 5] == 1 and inf[9, 10, 5] == 1 and inf[11, 10, 5] == 1
    assert inf[7, 10, 5] == 0


def test_cast_ray_matches_jax():
    """First hit along a ray in the integrated wall map (inflated and not):
    hit flags and points equal JAX's, the point within a voxel of x = 4."""
    m = tmap.init_map((0, 0, 0), (6, 4, 2), CFG, device="cpu")
    jm = jmap.init_map((0, 0, 0), (6, 4, 2), JCFG)
    origin = np.array([0.5, 2.0, 1.0], np.float32)
    pts = np.array([[4.0, 2.0, 1.0]], np.float32)
    for _ in range(4):
        m = tmap.integrate_cloud(CFG, m, T(origin)[None], T(pts)[None],
                                 torch.ones((1, 1), dtype=torch.bool))
        jm = _integrate(JCFG, jm, origin, pts, np.ones(1, bool), 64)
    rng = np.random.default_rng(2)
    ends = np.concatenate([[[6.0, 2.0, 1.0]],
                           rng.uniform([3, 0, 0], [6, 4, 2], (15, 3))]
                          ).astype(np.float32)
    starts = np.repeat(origin[None], 16, 0)
    for inflated in (False, True):
        g = tmap.to_occupancy_grid(CFG, m, inflated=inflated)
        g = g._replace(grid=g.grid.expand(16, -1, -1, -1))
        hit, p = tmap.cast_ray(g, T(starts), T(ends))
        jg = jmap.to_occupancy_grid(JCFG, jm, inflated=inflated)
        f = jax.jit(jax.vmap(lambda g, a, b: jmap.cast_ray(g, a, b),
                             in_axes=(None, 0, 0)))
        jh, jp = f(jg, starts, ends)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        assert bool(hit[0]) and abs(float(p[0, 0]) - 4.0) < 0.25


def test_esdf_signed_distances_match_jax(monkeypatch):
    """The signed distance field of seeded grids equals JAX's to 1e-6
    relative; a single occupied voxel gives 1.5, 2.0 and sqrt(2) * 0.5 m
    where the JAX test reads them; the min-plus chunking changes nothing."""
    occ = np.zeros((16, 16, 8), np.int8)
    occ[8, 8, 4] = 1
    d = tmap.esdf(T(occ)[None], resolution=0.5)[0].numpy()
    assert d[8, 8, 4] <= 0.0
    np.testing.assert_allclose(d[11, 8, 4], 1.5, atol=1e-5)
    np.testing.assert_allclose(d[8, 12, 4], 2.0, atol=1e-5)
    np.testing.assert_allclose(d[9, 9, 4], np.sqrt(2) * 0.5, atol=1e-5)
    rng = np.random.default_rng(3)
    grids = (rng.uniform(0, 1, (2, 18, 13, 7)) > 0.9).astype(np.int8)
    got = tmap.esdf(T(grids), resolution=0.15).numpy()
    for s in range(2):
        want = np.asarray(jmap.esdf(jnp.asarray(grids[s]), resolution=0.15))
        np.testing.assert_allclose(got[s], want, rtol=1e-6, atol=0)
    monkeypatch.setattr(tmap, "ESDF_CHUNK_ELEMS", 500)
    np.testing.assert_array_equal(
        tmap.esdf(T(grids), resolution=0.15).numpy(), got)


def test_free_regions_matches_jax():
    """Boxes cleared from seeded grids equal JAX's; an empty box (lower >
    upper) clears nothing; the box of the JAX test clears (0.7, 0.7, 0.5)
    and keeps (1.7, 1.7, 0.5)."""
    rng = np.random.default_rng(4)
    occ = (rng.uniform(0, 1, (2, 12, 10, 6)) > 0.3).astype(np.int8)
    lo = rng.uniform([0, 0, 0], [1.5, 1.2, 0.6], (2, 3, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 1.0, (2, 3, 3)).astype(np.float32)
    lo[1, 2] = 9.0
    got = tmap.free_regions(T(occ), T(np.zeros(3, np.float32)), 0.2, T(lo),
                            T(hi)).numpy()
    f = jax.jit(jmap.free_regions)
    for s in range(2):
        want = np.asarray(f(occ[s], np.zeros(3, np.float32), 0.2, lo[s],
                            hi[s]))
        np.testing.assert_array_equal(got[s], want)
    assert (got != occ).any()
    one = tmap.free_regions(torch.ones((1, 10, 10, 4), dtype=torch.int8),
                            torch.zeros(3), 0.2,
                            torch.tensor([[[0.4, 0.4, 0.0]]]),
                            torch.tensor([[[1.2, 1.2, 2.0]]]))[0]
    assert one[3, 3, 2] == 0 and one[8, 8, 2] == 1


def test_save_load_roundtrip_across_packages(tmp_path):
    """A map saved by the port loads in JAX and one saved by JAX loads in
    the port, values and resolution unchanged."""
    m = tmap.init_map((0, 0, 0), (2, 2, 1), CFG, batch=2, device="cpu")
    m = m._replace(log_odds=m.log_odds.clone())
    m.log_odds[1, 1, 2, 3] = 1.5
    p = str(tmp_path / "port.npz")
    tmap.save_map(p, m, scenario=1)
    jm = jmap.load_map(p)
    np.testing.assert_array_equal(np.asarray(jm.log_odds),
                                  m.log_odds[1].numpy())
    assert float(jm.resolution) == np.float32(0.2)
    jm = jm._replace(log_odds=jm.log_odds.at[0, 0, 0].set(-0.7))
    q = str(tmp_path / "jax.npz")
    jmap.save_map(q, jm)
    m2 = tmap.load_map(q, device="cpu")
    np.testing.assert_array_equal(m2.log_odds[0].numpy(),
                                  np.asarray(jm.log_odds))
    np.testing.assert_array_equal(m2.origin.numpy(), np.asarray(jm.origin))
    assert m2.resolution == float(np.float32(0.2))


def test_pcd_roundtrip_and_prebuilt_map_match_jax(tmp_path):
    """PCD files written by either package read back equal in both;
    initPrebuiltMap semantics equal JAX's (point voxels at max log-odds,
    the out-of-map point dropped), and the inflated grid answers as the
    JAX test reads it."""
    from intent_mpc_tpu.models.occupancy import is_occupied as j_is_occ
    pts = np.array([[1.0, 1.0, 1.0], [2.5, 0.5, 1.5], [9.9, 9.9, 9.9]],
                   np.float32)
    a, b = tmp_path / "port.pcd", tmp_path / "jax.pcd"
    tmap.save_pcd(str(a), pts)
    jmap.save_pcd(str(b), pts)
    for f in (a, b):
        np.testing.assert_array_equal(tmap.load_pcd(str(f)),
                                      jmap.load_pcd(str(f)))
        np.testing.assert_allclose(tmap.load_pcd(str(f)), pts, atol=1e-6)

    cfg = tmap.MappingConfig(resolution=0.25)
    jcfg = jmap.MappingConfig(resolution=0.25)
    m = tmap.init_map((0.0, 0.0, 0.0), (4.0, 4.0, 2.0), cfg, device="cpu")
    m = tmap.prebuilt_map_from_points(cfg, m, pts)
    jm = jmap.init_map((0.0, 0.0, 0.0), (4.0, 4.0, 2.0), jcfg)
    jm = jmap.prebuilt_map_from_points(jcfg, jm, pts)
    np.testing.assert_array_equal(m.log_odds[0].numpy(),
                                  np.asarray(jm.log_odds))
    occ = tmap.occupancy(cfg, m)[0].numpy()
    assert occ[4, 4, 4] == 1 and occ[10, 2, 6] == 1 and occ.sum() == 2
    g = tmap.to_occupancy_grid(cfg, m, inflated=True)
    jg = jmap.to_occupancy_grid(jcfg, jm, inflated=True)
    np.testing.assert_array_equal(g.grid[0].numpy(), np.asarray(jg.grid))
    q = torch.tensor([[[1.2, 1.0, 1.0], [3.5, 3.5, 0.5]]])
    assert tocc.is_occupied(g, q)[0].tolist() == [True, False]
    assert bool(j_is_occ(jg, jnp.array([1.2, 1.0, 1.0])))


def test_maps_carry_across_packages():
    """map_from_numpy stacks JAX maps into one port batch unchanged."""
    jms = [jmap.init_map((0, 0, 0), (2, 2, 1), JCFG) for _ in range(2)]
    jms[1] = jms[1]._replace(log_odds=jms[1].log_odds.at[1, 1, 1].set(2.0))
    m = map_from_numpy([_np_map(j) for j in jms])
    assert m.log_odds.shape == (2, 10, 10, 5)
    assert float(m.log_odds[1, 1, 1, 1]) == 2.0
    assert m.resolution == float(np.float32(0.2))


def test_sensor_to_map_roundtrip():
    """Rendered frame -> point cloud -> log-odds map (projectDepthImage ->
    raycastUpdate): the box front face becomes occupied and the free space
    before it stays free; the log-odds equal JAX's on the same frame."""
    from intent_mpc_tpu.models import real_detector as jrd
    from intent_mpc_tpu.utils.config import RealDetectorConfig as JRD
    from intent_mpc_torch.models import real_detector as trd
    from intent_mpc_torch.utils.config import RealDetectorConfig as TRD
    rd = JRD()
    intr, tintr = jrd.intrinsics(rd), trd.intrinsics(TRD())
    cam = np.array([1.0, 3.0, 1.5], np.float32)
    R = np.asarray(jsen.yaw_camera_rotation(jnp.asarray(0.0)))
    centers = np.array([[4.0, 3.0, 1.5]], np.float32)
    sizes = np.array([[0.8, 1.4, 1.4]], np.float32)
    depth = np.asarray(jax.jit(lambda c, R: jsen.render_depth(
        intr, rd.im_h, rd.im_w, c, R, centers, sizes, jnp.array([True])))(
            cam, R))
    jp, jv = jax.jit(lambda d, c, R: jpc.project_depth(intr, d, c, R))(
        depth, cam, R)
    tp, tv = tpc.project_depth(tintr, T(depth)[None], T(cam)[None],
                               T(R)[None])
    cfg = tmap.MappingConfig(resolution=0.2)
    jcfg = jmap.MappingConfig(resolution=0.2)
    m = tmap.init_map((0.0, 0.0, 0.0), (8.0, 6.0, 3.0), cfg, device="cpu")
    jm = jmap.init_map((0.0, 0.0, 0.0), (8.0, 6.0, 3.0), jcfg)
    f = jax.jit(jmap.integrate_cloud, static_argnums=(0,))
    for _ in range(3):
        m = tmap.integrate_cloud(cfg, m, T(cam)[None], tp, tv)
        jm = f(jcfg, jm, cam, jp, jv)
    np.testing.assert_array_equal(m.log_odds[0].numpy(),
                                  np.asarray(jm.log_odds))
    occ = tmap.occupancy(cfg, m)[0].numpy()
    res = 0.2
    assert occ[int(3.6 / res), int(3.0 / res), int(1.5 / res)] == 1
    assert occ[int(2.0 / res), int(3.0 / res), int(1.5 / res)] == 0


@pytest.mark.parametrize("entry", ["init_map", "load_map", "build_detector",
                                   "init_bird_tracks", "const_acc_matrices",
                                   "small_frames"])
def test_new_entry_points_need_a_card_by_default(entry, tmp_path):
    """Without device=..., the slice's entry points run on the card, and
    raise where there is none (as utils/device.resolve_device does)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from intent_mpc_torch.benchmark import capture
    from intent_mpc_torch.models import yolo
    p = str(tmp_path / "m.npz")
    jmap.save_map(p, jmap.init_map((0, 0, 0), (1, 1, 1), JCFG))
    calls = {
        "init_map": lambda: tmap.init_map((0, 0, 0), (1, 1, 1), CFG),
        "load_map": lambda: tmap.load_map(p),
        "build_detector": lambda: yolo.build_detector(),
        "init_bird_tracks": lambda: tpc.init_bird_tracks(1, 2),
        "const_acc_matrices": lambda: tpc.const_acc_matrices(0.1),
        "small_frames": lambda: capture.small_frames(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
