"""Port parity: the depth camera (intent_mpc_torch.models.sensor), the
tracking helpers (models.perception) and the real detector
(models.real_detector) against the JAX package's jitted functions on
numpy-seeded scenes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import occupancy as jocc
from intent_mpc_tpu.models import perception as jpc
from intent_mpc_tpu.models import real_detector as jrd
from intent_mpc_tpu.models import sensor as jsen
from intent_mpc_tpu.utils.config import DetectorConfig as JDet
from intent_mpc_tpu.utils.config import RealDetectorConfig as JRD
from intent_mpc_torch.models import occupancy as tocc
from intent_mpc_torch.models import perception as tpc
from intent_mpc_torch.models import real_detector as trd
from intent_mpc_torch.models import sensor as tsen
from intent_mpc_torch.utils.config import DetectorConfig as TDet
from intent_mpc_torch.utils.config import RealDetectorConfig as TRD

torch.set_num_threads(1)

RD = JRD()
INTR, TINTR = jrd.intrinsics(RD), trd.intrinsics(TRD())


def T(a):
    return torch.as_tensor(np.array(a))


def _scene(seed=0, O=12):
    rng = np.random.default_rng(seed)
    cen = rng.uniform([2, -4, 0.5], [9, 4, 3], (O, 3)).astype(np.float32)
    size = rng.uniform(0.3, 1.5, (O, 3)).astype(np.float32)
    active = np.ones(O, bool)
    active[3] = False
    return cen, size, active


def _render_jax(cam, yaw, cen, size, active):
    R = jsen.yaw_camera_rotation(jnp.asarray(yaw, jnp.float32))
    f = jax.jit(lambda c, R, a, b, m: jsen.render_depth(
        INTR, RD.im_h, RD.im_w, c, R, a, b, m, max_depth=RD.depth_max))
    return np.asarray(f(cam, R, cen, size, active)), np.asarray(R)


@pytest.mark.parametrize("yaw", [0.0, 0.3, -0.4, 0.7])
def test_render_depth_matches_jax(yaw):
    """A seeded 12-box scene (one box inactive) from the same camera
    rotation: the same pixels hit, depth within 1e-5 relative. The
    rotation itself agrees to float32 rounding (cos and sin of the yaw
    round differently in the two libraries)."""
    cen, size, active = _scene()
    cam = np.array([0.0, 0.0, 1.5], np.float32)
    want, R = _render_jax(cam, yaw, cen, size, active)
    Rt = tsen.yaw_camera_rotation(torch.tensor([yaw], dtype=torch.float32))
    np.testing.assert_allclose(Rt[0].numpy(), R, rtol=0, atol=1.2e-7)
    got = tsen.render_depth(TINTR, RD.im_h, RD.im_w, T(cam)[None], T(R)[None],
                            T(cen)[None], T(size)[None], T(active)[None],
                            max_depth=RD.depth_max)[0].numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert 0.05 < (want > 0).mean() < 0.95


def test_render_chunks_change_no_bit(monkeypatch):
    """The running minimum over box chunks is exact: chunks of 1, 5 and all
    boxes give the same image."""
    cen, size, active = _scene(1, O=23)
    args = (TINTR, RD.im_h, RD.im_w, torch.tensor([[0.0, 0.0, 1.5]]),
            tsen.yaw_camera_rotation(torch.tensor([0.2])), T(cen)[None],
            T(size)[None], T(active)[None])
    out = []
    for chunk in (1, 5, 64):
        monkeypatch.setattr(tsen, "BOX_CHUNK", chunk)
        out.append(tsen.render_depth(*args))
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


def _wall_grid(pkg):
    return pkg.build_from_static_obstacles(
        (-1.0, -6.0, 0.0), (10.0, 12.0, 4.0), 0.2,
        np.array([[7.0, 0.0, 1.5]], np.float32),
        np.array([[0.4, 8.0, 3.0]], np.float32), inflation=(0.0, 0.0, 0.0))


def test_render_depth_grid_matches_jax():
    g = _wall_grid(jocc)
    cam = np.array([0.0, 0.5, 1.5], np.float32)
    R = jsen.yaw_camera_rotation(jnp.asarray(0.1, jnp.float32))
    want = np.asarray(jax.jit(lambda c, R, g: jsen.render_depth_grid(
        INTR, RD.im_h, RD.im_w, c, R, g, max_depth=RD.depth_max))(cam, R, g))
    got = tsen.render_depth_grid(TINTR, RD.im_h, RD.im_w, T(cam)[None],
                                 T(R)[None], _wall_grid(tocc),
                                 max_depth=RD.depth_max)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (want > 0).mean() > 0.3


def test_project_depth_matches_jax():
    cen, size, active = _scene()
    cam = np.array([0.0, 0.0, 1.5], np.float32)
    depth, R = _render_jax(cam, 0.3, cen, size, active)
    wp, wv = jax.jit(lambda d, c, R: jpc.project_depth(INTR, d, c, R))(
        depth, cam, R)
    gp, gv = tpc.project_depth(TINTR, T(depth)[None], T(cam)[None], T(R)[None])
    assert gp.shape == (1, 1536, 3)
    np.testing.assert_array_equal(gv[0].numpy(), np.asarray(wv))
    np.testing.assert_allclose(gp[0].numpy(), np.asarray(wp), atol=1e-5)


def test_kalman_estimate_matches_jax():
    rng = np.random.default_rng(4)
    A, B, H, Q, R = jpc.const_vel_matrices(1.0 / 30.0)
    x = rng.normal(0, 1, (5, 6)).astype(np.float32)
    M = rng.normal(0, 0.3, (5, 6, 6)).astype(np.float32)
    P = np.eye(6, dtype=np.float32) + M @ np.swapaxes(M, 1, 2)
    z = rng.normal(0, 1, (5, 6)).astype(np.float32)

    def one(x, P, z):
        ks = jpc.kalman_estimate(jpc.KalmanState(x, P), A, B, H, Q, R, z,
                                 jnp.zeros(1))
        return ks.x, ks.P
    wx, wP = jax.jit(jax.vmap(one))(x, P, z)
    tm = tpc.const_vel_matrices(1.0 / 30.0)
    for a, b in zip(tm, (A, B, H, Q, R)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = tpc.kalman_estimate(tpc.KalmanState(T(x), T(P)), *tm, T(z),
                              torch.zeros((5, 1)))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(wx), atol=1e-5)
    np.testing.assert_allclose(got.P.numpy(), np.asarray(wP), atol=1e-5)


def test_track_step_matches_jax_over_frames():
    """30 frames of 6 detection slots (movers, noise, drop-outs and a
    clutter detection) into a 4-slot track table: live, age and miss equal
    every frame; pos, vel and P within 1e-5; each package carries its own
    table."""
    rng = np.random.default_rng(5)
    dt = 1.0 / 30.0
    p0 = rng.uniform([2, -3, 1], [8, 3, 2], (5, 3)).astype(np.float32)
    v = (rng.uniform(-1.5, 1.5, (5, 3)) * [1, 1, 0]).astype(np.float32)
    jt = jpc.init_tracks(4)
    tt = tpc.init_tracks(1, 4)
    step = jax.jit(lambda tr, p, s, m: jpc.track_step(tr, p, s, m, dt))
    for k in range(30):
        pos = np.zeros((6, 3), np.float32)
        pos[:5] = p0 + v * k * dt + rng.normal(0, 0.02, (5, 3))
        pos[5] = rng.uniform([2, -3, 1], [8, 3, 2])
        size = rng.uniform(0.4, 0.9, (6, 3)).astype(np.float32)
        valid = rng.uniform(size=6) > 0.25
        if k in (10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21):
            valid[0] = False                       # a track coasts and dies
        jt = step(jt, pos, size, valid)
        tt = tpc.track_step(tt, T(pos)[None], T(size)[None], T(valid)[None],
                            dt)
        for f in ("live", "age", "miss"):
            np.testing.assert_array_equal(getattr(tt, f)[0].numpy(),
                                          np.asarray(getattr(jt, f)),
                                          err_msg="%s frame %d" % (f, k))
        for f in ("pos", "vel", "P", "size", "dyn_votes", "pos_hist"):
            np.testing.assert_allclose(getattr(tt, f)[0].numpy(),
                                       np.asarray(getattr(jt, f)), atol=1e-5,
                                       err_msg="%s frame %d" % (f, k))
    assert int(np.asarray(jt.live).sum()) >= 3


def test_extract_detections_with_tied_sizes():
    """Clusters of equal size fill the slots in label order (JAX's stable
    argsort of -count), the smaller ones after, a straggler below
    min_cluster_pts dropped; padded slots zero."""
    rng = np.random.default_rng(6)
    rd = JRD(min_cluster_pts=3, max_detections=4, min_box_size=0.1)
    trd_cfg = TRD(min_cluster_pts=3, max_detections=4, min_box_size=0.1)
    pts = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    labels = -np.ones(40, np.int32)
    for members in ([2, 7, 9, 30], [5, 6, 20, 21], [11, 12, 13],
                    [0, 33, 34, 35], [25, 26]):
        labels[members] = min(members)
    want = jax.jit(lambda p, l: jrd.extract_detections(rd, p, l))(pts, labels)
    got = trd.extract_detections(trd_cfg, T(pts)[None], T(labels)[None])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(want[2]), [1, 1, 1, 1])


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                        *trees)


VARIANTS = {"plain": {}, "static_veto": dict(static_map_veto=True),
            "kf_inflation": dict(kf_size_inflation=1.0),
            "static_grid": {}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sense_and_track_and_query_history_match_jax(variant):
    """Eight ~30 Hz ticks of two scenarios (the drone moving and turning
    through movers and a static box): tracks, histories and the integer
    perception stats equal (floats within 1e-5), and query_history's
    visibility equal; with the static-map veto, with KF size inflation,
    and with a static grid merged into the camera image. The two
    scenarios run as one batch against one JAX call each."""
    rd = JRD(max_tracks=6, max_detections=6, **VARIANTS[variant])
    rdt = TRD(max_tracks=6, max_detections=6, **VARIANTS[variant])
    det, dett = JDet(history_size=8), TDet(history_size=8)
    grid = _wall_grid(jocc)
    occ = grid if variant == "static_grid" else None
    static_occ = grid if variant == "static_veto" else None
    tgrid = _wall_grid(tocc)
    tocc_ = tgrid if variant == "static_grid" else None
    tstatic = tgrid if variant == "static_veto" else None
    rng = np.random.default_rng(7)
    O = 6
    c0 = rng.uniform([3, -3, 1], [7, 3, 2], (2, O, 3)).astype(np.float32)
    c0[:, 5] = [7.0, 0.5, 1.5]                               # on the wall
    vel = (rng.uniform(-2.0, 2.0, (2, O, 3)) * [1, 1, 0]).astype(np.float32)
    vel[:, 5] = 0.0
    size = np.full((2, O, 3), 0.8, np.float32)
    active = np.ones((2, O), bool)
    dyn = np.ones((2, O), bool)
    dyn[:, 5] = False
    sense = jax.jit(lambda st, p, y, c, s, a, d: jrd.sense_and_track(
        rd, det, st, p, y, c, s, a, occ, obs_dynamic=d,
        static_occ=static_occ))
    query = jax.jit(lambda st, p: jrd.query_history(rd, det, st, p,
                                                    static_occ=static_occ))
    js = [jrd.init_real_detector(rd, det) for _ in range(2)]
    ts = trd.init_real_detector(rdt, dett, 2)
    for k in range(8):
        t = k / 30.0
        drone = np.array([[0.1 * k, 0.0, 1.5], [0.05 * k, 0.3, 1.4]],
                         np.float32)
        yaw = np.array([0.02 * k, -0.03 * k], np.float32)
        cen = (c0 + vel * t).astype(np.float32)
        js = [sense(js[i], drone[i], yaw[i], cen[i], size[i], active[i],
                    dyn[i]) for i in range(2)]
        ts = trd.sense_and_track(rdt, dett, ts, T(drone), T(yaw), T(cen),
                                 T(size), T(active), tocc_,
                                 obs_dynamic=T(dyn), static_occ=tstatic)
        want = _stack(js)
        for f in ("live", "age", "miss"):
            np.testing.assert_array_equal(getattr(ts.tracks, f).numpy(),
                                          getattr(want.tracks, f),
                                          err_msg="%s tick %d" % (f, k))
        for f, tol in (("pos", 1e-5), ("vel", 1e-4), ("P", 1e-5),
                       ("dyn_votes", 0.0)):
            np.testing.assert_allclose(getattr(ts.tracks, f).numpy(),
                                       getattr(want.tracks, f), atol=tol,
                                       err_msg="%s tick %d" % (f, k))
        np.testing.assert_array_equal(ts.hist_len.numpy(), want.hist_len)
        np.testing.assert_allclose(ts.pos_hist.numpy(), want.pos_hist,
                                   atol=1e-5)
        for f in trd.PerceptionStats._fields:
            a, b = getattr(ts.stats, f).numpy(), getattr(want.stats, f)
            if f == "err_sq_sum":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
    wq = _stack([query(js[i], drone[i]) for i in range(2)])
    gq = trd.query_history(rdt, dett, ts, T(drone), static_occ=tstatic)
    for name, w, g, tol in zip(("pos", "vel", "acc", "size", "hist_len",
                                "visible"), wq, gq,
                               (1e-5, 1e-4, 0, 1e-5, 0, 0)):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
    assert int(np.asarray(want.stats.births_sum).sum()) > 0
    assert np.asarray(want.tracks.live).sum() >= 4
    if variant == "static_veto":
        # the wall box's track is live and voted, but vetoed
        assert int(np.asarray(want.stats.track_ticks_sum).sum()) \
            < int(np.asarray(want.stats.err_n).sum())
