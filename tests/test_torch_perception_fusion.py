"""Port parity: the U-V detector, its bird's-eye tracker, the voxel filter,
the constant-acceleration KF and the box fusions of
intent_mpc_torch.models.perception against the JAX package's jitted
functions on numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import perception as jpc
from intent_mpc_torch.models import perception as tpc

torch.set_num_threads(1)

INTR = dict(fx=300.0, fy=300.0, cx=80.0, cy=60.0, depth_scale=1000.0,
            depth_min=0.5, depth_max=5.0, skip=2)
JI, TI = jpc.CameraIntrinsics(**INTR), tpc.CameraIntrinsics(**INTR)


def T(a):
    return torch.as_tensor(np.array(a))


def _depth_with_box(W=160, H=120, d_box=2000, u0=60, u1=90, v0=40, v1=80):
    depth = np.full((H, W), 4500, np.int32)
    depth[v0:v1, u0:u1] = d_box
    return depth


def _depths(seed, S, H=60, W=80):
    """Seeded frames: a background, 1-3 boxes at seeded depths and
    columns, out-of-range and zero pixels."""
    rng = np.random.default_rng(seed)
    out = np.zeros((S, H, W), np.int32)
    for s in range(S):
        d = rng.integers(3000, 9000, (H, W))
        for _ in range(rng.integers(1, 4)):
            u0 = rng.integers(0, W - 10)
            v0 = rng.integers(0, H - 10)
            d[v0:v0 + rng.integers(5, 30), u0:u0 + rng.integers(5, 30)] = \
                rng.integers(600, 4800)
        d[rng.uniform(0, 1, (H, W)) < 0.05] = 0
        out[s] = d
    return out


def test_umap_detects_box_column_range():
    """The box of tests/test_perception.py is one detection spanning
    columns 60-90 at depth ~2, and boxes and valid flags equal JAX's."""
    depth = _depth_with_box()
    boxes, valid = tpc.u_map_detect(TI, T(depth)[None], min_hits=10)
    jb, jv = jax.jit(lambda d: jpc.u_map_detect(JI, d, min_hits=10))(depth)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(boxes[0].numpy(), np.asarray(jb))
    b = boxes[0].numpy()[valid[0].numpy()]
    hit = b[np.abs(b[:, 2] - 2.0) < 0.5]
    assert hit.shape[0] >= 1 and hit[0][0] <= 62 and hit[0][1] >= 88


def test_umap_matches_jax_on_seeded_frames():
    """Six seeded frames as one batch: boxes (u range, bin depth, height)
    and valid flags equal JAX's, including the order of equal supports."""
    depth = _depths(0, 6)
    intr = tpc.CameraIntrinsics(fx=80.0, fy=80.0, cx=40.0, cy=30.0,
                                depth_min=0.3, depth_max=9.0)
    jintr = jpc.CameraIntrinsics(*intr)
    boxes, valid = tpc.u_map_detect(intr, T(depth), min_hits=6)
    f = jax.jit(jax.vmap(lambda d: jpc.u_map_detect(jintr, d, min_hits=6)))
    jb, jv = f(depth)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    assert valid.sum() > 6


def test_box_iou():
    c = T([0.0, 0.0, 0.0])
    s = T([2.0, 2.0, 2.0])
    assert abs(float(tpc.box_iou(c, s, c, s)) - 1.0) < 1e-6
    iou = float(tpc.box_iou(c, s, T([1.0, 0.0, 0.0]), s))
    assert 0.3 < iou < 0.4   # overlap 1x2x2=4, union 12 -> 1/3
    rng = np.random.default_rng(1)
    c1, c2 = rng.normal(0, 1, (2, 50, 3)).astype(np.float32)
    s1, s2 = rng.uniform(0.2, 2, (2, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tpc.box_iou(T(c1), T(s1), T(c2), T(s2)).numpy(),
        np.asarray(jax.jit(jpc.box_iou)(c1, s1, c2, s2)), rtol=1e-6, atol=0)


def test_const_acc_kf_estimates_acceleration():
    """The 9-state KF's matrices equal JAX's, it converges on a constantly
    accelerating target, and 60 steps match JAX's state within 1e-4."""
    dt = 0.1
    tm = tpc.const_acc_matrices(dt, eq=0.01, er=0.05, device="cpu")
    jm = jpc.const_acc_matrices(dt, eq=0.01, er=0.05)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    acc = np.array([0.5, -0.2, 0.0])
    ks = tpc.KalmanState(torch.zeros((1, 9)), torch.eye(9)[None] * 10.0)
    jks = jpc.KalmanState(jnp.zeros(9), jnp.eye(9) * 10.0)
    step = jax.jit(lambda ks, z: jpc.kalman_estimate(ks, *jm, z,
                                                     jnp.zeros(1)))
    prev = np.zeros(3)
    for k in range(60):
        t = dt * (k + 1)
        p = 0.5 * acc * t * t
        z = np.concatenate([p, (p - prev) / dt]).astype(np.float32)
        prev = p
        ks = tpc.kalman_estimate(ks, *tm, T(z)[None], torch.zeros((1, 1)))
        jks = step(jks, z)
    np.testing.assert_allclose(ks.x[0, 6:9].numpy(), acc, atol=0.1)
    np.testing.assert_allclose(ks.x[0].numpy(), np.asarray(jks.x),
                               rtol=0, atol=1e-4)


def test_voxel_filter_int32_hash_matches_jax():
    """The voxel filter's int32 hash wraps as JAX's: clouds whose voxel
    indices make idx * prime overflow int32 keep exactly the points JAX
    keeps, one per hash slot (the divisor passed as a run-time value)."""
    rng = np.random.default_rng(2)
    S, P = 3, 400
    pts = rng.uniform(-3000.0, 3000.0, (S, P, 3)).astype(np.float32)
    pts[:, :100] = rng.uniform(-1.0, 1.0, (S, 100, 3))     # many duplicates
    valid = rng.uniform(0, 1, (S, P)) > 0.1
    got = tpc.voxel_filter(T(pts), T(valid), 0.1, (0.0, 0.0, 0.0))
    f = jax.jit(jax.vmap(lambda p, v, r: jpc.voxel_filter(p, v, r,
                                                          (0.0, 0.0, 0.0)),
                         in_axes=(0, 0, None)))
    want = np.asarray(f(pts, valid, np.float32(0.1)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()
    key = (np.floor(pts / np.float32(0.1)).astype(np.int64)
           * [73856093, 19349663, 83492791])
    assert (np.abs(key) > 2 ** 31).any()


def test_voxel_filter_remainder_of_int32_min():
    """torch.remainder of INT32_MIN and of negative keys by 4 P + 1 is the
    floor-mod jnp's % gives (the sign of the divisor)."""
    k = np.array([-2 ** 31, -7, -1, 0, 5, 2 ** 31 - 1], np.int32)
    got = torch.remainder(torch.abs(T(k)), 13).numpy()
    want = np.asarray(jnp.abs(jnp.asarray(k)) % 13)
    np.testing.assert_array_equal(got, want)
    assert torch.abs(T(k))[0] < 0


def test_bird_view_box_geometry():
    """A U-map box converts to the metric bird's-eye rect the intrinsics
    imply (extract_bird_view), equal to JAX's on seeded boxes."""
    num_bins = 32
    uboxes = np.array([[[60.0, 100.0, 3.0, 40.0]]], np.float32)
    out = tpc.bird_view_boxes(TI, T(uboxes), torch.ones((1, 1), dtype=bool),
                              num_bins)[0].numpy()
    bin_w = (INTR["depth_max"] - INTR["depth_min"]) / num_bins
    assert out[0, 2] == pytest.approx(3.0 * 40.0 / 300.0)
    assert out[0, 0] == pytest.approx(3.0 * (60.0 - 80.0) / 300.0)
    assert out[0, 1] == pytest.approx(3.0 - 0.5 * bin_w)
    assert out[0, 3] == pytest.approx(bin_w)
    rng = np.random.default_rng(3)
    u0 = rng.uniform(0, 140, (4, 8)).astype(np.float32)
    ub = np.stack([u0, u0 + rng.uniform(2, 20, (4, 8)),
                   rng.uniform(0.6, 4.9, (4, 8)), rng.uniform(1, 60, (4, 8))],
                  -1).astype(np.float32)
    v = rng.uniform(0, 1, (4, 8)) > 0.3
    got = tpc.bird_view_boxes(TI, T(ub), T(v), num_bins).numpy()
    want = np.asarray(jax.jit(jax.vmap(
        lambda b, m: jpc.bird_view_boxes(JI, b, m, num_bins)))(ub, v))
    np.testing.assert_array_equal(got, want)


def test_bird_track_velocity_and_new_tracks():
    """tests/test_perception.py's sequence: a laterally moving box keeps
    its track with velocity (0.5, 0); a far box opens a fresh track."""
    dt = 0.1
    tr = tpc.init_bird_tracks(1, 4, device="cpu")
    one = torch.ones((1, 1), dtype=torch.bool)
    tr = tpc.bird_track_step(tr, T([[[0.0, 2.0, 1.0, 0.5]]]), one, dt)
    assert int(tr.live.sum()) == 1
    tr = tpc.bird_track_step(tr, T([[[0.05, 2.0, 1.0, 0.5]]]), one, dt)
    sl = int(tr.live[0].numpy().argmax())
    assert int(tr.live.sum()) == 1 and int(tr.age[0, sl]) == 2
    np.testing.assert_allclose(tr.vel[0, sl].numpy(), [0.5, 0.0], atol=1e-5)
    tr = tpc.bird_track_step(tr, T([[[10.0, 6.0, 1.0, 0.5]]]), one, dt)
    sl = int(tr.live[0].numpy().argmax())
    assert int(tr.live.sum()) == 1 and int(tr.age[0, sl]) == 1


def test_bird_tracks_match_jax_over_frames():
    """40 frames of 6 seeded drifting rectangles (drop-outs, a jump, a
    clutter box) into 4-slot tables for 3 scenarios: live, age and box
    equal JAX's every frame, velocity within 1e-5 m/s."""
    rng = np.random.default_rng(4)
    S, B, Tn, dt = 3, 6, 4, 1.0 / 30.0
    x0 = rng.uniform([-2, 1, 0.3, 0.3], [2, 6, 1.2, 0.6], (S, B, 4)) \
        .astype(np.float32)
    v = rng.uniform(-1.5, 1.5, (S, B, 2)).astype(np.float32)
    step = jax.jit(jax.vmap(lambda tr, b, m: jpc.bird_track_step(
        tr, b, m, dt)))
    jt = jax.vmap(lambda _: jpc.init_bird_tracks(Tn))(jnp.arange(S))
    tt = tpc.init_bird_tracks(S, Tn, device="cpu")
    for k in range(40):
        boxes = x0.copy()
        boxes[..., 0:2] += v * dt * k
        boxes[:, 5] = rng.uniform([-3, 0, 0.2, 0.2], [3, 8, 1, 1], (S, 4))
        if k == 20:
            boxes[:, 0, 0:2] += 3.0
        valid = rng.uniform(0, 1, (S, B)) > 0.25
        boxes = boxes.astype(np.float32)
        jt = step(jt, boxes, valid)
        tt = tpc.bird_track_step(tt, T(boxes), T(valid), dt)
        np.testing.assert_array_equal(tt.live.numpy(), np.asarray(jt.live))
        np.testing.assert_array_equal(tt.age.numpy(), np.asarray(jt.age))
        np.testing.assert_array_equal(tt.box.numpy(), np.asarray(jt.box))
        np.testing.assert_allclose(tt.vel.numpy(), np.asarray(jt.vel),
                                   rtol=0, atol=1e-5)
    assert tt.live.sum() >= S and tt.age.max() > 5


def test_fuse_mutual_best():
    """Mutual-best IOU pairs fuse to the union box, one-sided matches drop
    (filterBBoxes :1005-1031); seeded boxes equal JAX's."""
    uv_pos = T([[[0.0, 0.0, 1.0], [5.0, 0.0, 1.0]]])
    uv_size = T([[[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]]])
    db_pos = T([[[0.1, 0.0, 1.0], [9.0, 0.0, 1.0]]])
    db_size = T([[[1.2, 1.0, 1.0], [1.0, 1.0, 1.0]]])
    ones = torch.ones((1, 2), dtype=torch.bool)
    pos, size, ok = tpc.fuse_mutual_best(uv_pos, uv_size, ones, db_pos,
                                         db_size, ones)
    assert ok[0].tolist() == [True, False]
    assert float(pos[0, 0, 0]) == pytest.approx(0.1, abs=1e-6)
    assert float(size[0, 0, 0]) == pytest.approx(1.2, abs=1e-6)
    rng = np.random.default_rng(5)
    S, U, D = 4, 6, 5
    up = rng.uniform(-2, 2, (S, U, 3)).astype(np.float32)
    us = rng.uniform(0.3, 1.5, (S, U, 3)).astype(np.float32)
    dp = (np.concatenate([up[:, :3], rng.uniform(-2, 2, (S, 2, 3))], 1)
          + rng.normal(0, 0.1, (S, D, 3))).astype(np.float32)
    ds = rng.uniform(0.3, 1.5, (S, D, 3)).astype(np.float32)
    uv_v = rng.uniform(0, 1, (S, U)) > 0.2
    db_v = rng.uniform(0, 1, (S, D)) > 0.2
    got = tpc.fuse_mutual_best(T(up), T(us), T(uv_v), T(dp), T(ds), T(db_v),
                               iou_thresh=0.2)
    want = jax.jit(jax.vmap(lambda *a: jpc.fuse_mutual_best(
        *a, iou_thresh=0.2)))(up, us, uv_v, dp, ds, db_v)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    assert got[2].any()


def test_fuse_external_2d_marks_dynamic():
    """An external 2D detection overlapping a projected 3D box marks it
    dynamic, a far one marks nothing; seeded boxes, camera poses and
    detections give JAX's flags and rects within 1e-4 px."""
    cam_pos = torch.zeros((1, 3))
    cam_rot = torch.eye(3)[None]
    centers = T([[[0.0, 0.0, 3.0], [2.0, 0.0, 3.0]]])
    sizes = T([[[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]]])
    rect0 = tpc.project_box_to_image(TI, centers, sizes, cam_pos, cam_rot)
    det = rect0[:, :1] + T([3.0, 2.0, 0.0, 0.0])
    ones = torch.ones((1, 2), dtype=torch.bool)
    dyn, human = tpc.fuse_external_2d(TI, centers, sizes, ones, cam_pos,
                                      cam_rot, det,
                                      torch.ones((1, 1), dtype=torch.bool))
    assert dyn[0].tolist() == [True, False] and torch.equal(dyn, human)
    dyn, _ = tpc.fuse_external_2d(TI, centers, sizes, ones, cam_pos, cam_rot,
                                  T([[[1000.0, 1000.0, 10.0, 10.0]]]),
                                  torch.ones((1, 1), dtype=torch.bool))
    assert not dyn.any()

    from intent_mpc_tpu.models import sensor as jsen
    rng = np.random.default_rng(6)
    S, B, D = 4, 6, 5
    yaw = rng.uniform(-0.5, 0.5, S).astype(np.float32)
    R = np.stack([np.asarray(jsen.yaw_camera_rotation(jnp.asarray(y)))
                  for y in yaw])
    cp = rng.uniform(-1, 1, (S, 3)).astype(np.float32)
    c = (cp[:, None] + np.einsum("sij,sbj->sbi", R, np.concatenate(
        [rng.uniform(-1, 1, (S, B, 2)), rng.uniform(2, 5, (S, B, 1))], -1))
         ).astype(np.float32)
    sz = rng.uniform(0.3, 1.2, (S, B, 3)).astype(np.float32)
    v = rng.uniform(0, 1, (S, B)) > 0.2
    jr = jax.jit(jax.vmap(lambda c, s, p, r: jpc.project_box_to_image(
        JI, c, s, p, r)))(c, sz, cp, R)
    rects = tpc.project_box_to_image(TI, T(c), T(sz), T(cp), T(R))
    np.testing.assert_allclose(rects.numpy(), np.asarray(jr), rtol=0,
                               atol=1e-4)
    det = (np.asarray(jr)[:, :D] + rng.normal(0, 4, (S, D, 4))) \
        .astype(np.float32)
    dv = rng.uniform(0, 1, (S, D)) > 0.2
    got = tpc.fuse_external_2d(TI, T(c), T(sz), T(v), T(cp), T(R), T(det),
                               T(dv))
    want = jax.jit(jax.vmap(lambda *a: jpc.fuse_external_2d(JI, *a)))(
        c, sz, v, cp, R, det, dv)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].any()
