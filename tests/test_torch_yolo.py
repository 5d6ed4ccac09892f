"""Port parity: the person detector network, its decode and person filter
(intent_mpc_torch.models.yolo) against the JAX package's models/yolo.py,
with seeded parameters carried across by utils/convert.yolo_state_dict
(the reference checkpoint is not in the repository)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import perception as jpc
from intent_mpc_tpu.models import yolo as jyolo
from intent_mpc_torch.models import perception as tpc
from intent_mpc_torch.models import yolo as tyolo
from intent_mpc_torch.utils.convert import yolo_state_dict

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def params():
    return tyolo.random_params(0)


def test_state_dict_keys_are_the_checkpoints(params):
    """The module's state_dict has the reference checkpoint's key names
    (the ones params_from_torch_state_dict reads) and loads the converted
    parameters strictly."""
    sd = tyolo.FastestDet().state_dict()
    assert "backbone.first_conv.0.weight" in sd
    assert "backbone.stage2.0.branch_proj.2.weight" in sd
    assert "backbone.stage4.3.branch_main.6.running_var" in sd
    assert "SPP.S3.6.weight" in sd and "SPP.output.1.bias" in sd
    assert "detect_head.cls_layers.conv5x5.3.weight" in sd
    assert sd["detect_head.cls_layers.conv5x5.3.weight"].shape == (80, 96, 1, 1)
    assert set(k for k in sd if not k.endswith("num_batches_tracked")) \
        == set(params)
    net = tyolo.build_detector(yolo_state_dict(params), device="cpu")
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), params[k])


@pytest.mark.parametrize("shape", [(2, 3, 64, 96), (1, 3, 352, 352)])
def test_forward_matches_jax(params, shape):
    """The network's outputs (sigmoid obj, raw reg, softmax cls) equal
    JAX's detector_forward on a seeded batch within 1e-4 absolute."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    net = tyolo.build_detector(yolo_state_dict(params), device="cpu")
    with torch.no_grad():
        got = net(T(img)).numpy()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jax.jit(jyolo.detector_forward)(jp, img))
    assert got.shape == want.shape == (shape[0], 85, shape[2] // 16,
                                       shape[3] // 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(want[:, 1:5]).max() > 0.5


def _seeded_preds(seed, N, C=8, H=6, W=7):
    rng = np.random.default_rng(seed)
    p = np.zeros((N, 5 + C, H, W), np.float32)
    p[:, 0] = rng.uniform(0, 1, (N, H, W))
    p[:, 1:5] = rng.normal(0, 1.5, (N, 4, H, W))
    logits = rng.normal(0, 2.0, (N, C, H, W))
    e = np.exp(logits - logits.max(1, keepdims=True))
    p[:, 5:] = e / e.sum(1, keepdims=True)
    return p


@pytest.mark.parametrize("conf,nms,k", [(0.3, 0.45, 16), (0.6, 0.45, 16),
                                        (0.02, 2.0, 32), (0.3, 0.1, 8)])
def test_decode_matches_jax(conf, nms, k):
    """decode on seeded predictions of 5 images: scores and boxes within
    1e-6 and classes and valid flags equal JAX's, also in the tail where
    the confidence mask leaves exact-zero ties (lax.top_k's lower index
    first) and with NMS suppressing (nms 0.1) or off (2.0)."""
    preds = _seeded_preds(2, 5)
    det = tyolo.decode(T(preds), conf_thresh=conf, nms_thresh=nms, max_det=k)
    f = jax.jit(jax.vmap(lambda p: jyolo.decode(p, conf, nms, k)))
    want = f(preds)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(det.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-6)
    if conf == 0.6:
        assert (np.asarray(want.scores) == 0.0).sum() > 5
    assert det.valid.any()


def test_decode_nms_suppresses_duplicates():
    """Two near-identical boxes of one class: greedy NMS keeps the
    higher-scored one; another class at the same spot survives
    (batched_nms semantics), as in tests/test_yolo.py."""
    C, H, W = 8, 4, 4
    preds = np.zeros((5 + C, H, W), np.float32)
    for gx, obj in ((1, 0.9), (2, 0.8)):
        preds[0, 1, gx] = obj
        preds[1, 1, gx] = np.arctanh(np.clip(1.5 - gx, -0.99, 0.99))
        preds[3, 1, gx] = 2.0
        preds[4, 1, gx] = 2.0
        preds[5 + 2, 1, gx] = 8.0
    preds[0, 2, 1] = 0.7
    preds[3, 2, 1] = 2.0
    preds[4, 2, 1] = 2.0
    preds[5 + 4, 2, 1] = 8.0
    det = tyolo.decode(T(preds)[None], conf_thresh=0.1, max_det=8)
    kept = det.valid[0].numpy()
    assert kept.sum() == 2
    assert set(det.classes[0].numpy()[kept]) == {2, 4}
    jd = jyolo.decode(jnp.asarray(preds), conf_thresh=0.1, max_det=8)
    np.testing.assert_array_equal(kept, np.asarray(jd.valid))


def test_person_rects_feed_fusion():
    """Detections -> person_rects -> fuse_external_2d: the class filter
    keeps the person, the 3D box it projects onto is marked human, as JAX's
    chain marks it."""
    boxes = np.array([[[0.4, 0.4, 0.6, 0.8], [0.1, 0.1, 0.2, 0.2]]],
                     np.float32)
    det = tyolo.Detections(boxes=T(boxes), scores=T([[0.9, 0.8]]),
                           classes=T(np.array([[0, 7]], np.int32)),
                           valid=torch.ones((1, 2), dtype=torch.bool))
    intr = tpc.CameraIntrinsics(fx=100.0, fy=100.0, cx=50.0, cy=50.0)
    rects, ok = tyolo.person_rects(det, 100, 100)
    assert ok[0].tolist() == [True, False]
    centers = np.array([[[0.0, 0.2, 2.0], [5.0, 5.0, 2.0]]], np.float32)
    sizes = np.array([[[0.4, 0.8, 0.4], [0.4, 0.4, 0.4]]], np.float32)
    dyn, human = tpc.fuse_external_2d(
        intr, T(centers), T(sizes), torch.ones((1, 2), dtype=torch.bool),
        torch.zeros((1, 3)), torch.eye(3)[None], rects, ok, iou_thresh=0.2)
    assert human[0].tolist() == [True, False]
    jdet = jyolo.Detections(boxes=jnp.asarray(boxes[0]),
                            scores=jnp.asarray([0.9, 0.8]),
                            classes=jnp.asarray([0, 7]),
                            valid=jnp.asarray([True, True]))
    jr, jok = jyolo.person_rects(jdet, 100, 100)
    np.testing.assert_array_equal(rects[0].numpy(), np.asarray(jr))
    _, jh = jpc.fuse_external_2d(jpc.CameraIntrinsics(*intr), centers[0],
                                 sizes[0], jnp.ones(2, bool), jnp.zeros(3),
                                 jnp.eye(3), jr, jok, iou_thresh=0.2)
    np.testing.assert_array_equal(human[0].numpy(), np.asarray(jh))
