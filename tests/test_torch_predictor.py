"""Port parity: intent_mpc_torch.models.detector and models.predictor
against the JAX package and the reference-literal oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import detector as jdet
from intent_mpc_tpu.models import occupancy as jocc
from intent_mpc_tpu.models import predictor as jpred
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.oracle import predictor_ref as ref
from intent_mpc_tpu.utils.config import DetectorConfig as JDetectorConfig
from intent_mpc_tpu.utils.config import PredictorConfig as JPredictorConfig
from intent_mpc_torch.models import detector as tdet
from intent_mpc_torch.models import predictor as tpred
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.utils.config import DetectorConfig, PredictorConfig

torch.set_num_threads(1)

# float32 trig/exp/tanh differ by ulps between XLA and torch; values are
# O(1-10): atol 1e-5
ATOL = 1e-5
O, HH = 5, 12


def _walks(rng, O, Hh):
    """Smooth obstacle walks, newest sample first, and their velocities."""
    t = np.arange(Hh)[::-1, None] * 0.1
    heading = rng.uniform(-np.pi, np.pi, (O, 1))
    speed = rng.uniform(0.0, 2.0, (O, 1))
    turn = rng.uniform(-0.5, 0.5, (O, 1))
    ang = heading + turn * t.T
    pos = np.stack([np.cumsum(speed * np.cos(ang) * 0.1, axis=1),
                    np.cumsum(speed * np.sin(ang) * 0.1, axis=1),
                    np.full((O, Hh), 2.0)], axis=-1)
    pos = pos[:, ::-1] + rng.uniform(-5, 5, (O, 1, 3)) * [1, 1, 0]
    vel = np.stack([speed * np.cos(ang), speed * np.sin(ang),
                    np.zeros((O, Hh))], axis=-1)[:, ::-1]
    return (np.ascontiguousarray(pos, np.float32),
            np.ascontiguousarray(vel, np.float32))


def _detector_pair(rng):
    js = jdet.init_detector(O, JDetectorConfig(history_size=HH),
                            jnp.zeros((O, 3)))
    ph, vh = _walks(rng, O, HH)
    js = js._replace(pos_hist=jnp.asarray(ph), vel_hist=jnp.asarray(vh),
                     acc_hist=jnp.asarray(vh * 0.1),
                     hist_len=jnp.asarray(7, jnp.int32),
                     last_pos=jnp.asarray(ph[:, 0]),
                     vel=jnp.asarray(vh[:, 0]),
                     acc=jnp.asarray(vh[:, 0] * 0.1),
                     last_fd_time=jnp.asarray(0.3, jnp.float32))
    ts = tdet.DetectorState(*(torch.as_tensor(np.array(a))[None] for a in js))
    return js, ts


def test_detector_updates_match():
    """fd_update, hist_push and query_history on a batch of one scenario."""
    rng = np.random.RandomState(0)
    js, ts = _detector_pair(rng)
    jcfg, tcfg = JDetectorConfig(history_size=HH), DetectorConfig(history_size=HH)
    now = rng.uniform(-5, 5, (O, 3)).astype(np.float32)
    for t in (0.35, 0.45):       # not yet due, then due
        js = jdet.hist_push(jdet.fd_update(jcfg, js, jnp.asarray(now),
                                           np.float32(t)), jnp.asarray(now))
        ts = tdet.hist_push(tdet.fd_update(tcfg, ts, torch.as_tensor(now)[None],
                                           torch.tensor(t)), torch.as_tensor(now)[None])
        for a, b in zip(js, ts):
            np.testing.assert_allclose(b.numpy()[0], np.asarray(a), atol=ATOL)
        now = now + 0.3
    bbox = rng.uniform(0.4, 4.0, (O, 3)).astype(np.float32)
    robot = np.array([0.0, 0.0, 2.0], np.float32)
    jq = jdet.query_history(jcfg, js, jnp.asarray(bbox), jnp.asarray(robot))
    tq = tdet.query_history(tcfg, ts, torch.as_tensor(bbox)[None],
                            torch.as_tensor(robot)[None])
    for a, b in zip(jq, tq):
        np.testing.assert_allclose(b.numpy()[0], np.asarray(a), atol=ATOL)


@pytest.mark.parametrize("hist_len", [12, 6, 3])
def test_intent_probabilities_match(hist_len):
    """Full and partial histories against JAX and, for the full history,
    the reference-literal oracle (float64)."""
    rng = np.random.RandomState(hist_len)
    ph, vh = _walks(rng, O, HH)
    hl = np.full(O, hist_len, np.int32)
    j = jpred.intent_probabilities(JPredictorConfig(), jnp.asarray(ph),
                                   jnp.asarray(vh), jnp.asarray(hl))
    t = tpred.intent_probabilities(PredictorConfig(), torch.as_tensor(ph)[None],
                                   torch.as_tensor(vh)[None],
                                   torch.as_tensor(hl)[None])[0]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    if hist_len == HH:
        o = ref.intent_prob(PredictorConfig(), list(ph.astype(np.float64)),
                            list(vh.astype(np.float64)))
        np.testing.assert_allclose(t.numpy(), o, atol=ATOL)


def test_predict_empty_grid_matches():
    """predict on the empty map: the closed-form moment path against JAX,
    and per obstacle against the oracle's sample-grid rollouts
    (predict_obstacle). Obstacles 0 and 1 are slower than stop_vel."""
    rng = np.random.RandomState(5)
    ph, vh = _walks(rng, O, HH)
    vh[0] *= 0.0
    vh[1] = vh[1] / (np.linalg.norm(vh[1][:, :2], axis=-1, keepdims=True)
                     + 1e-9) * 0.05
    ah = vh * 0.1
    size = np.broadcast_to(rng.uniform(0.5, 1.5, (O, 1, 3)),
                           (O, HH, 3)).astype(np.float32)
    hl = np.full(O, HH, np.int32)
    cfg = PredictorConfig(num_pred=10)
    j = jpred.predict(JPredictorConfig(num_pred=10), *(jnp.asarray(a) for a in
                                                        (ph, vh, ah, size, hl)),
                      jempty())
    t = tpred.predict(cfg, *(torch.as_tensor(np.ascontiguousarray(a))[None]
                             for a in (ph, vh, ah, size, hl)), empty_grid())
    np.testing.assert_allclose(t.pos.numpy()[0], np.asarray(j.pos), atol=ATOL)
    np.testing.assert_allclose(t.size.numpy()[0], np.asarray(j.size), atol=ATOL)
    np.testing.assert_allclose(t.intent_prob.numpy()[0],
                               np.asarray(j.intent_prob), atol=ATOL)
    for o in range(O):
        p_ref, s_ref = ref.predict_obstacle(cfg, ph[o, 0].astype(np.float64),
                                            vh[o, 0].astype(np.float64),
                                            size[o, 0].astype(np.float64))
        np.testing.assert_allclose(t.pos.numpy()[0, o], p_ref, atol=ATOL)
        np.testing.assert_allclose(t.size.numpy()[0, o], s_ref, atol=ATOL)


def test_predict_rejects_occupied_grid():
    """On a fully occupied grid every rollout sample is rejected, so every
    moving obstacle's hypotheses fall back to the stop model
    (dynamicPredictor.cpp:312-326), as in JAX."""
    from intent_mpc_torch.models.occupancy import OccupancyGrid
    grid = OccupancyGrid(torch.ones((4, 4, 4), dtype=torch.int8),
                         torch.zeros(3), torch.tensor(0.2))
    jgrid = jocc.OccupancyGrid(jnp.ones((4, 4, 4), jnp.int8), jnp.zeros(3),
                               jnp.asarray(0.2, jnp.float32))
    p = np.full((2, 4, 3), 0.4, np.float32)
    v = np.zeros((2, 4, 3), np.float32)
    v[:, :, 0] = [[1.0], [0.5]]
    hl = np.full(2, 4, np.int32)
    cfg = PredictorConfig(num_pred=6)
    t = tpred.predict(cfg, *(torch.as_tensor(a)[None] for a in
                             (p, v, v * 0, p * 0 + 1.0, hl)), grid)
    j = jpred.predict(JPredictorConfig(num_pred=6), p, v, v * 0, p * 0 + 1.0,
                      hl, jgrid)
    stop = tpred._stop_prediction(cfg, torch.as_tensor(p[:, 0]),
                                  torch.as_tensor(v[:, 0]),
                                  torch.full((2, 3), 1.0))
    for k in range(4):
        np.testing.assert_array_equal(t.pos[0, :, k].numpy(), stop[0].numpy())
        np.testing.assert_allclose(t.size[0, :, k].numpy(), stop[1].numpy(),
                                   atol=ATOL)
    np.testing.assert_allclose(t.pos.numpy()[0], np.asarray(j.pos), atol=ATOL)
    np.testing.assert_allclose(t.size.numpy()[0], np.asarray(j.size),
                               atol=ATOL)


def test_predict_sampled_path_matches_jax():
    """predict on a real map (a pillar ahead of obstacle 0, walls across
    the walks) takes the sampled path: some rollouts are rejected, the
    speed loop breaks, and obstacle 0's forward mean path, which runs into
    the pillar, takes the nearest sample. Against JAX's jitted
    predict_single path within 1e-5, with the grid shared and per
    scenario (two scenarios, each with its own copy)."""
    from intent_mpc_torch.models import occupancy as tocc
    args = ((-8.0, -8.0, 0.0), (16.0, 16.0, 4.0), 0.2,
            np.array([[3.0, 0.0, 2.0], [-2.0, 4.0, 2.0], [0.0, -5.0, 2.0]],
                     np.float32),
            np.array([[0.4, 0.6, 4.0], [4.0, 0.4, 4.0], [3.0, 0.4, 4.0]],
                     np.float32))
    jg = jocc.build_from_static_obstacles(*args, inflation=(0.3, 0.3, 0.2))
    tg = tocc.build_from_static_obstacles(*args, inflation=(0.3, 0.3, 0.2))
    rng = np.random.RandomState(6)
    ph, vh = _walks(rng, O, HH)
    ph[..., 0:2] *= 0.5
    ph[0] = [0.0, 0.0, 2.0] - np.arange(HH)[:, None] * [0.15, 0.0, 0.0]
    vh[0] = [1.5, 0.0, 0.0]
    ah = vh * 0.1
    size = np.broadcast_to(rng.uniform(0.5, 1.5, (O, 1, 3)),
                           (O, HH, 3)).astype(np.float32)
    hl = np.array([HH, 6, HH, 3, HH], np.int32)
    arrs = (ph, vh, ah, size, hl)
    j = jax.jit(lambda *a: jpred.predict(JPredictorConfig(), *a))(*arrs, jg)
    tin = [torch.as_tensor(np.ascontiguousarray(a)) for a in arrs]
    f_pts, f_valid = tpred._forward_samples(PredictorConfig(), tin[0][:, 0],
                                            tin[1][:, 0], tg)
    assert 0 < int(f_valid.sum()) < f_valid.numel() // 2
    mean, _ = tpred._masked_mean_var(f_pts[..., 0:2], f_valid.float())
    assert bool(tocc.is_occupied(tg, torch.cat(
        [mean[0], f_pts[0, 0, :, 2:3]], -1)).any())
    for grid, S in ((tg, 1), (tocc.stack_grids([tg, tg]), 2)):
        t = tpred.predict(PredictorConfig(),
                          *(a[None].expand((S,) + a.shape) for a in tin),
                          grid)
        for s in range(S):
            np.testing.assert_allclose(t.pos.numpy()[s], np.asarray(j.pos),
                                       atol=ATOL)
            np.testing.assert_allclose(t.size.numpy()[s], np.asarray(j.size),
                                       atol=ATOL)
            np.testing.assert_allclose(t.intent_prob.numpy()[s],
                                       np.asarray(j.intent_prob), atol=ATOL)
