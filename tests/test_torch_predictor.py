"""Port parity: intent_mpc_torch.models.detector and models.predictor
against the JAX package and the reference-literal oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import detector as jdet
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
    from intent_mpc_torch.models.occupancy import OccupancyGrid
    grid = OccupancyGrid(torch.ones((4, 4, 4), dtype=torch.int8),
                         torch.zeros(3), torch.tensor(0.2))
    z = torch.zeros((1, 2, 4, 3))
    with pytest.raises(NotImplementedError):
        tpred.predict(PredictorConfig(), z, z, z, z,
                      torch.full((1, 2), 4, dtype=torch.int32), grid)
