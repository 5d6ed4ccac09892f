"""Port parity: intent_mpc_torch.models.world against the JAX package."""

import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.utils.config import WorldConfig as JWorldConfig
from intent_mpc_torch.models import world as tworld
from intent_mpc_torch.parallel import sharding as tsh
from intent_mpc_torch.utils.config import IntentMPCConfig, WorldConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_generate_scenario_bit_equal(seed):
    """Both packages draw the same MT19937 sequence in float64 and cast to
    float32 once at the end, so the arrays are exactly equal."""
    j = jworld.generate_scenario(seed, JWorldConfig())
    t = tworld.generate_scenario(seed, WorldConfig())
    assert t.origin.shape == (200, 3)
    for f in tworld.Scenario._fields:
        a = np.asarray(getattr(j, f))
        b = getattr(t, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("t", [0.0, 0.37, 5.2, 33.3])
def test_obstacle_state_matches(t):
    """Positions and velocities at several times. atol 1e-5: float32 sin
    and cos differ by a few ulps between XLA and torch, and positions
    reach ~100 m (ulp ~8e-6)."""
    j = jworld.generate_scenario(1, JWorldConfig())
    sc = tworld.generate_scenario(1, WorldConfig())
    jp, jv = jworld.obstacle_state(j, np.float32(t))
    tp, tv = tworld.obstacle_state(sc, torch.tensor(t, dtype=torch.float32))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_obstacle_state_batched_and_stacked():
    """A stacked (S, N) batch equals the scenarios one at a time."""
    cfg = IntentMPCConfig()
    stack = tsh.stack_scenarios(cfg, [2, 5], device="cpu")
    tt = torch.tensor(1.7, dtype=torch.float32)
    bp, bv = tworld.obstacle_state(stack, tt)
    for i, seed in enumerate([2, 5]):
        p, v = tworld.obstacle_state(
            tworld.generate_scenario(seed, cfg.world), tt)
        np.testing.assert_array_equal(bp[i].numpy(), p.numpy())
        np.testing.assert_array_equal(bv[i].numpy(), v.numpy())


def test_straight_line_ref_traj_equal():
    cfg = IntentMPCConfig()
    for spacing in (2.5, 0.5):
        j = jworld.straight_line_ref_traj(cfg.start, cfg.goal, spacing)
        t = tworld.straight_line_ref_traj(cfg.start, cfg.goal, spacing)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("tail", ["", "0.9 1.0\n7.0 8.0 9.0 10.0\n"],
                         ids=["whole", "short_line"])
def test_load_ref_traj_matches_jax(tmp_path, tail):
    """A `t x y z` file from seeded numpy values read by both packages:
    exactly equal float32 (L, 3) arrays. Reading stops at the first line
    with fewer than 4 fields, so the rows after it are never read."""
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=20.0, size=(9, 4))
    path = tmp_path / "ref.txt"
    path.write_text("".join("%r %r %r %r\n" % tuple(map(float, p))
                            for p in pts) + tail)
    j = np.asarray(jworld.load_ref_traj(str(path)))
    t = tworld.load_ref_traj(str(path), device="cpu")
    assert t.dtype == torch.float32 and t.shape == (9, 3)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy(), pts[:, 1:].astype(np.float32))
