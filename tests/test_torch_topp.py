"""Port parity: the braking-zone divider (models/traj_divider.py) and the
time-optimal parameterization (models/time_optimizer.py) against the JAX
package's, on tests/test_traj_divider.py's and tests/test_time_optimizer.py's
trajectories.

Tolerances: the divider's masks and zone flags equal, zone times within
1e-6 s, obstacle distances within 1e-6 m; TOPP's b and times within 1e-5
relative; sampled states within 1e-5 (m, m/s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import poly_traj as jpt
from intent_mpc_tpu.models import time_optimizer as jto
from intent_mpc_tpu.models import traj_divider as jtd
from intent_mpc_tpu.models.occupancy import (build_from_static_obstacles,
                                             empty_grid)
from intent_mpc_torch.models import time_optimizer as tto
from intent_mpc_torch.models import traj_divider as ttd
from intent_mpc_torch.utils import convert

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def _pillar(center):
    """tests/test_traj_divider.py's map: a 0.4 m pillar, 0.3 m inflation,
    14 x 8 x 4 m at 0.1 m."""
    return build_from_static_obstacles(
        origin=(-1.0, -4.0, 0.0), size_m=(14.0, 8.0, 4.0), resolution=0.1,
        centers=np.asarray([center]), bboxes=np.asarray([[0.4, 0.4, 3.0]]),
        inflation=0.3)


def _grid(j):
    g = convert.grid_from_numpy(jax.tree.map(np.asarray, j))
    return g._replace(grid=g.grid[0])


def _straight_pass(N=120, t1=6.0, speed=2.0):
    ts = np.linspace(0.0, t1, N).astype(np.float32)
    traj = np.stack([ts * speed, np.zeros(N), np.full(N, 1.0)],
                    axis=-1).astype(np.float32)
    return traj, ts


def _minsnap_samples():
    """tests/test_traj_divider.py's end-to-end trajectory: min-snap through
    four waypoints at 2 m/s, 160 samples."""
    wps = jnp.asarray([[0.0, 0.0, 1.0], [4.0, 0.5, 1.0], [8.0, -0.5, 1.0],
                       [12.0, 0.0, 1.0]])
    traj = jpt.plan(wps, desired_vel=2.0)
    tt = jnp.linspace(0.0, traj.times[-1], 160)
    pts = jax.vmap(lambda t: jpt.sample(traj, t))(tt)
    return np.asarray(pts), np.asarray(tt)


def _assert_divided(jr, tr):
    for f in ("in_zone", "zone_valid"):
        np.testing.assert_array_equal(getattr(tr, f)[0].numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    for f in ("t_lo", "t_hi", "obstacle_dist", "sample_dist"):
        np.testing.assert_allclose(getattr(tr, f)[0].numpy(),
                                   np.asarray(getattr(jr, f)), atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("case", ["near_pillar", "short_blip", "empty_map",
                                  "minsnap_end_to_end"])
def test_divide_matches_jax(case):
    """tests/test_traj_divider.py's three divisions (one zone by the
    pillar, a short graze filtered, none on the empty map) and its min-snap
    trajectory: masks, zones and distances as JAX's."""
    params = jtd.DividerParams()
    if case == "minsnap_end_to_end":
        traj, ts = _minsnap_samples()
        occ = _pillar((6.0, 0.2, 1.0))
    elif case == "short_blip":
        traj, ts = _straight_pass(N=100, t1=10.0, speed=1.2)
        occ = _pillar((6.0, 1.05, 1.0))
        params = jtd.DividerParams(min_time=5.0, min_time_interval_ratio=0.5)
    else:
        traj, ts = _straight_pass()
        occ = _pillar((6.0, 0.6, 1.0)) if case == "near_pillar" \
            else empty_grid()
    jr = jtd.divide(jnp.asarray(traj), jnp.asarray(ts), occ, params)
    tr = ttd.divide(T(traj)[None], T(ts)[None], _grid(occ),
                    ttd.DividerParams(*params))
    _assert_divided(jr, tr)
    zones = {"near_pillar": 1, "short_blip": 0, "empty_map": 0}
    if case in zones:
        assert int(tr.zone_valid.sum()) == zones[case]
    np.testing.assert_allclose(
        ttd.zone_velocity_limits(tr, 5.0, 1.0)[0].numpy(),
        np.asarray(jtd.zone_velocity_limits(jr, 5.0, 1.0)), atol=1e-6)


def _paths():
    n = 120
    xs = np.linspace(0, 20, n)
    line = np.stack([xs, np.zeros(n), np.zeros(n)], -1).astype(np.float32)
    th = np.linspace(0, np.pi, 200)
    curve = np.stack([np.cos(th), np.sin(th), np.zeros(200)],
                     -1).astype(np.float32)
    return {"line": (line, 4.0, 2.0), "curve": (curve, 5.0, 2.0)}


def _assert_topp(jr, tr):
    np.testing.assert_allclose(tr.b[0].numpy(), np.asarray(jr.b), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tr.times[0].numpy(), np.asarray(jr.times),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["line", "curve", "zone_limits"])
def test_parameterize_and_sample_state_match_jax(case):
    """tests/test_time_optimizer.py's line (4 m/s, 2 m/s^2) and half circle
    (5, 2), and the min-snap trajectory under the divider's per-sample
    limits (5, 10): b and times within 1e-5 relative, and the sampled
    state at the start, inside and past the end within 1e-5."""
    if case == "zone_limits":
        path, ts = _minsnap_samples()
        dr = jtd.divide(jnp.asarray(path), jnp.asarray(ts),
                        _pillar((6.0, 0.2, 1.0)))
        jv = jtd.zone_velocity_limits(dr, 5.0, safe_dist=1.0)
        v_j, v_t, a_max = jv, T(np.asarray(jv))[None], 10.0
    else:
        path, v, a_max = _paths()[case]
        v_j, v_t = v, v
    jr = jto.parameterize(jnp.asarray(path), v_j, a_max)
    tr = tto.parameterize(T(path)[None], v_t, a_max)
    _assert_topp(jr, tr)
    total = float(jr.total_time)
    for t in (0.0, 0.37 * total, 0.81 * total, total + 1.0):
        jp, jvv = jto.sample_state(jnp.asarray(path), jr, jnp.asarray(t))
        tp, tv = tto.sample_state(T(path)[None], tr, torch.tensor([t]))
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), atol=1e-5)
        np.testing.assert_allclose(tv[0].numpy(), np.asarray(jvv), atol=1e-5)


def test_divider_and_topp_batch_equal_single_calls():
    """Three trajectories (their own grids and limits) as one batch give
    exactly the zones, limits and parameterizations of three single
    calls."""
    pts, ts = _minsnap_samples()
    trajs = T(np.stack([pts, pts + np.float32([0.0, 0.3, 0.0]),
                        pts[::-1].copy()]))
    times = T(ts)[None].expand(3, -1).contiguous()
    grids = convert.grid_from_numpy([jax.tree.map(np.asarray, _pillar(c))
                                     for c in ((6.0, 0.2, 1.0),
                                               (5.0, -0.4, 1.0),
                                               (3.0, 0.8, 1.0))])
    div = ttd.divide(trajs, times, grids)
    vlim = ttd.zone_velocity_limits(div, 5.0, 1.0)
    topp = tto.parameterize(trajs, vlim, 10.0)
    for i in range(3):
        g = grids._replace(grid=grids.grid[i])
        d1 = ttd.divide(trajs[i:i + 1], times[i:i + 1], g)
        v1 = ttd.zone_velocity_limits(d1, 5.0, 1.0)
        t1 = tto.parameterize(trajs[i:i + 1], v1, 10.0)
        for a, b in zip(div + (vlim,) + topp, d1 + (v1,) + t1):
            assert torch.equal(a[i], b[0])
    assert int(div.zone_valid.sum()) >= 2
