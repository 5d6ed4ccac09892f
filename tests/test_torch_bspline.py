"""Port parity: the B-spline optimiser (models/bspline_traj.py) against the
JAX package's.

The spline's fit and evaluation agree within 1e-6 m, the ESDF lookup
within 1e-6 m (1e3 outside). The Adam step is bit-equal to optax.adam as
XLA compiles it. optimize agrees within 1e-5 m after 30 steps and 1e-4 m
after 100 on seeded paths, whose every control point has a gradient well
above rounding.

On tests/test_bspline.py's own inputs, straight lines, the gradient of the
smoothness term along the line is rounding noise, and Adam's step
(m / (sqrt(v) + eps)) turns noise of any size into a step of the full
learning rate: one step already parts from JAX's by ~0.3 m. Those runs are
held by the JAX test's own properties (ROADMAP queue 3, item 13)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intent_mpc_tpu.models import bspline_traj as jbs
from intent_mpc_tpu.models import mapping as jmap
from intent_mpc_tpu.models.occupancy import build_from_static_obstacles
from intent_mpc_torch.models import bspline_traj as tbs

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def _line(n=20, y=0.1, x1=8.0, z=1.5):
    xs = np.linspace(0, x1, n)
    return np.stack([xs, np.full(n, y), np.full(n, z)], -1).astype(np.float32)


def _perturbed(seed, scale=0.3):
    rng = np.random.default_rng(seed)
    p = _line()
    return (p + rng.normal(0, scale, p.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def esdf_box():
    """tests/test_bspline.py's ESDF: a 1 x 1 x 3 m box at (4, 0) in a
    10 x 6 x 3 m map at 0.2 m."""
    grid = build_from_static_obstacles(
        origin=(-1, -3, 0), size_m=(10, 6, 3), resolution=0.2,
        centers=[[4.0, 0.0, 1.5]], bboxes=[[1.0, 1.0, 3.0]],
        inflation=[0.2, 0.2, 0.2])
    return np.asarray(jmap.esdf(grid.grid, 0.2))


def _terms(esdf, P, use_esdf, use_dynamic):
    """The optional cost terms as JAX and port keyword arguments."""
    jk, tk = {}, {}
    if use_esdf:
        jk.update(esdf_grid=jnp.asarray(esdf), esdf_origin=(-1, -3, 0),
                  esdf_resolution=0.2)
        tk.update(esdf_grid=T(esdf)[None], esdf_origin=(-1.0, -3.0, 0.0),
                  esdf_resolution=0.2)
    if use_dynamic:
        op = np.broadcast_to(np.float32([4.0, 0.0, 1.5]), (1, P, 3))
        size = np.broadcast_to(np.float32([1.0, 1.0, 1.0]), (1, P, 3))
        jk.update(obstacle_pos=jnp.asarray(op), obstacle_size=jnp.asarray(size))
        tk.update(obstacle_pos=T(op)[None], obstacle_size=T(size)[None])
    return jk, tk


def test_fit_and_evaluate_match_jax():
    """Control points from a seeded path, and positions at knots, between
    them and at both ends."""
    path = _perturbed(1)
    jc = jbs.fit_control_points(jnp.asarray(path))
    tc = tbs.fit_control_points(T(path)[None])
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
    jt = jbs.BsplineTrajectory(ctrl=jc, dt=jnp.asarray(0.1),
                               cost=jnp.asarray(0.0))
    tt = tbs.BsplineTrajectory(ctrl=tc, dt=0.1, cost=torch.zeros(1))
    ts = np.float32([0.0, 0.05, 0.1, 0.3, 0.77, 1.234, 1.6, 1.9, 2.0])
    want = np.stack([np.asarray(jbs.evaluate(jt, jnp.asarray(t))) for t in ts])
    np.testing.assert_allclose(tbs.evaluate(tt, T(ts)[None])[0].numpy(), want,
                               atol=1e-6)


def test_esdf_lookup_matches_jax(esdf_box):
    """Trilinear ESDF values at seeded points inside, on the edge cells and
    outside the grid (1e3)."""
    rng = np.random.default_rng(2)
    p = rng.uniform([-1.5, -3.5, -0.5], [9.5, 3.5, 3.5],
                    (500, 3)).astype(np.float32)
    want = jax.jit(lambda e, q: jbs._esdf_at(e, jnp.asarray((-1., -3., 0.)),
                                             0.2, q))(esdf_box, p)
    got = tbs.esdf_at(T(esdf_box)[None], T(np.float32([-1, -3, 0])), 0.2,
                      T(p)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-6)
    assert float(got.max()) == 1e3 and float(got.min()) < 0


def test_adam_step_bit_equal_to_optax():
    """One optax.adam(0.15) update jitted, from seeded gradients and
    moments at counts 1-5, 50, 100 and 300: the port's step gives the same
    parameters and moments bit for bit."""
    rng = np.random.default_rng(0)
    n = 4096
    opt = optax.adam(0.15)

    @jax.jit
    def step(p, g, st):
        up, st = opt.update(g, st, p)
        return optax.apply_updates(p, up), st

    for count in (1, 2, 3, 4, 5, 50, 100, 300):
        p = rng.normal(size=n).astype(np.float32)
        g = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 3, n)).astype(
            np.float32)
        mu = (rng.normal(size=n) * 10.0 ** rng.uniform(-3, 2, n)).astype(
            np.float32)
        nu = (mu.astype(np.float64) ** 2 * rng.uniform(1, 3, n)).astype(
            np.float32)
        if count == 1:
            mu[:], nu[:] = 0.0, 0.0
        st = opt.init(jnp.asarray(p))
        st = (st[0]._replace(count=jnp.asarray(count - 1, jnp.int32),
                             mu=jnp.asarray(mu), nu=jnp.asarray(nu)), st[1])
        jp, jst = step(jnp.asarray(p), jnp.asarray(g), st)
        tp, tmu, tnu = tbs.adam_step(0.15, T(p), T(g), T(mu), T(nu), count)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tmu.numpy(), np.asarray(jst[0].mu))
        np.testing.assert_array_equal(tnu.numpy(), np.asarray(jst[0].nu))


@pytest.mark.parametrize("iters,tol", [(30, 1e-5), (100, 1e-4)])
@pytest.mark.parametrize("terms", ["smooth_feasible", "esdf", "dynamic",
                                   "esdf_dynamic"])
def test_optimize_matches_jax_on_seeded_paths(esdf_box, terms, iters, tol):
    """optimize at BsplineConfig(clearance=0.6) from seeded paths (0.3 m
    noise on tests/test_bspline.py's line), with each optional term: the
    control points within tol, the costs within 1e-4 relative."""
    path = _perturbed(5)
    c0 = jbs.fit_control_points(jnp.asarray(path))
    jk, tk = _terms(esdf_box, c0.shape[0], "esdf" in terms,
                    "dynamic" in terms)
    cfg = jbs.BsplineConfig(iters=iters, clearance=0.6)
    want = jbs.optimize(cfg, c0, **jk)
    got = tbs.optimize(tbs.BsplineConfig(*cfg), T(np.asarray(c0))[None], **tk)
    np.testing.assert_allclose(got.ctrl[0].numpy(), np.asarray(want.ctrl),
                               atol=tol)
    np.testing.assert_allclose(got.cost[0].numpy(), np.asarray(want.cost),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.ctrl[0, :3].numpy(), np.asarray(c0[:3]))
    np.testing.assert_array_equal(got.ctrl[0, -3:].numpy(),
                                  np.asarray(c0[-3:]))


@pytest.mark.parametrize("case", ["smoothness_keeps_line",
                                  "static_collision_pushes_away",
                                  "dynamic_obstacle_penalty",
                                  "feasibility_limits_velocity"])
def test_bspline_properties_of_the_jax_tests(esdf_box, case):
    """tests/test_bspline.py's four cases through the port, held by that
    test's own assertions (the straight lines' rounding noise, amplified by
    Adam, parts the two packages' control points along the line)."""
    if case == "smoothness_keeps_line":
        tr = tbs.optimize(tbs.BsplineConfig(iters=50),
                          tbs.fit_control_points(T(_line(y=0.0))[None]))
        assert float(tr.ctrl[0, :, 1].abs().max()) < 1e-3
        p = tbs.evaluate(tr, torch.zeros((1, 1)))[0, 0].numpy()
        np.testing.assert_allclose(p, [0, 0, 1.5], atol=1e-4)
    elif case == "static_collision_pushes_away":
        tr = tbs.optimize(tbs.BsplineConfig(iters=300, clearance=0.6),
                          tbs.fit_control_points(T(_line())[None]),
                          esdf_grid=T(esdf_box)[None],
                          esdf_origin=(-1.0, -3.0, 0.0), esdf_resolution=0.2)
        c = tr.ctrl[0].numpy()
        mid = c[np.abs(c[:, 0] - 4.0) < 1.2]
        assert (np.abs(mid[:, 1]).max() > 0.3
                or np.abs(mid[:, 2] - 1.5).max() > 0.3)
    elif case == "dynamic_obstacle_penalty":
        c0 = tbs.fit_control_points(T(_line(y=0.05))[None])
        P = c0.shape[1]
        tr = tbs.optimize(
            tbs.BsplineConfig(iters=300), c0,
            obstacle_pos=torch.tensor([4.0, 0.0, 1.5]).expand(1, 1, P, 3),
            obstacle_size=torch.ones((1, 1, P, 3)))
        c = tr.ctrl[0].numpy()
        mid = c[np.abs(c[:, 0] - 4.0) < 1.5]
        assert np.linalg.norm(mid - np.float32([4.0, 0.0, 1.5]),
                              axis=-1).min() > 0.5
    else:
        path = _line(n=15, y=0.0, x1=40.0, z=1.0)
        tr = tbs.optimize(tbs.BsplineConfig(iters=300, w_feasibility=10.0),
                          tbs.fit_control_points(T(path)[None]))
        c = tr.ctrl[0].numpy()
        v = np.abs(np.diff(c[3:-3], axis=0) / 0.1)
        assert np.percentile(v[:, 0], 50) < 40.0


def test_optimize_batch_equals_single_calls(esdf_box):
    """Three seeded paths (own ESDFs and obstacles) as one batch give
    exactly the control points and costs of three single calls."""
    c0 = tbs.fit_control_points(T(np.stack([_perturbed(s)
                                            for s in (1, 2, 3)])))
    P = c0.shape[1]
    esdf = T(np.stack([esdf_box, esdf_box * 0.5, esdf_box + 0.2]))
    obs = torch.tensor([[4.0, 0.0, 1.5], [3.0, 0.5, 1.0], [5.0, -0.3, 2.0]])
    obs = obs[:, None, None].expand(3, 1, P, 3)
    size = torch.ones((3, 1, P, 3))
    cfg = tbs.BsplineConfig(iters=20, clearance=0.6)
    batch = tbs.optimize(cfg, c0, esdf, (-1.0, -3.0, 0.0), 0.2, obs, size)
    for i in range(3):
        one = tbs.optimize(cfg, c0[i:i + 1], esdf[i:i + 1],
                           (-1.0, -3.0, 0.0), 0.2, obs[i:i + 1],
                           size[i:i + 1])
        assert torch.equal(batch.ctrl[i], one.ctrl[0])
        assert torch.equal(batch.cost[i], one.cost[0])
