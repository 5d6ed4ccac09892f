"""Port parity: frontier exploration (models/exploration.py) against the JAX
package's, and the Gumbel draws of utils/prng.categorical.

classify and frontiers are bit-equal; the information gain is a count
(equal), the port's over a window of the map, JAX's over every voxel;
plan_next_view runs eagerly in JAX, as tests/test_exploration.py runs it,
and its viewpoint and path agree within 1e-5 m, its gain, path length and
success are equal."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import exploration as jx
from intent_mpc_torch.models import exploration as tx
from intent_mpc_torch.utils import prng

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def _half_observed_map(n=24):
    """tests/test_exploration.py's map: the left half observed free, the
    right half unknown."""
    lo = np.zeros((n, n, 8), np.float32)
    lo[: n // 2] = -1.0
    return lo


def _mixed_map(seed, dims=(14, 10, 6)):
    """Seeded unknown (0 and tiny), free and occupied log-odds."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.float32([0.0, 5e-4, -1e-3, -1.2, 1.39, 2.5]),
                      size=dims)


@pytest.mark.parametrize("seed", [0, 1])
def test_classify_and_frontiers_bit_equal(seed):
    """The three classes and the frontier mask (padded shifts: a voxel on
    one face is no frontier of the opposite face's unknown space) on seeded
    maps holding values at both thresholds, and on the half-observed map."""
    cfg = jx.ExplorationConfig()
    tcfg = tx.ExplorationConfig(*cfg)
    for lo in (_mixed_map(seed), _half_observed_map()):
        for j, t in zip(jx.classify(jnp.asarray(lo), cfg),
                        tx.classify(T(lo)[None], tcfg)):
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(j))
        np.testing.assert_array_equal(
            tx.frontiers(T(lo)[None], tcfg)[0].numpy(),
            np.asarray(jx.frontiers(jnp.asarray(lo), cfg)))


@pytest.mark.parametrize("sensor_range", [2.0, 5.0])
def test_windowed_information_gain_equals_jax_count(sensor_range):
    """Unknown voxels within range of 40 viewpoints (corners, faces,
    outside the map, inside): the port's windowed count equals JAX's count
    over the whole map, also where the window meets the grid's faces (a 5 m
    range covers the 7 x 5 x 3 m map)."""
    rng = np.random.default_rng(4)
    lo = _mixed_map(9)
    vps = np.concatenate([
        np.float32([[0.0, 0.0, 0.0], [7.0, 5.0, 3.0], [0.01, 2.5, 1.5],
                    [-1.0, -1.0, 4.0], [3.5, 5.2, 0.3]]),
        rng.uniform([0, 0, 0], [7, 5, 3], (35, 3)).astype(np.float32)])
    cfg = jx.ExplorationConfig(sensor_range=sensor_range)
    want = jx.information_gain(jnp.asarray(lo), jnp.zeros(3), 0.5,
                               jnp.asarray(vps), cfg)
    got = tx.information_gain(T(lo)[None], (0.0, 0.0, 0.0), 0.5,
                              T(vps)[None], tx.ExplorationConfig(*cfg))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert int(got.min()) < int(got.max())


def test_next_best_view_and_its_prm_path_match_jax():
    """tests/test_exploration.py's plan (256 candidates, 2 m range) for
    three keys as one batch: viewpoint and path within 1e-5 m; gain, path
    length and success equal; every view in the observed-free half."""
    cfg = jx.ExplorationConfig(sensor_range=2.0, num_candidates=256)
    lo = _half_observed_map()
    keys = (0, 3, 11)
    want = [jx.plan_next_view(jnp.asarray(lo), (0, 0, 0), 0.5,
                              jnp.array([1.0, 6.0, 2.0]), (0.5, 0.5, 0.5),
                              (11.5, 11.5, 3.5), jax.random.PRNGKey(k), cfg)
            for k in keys]
    S = len(keys)
    rows = lambda v: T(np.float32([v] * S))           # noqa: E731
    got = tx.plan_next_view(T(lo)[None].expand(S, -1, -1, -1), (0, 0, 0),
                            0.5, rows([1.0, 6.0, 2.0]), rows([0.5] * 3),
                            rows([11.5, 11.5, 3.5]),
                            prng.prng_key(torch.tensor(keys)),
                            tx.ExplorationConfig(*cfg))
    for i, w in enumerate(want):
        np.testing.assert_allclose(got.viewpoint[i].numpy(),
                                   np.asarray(w.viewpoint), atol=1e-5)
        np.testing.assert_allclose(got.path[i].numpy(), np.asarray(w.path),
                                   atol=1e-5)
        for f in ("gain", "path_len", "success"):
            assert getattr(got, f)[i].item() == np.asarray(getattr(w, f)), f
    assert bool(got.success.all())
    assert bool((got.viewpoint[:, 0] < 6.0).all())


@pytest.mark.parametrize("samples,size", [(7, 3000), (16, 2304), (1, 5)])
def test_categorical_draws_equal_jax(samples, size):
    """prng.categorical against jax.random.categorical over logits of 0 and
    -inf (the DEP's frontier and free-voxel draws), jitted as dep_step
    runs it, for three keys as one batch: the indices are equal."""
    rng = np.random.default_rng(size)
    logits = np.where(rng.random((3, size)) < 0.2, 0.0,
                      -np.inf).astype(np.float32)
    logits[:, -1] = 0.0
    keys = (1, 2 ** 31 + 5, 77)
    f = jax.jit(lambda k, l: jax.random.categorical(
        k, l[None].repeat(samples, 0), axis=-1))
    want = np.stack([np.asarray(f(jax.random.PRNGKey(k), jnp.asarray(l)))
                     for k, l in zip(keys, logits)])
    got = prng.categorical(prng.prng_key(torch.tensor(keys)), T(logits),
                           samples)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_in_a_range_equals_jax():
    """prng.uniform(key, shape, minval, maxval) bit-equal to
    jax.random.uniform, for the Gumbel sampler's (tiny, 1) and another
    range."""
    tiny = float(np.finfo(np.float32).tiny)
    for s in (0, 9, 2 ** 32 - 1):
        for lo, hi in ((tiny, 1.0), (-2.0, 3.5)):
            np.testing.assert_array_equal(
                prng.uniform(prng.prng_key(s), (5, 400), lo, hi).numpy(),
                np.asarray(jax.random.uniform(jax.random.PRNGKey(s), (5, 400),
                                              minval=lo, maxval=hi)))


@pytest.mark.parametrize("values", [[0.0, math.nan], [math.nan, 0.0],
                                    [1e-7, math.nan, 2e-7]])
def test_card_checks_see_a_nan_in_any_place(values):
    """chip_smoke's card-against-CPU checks reduce their differences with
    nan_max: a NaN anywhere fails the tolerance, where Python's max passes
    over one that does not come first."""
    from chip_smoke import nan_max
    assert math.isnan(nan_max(values))
    assert not nan_max(values) <= 1e-5
    assert nan_max([1e-7, 3e-6, 2e-7]) == 3e-6
    assert nan_max([]) == 0.0
