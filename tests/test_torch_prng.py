"""Port parity: utils/prng.py, the Threefry-2x32 generator of `jax.random`
(partitionable form), bit for bit against jax.random on the CPU: keys from
seeds, fold_in (with large data values, as the engine folds cycle indices
and the RRT iterations), split, raw bits and uniform floats, single keys
and batches of keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_torch.utils import prng

torch.set_num_threads(1)

DATA = [0, 1, 2, 7, 1000, 2047, 65535, 2 ** 31 - 1, 2 ** 31, 4_000_000_000,
        2 ** 32 - 1]


def _seeds(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n)


def _u32(a):
    return np.asarray(a).astype(np.int64)


def test_partitionable_threefry_is_the_default():
    """The bits below are those of jax_threefry_partitionable=True (JAX
    0.9's default), the form utils/prng.py reproduces."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("chunk", range(4))
def test_keys_fold_in_and_split_equal_jax(chunk):
    for s in _seeds(16, chunk):
        jk, tk = jax.random.PRNGKey(int(s)), prng.prng_key(int(s))
        np.testing.assert_array_equal(_u32(jk), tk.numpy())
        for d in DATA:
            np.testing.assert_array_equal(
                _u32(jax.random.fold_in(jk, d)), prng.fold_in(tk, d).numpy(),
                err_msg="seed %d, data %d" % (s, d))
        for num in (2, 3):
            np.testing.assert_array_equal(_u32(jax.random.split(jk, num)),
                                          prng.split(tk, num).numpy())


@pytest.mark.parametrize("shape", [(), (3,), (5, 7), (2049,)],
                         ids=lambda s: "x".join(map(str, s)) or "scalar")
def test_bits_and_uniform_equal_jax(shape):
    for s in _seeds(12, 10 + len(shape)):
        jk, tk = jax.random.PRNGKey(int(s)), prng.prng_key(int(s))
        np.testing.assert_array_equal(
            _u32(jax.random.bits(jk, shape)), prng.random_bits(tk, shape).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, shape)),
            prng.uniform(tk, shape).numpy())


def test_batched_rrt_draw_chain_equals_jax():
    """The RRT's draw chain as one batched call: keys PRNGKey(1000 + seed)
    folded with a cycle index, then with each iteration, split in two,
    and drawn from with uniform(()) and uniform((3,)), for 4 scenarios x
    300 iterations at once, against the same chain key by key in JAX."""
    seeds, cycle, iters = [0, 1, 7, 15], 123456, 300
    tk = prng.fold_in(prng.prng_key(torch.tensor([1000 + s for s in seeds])),
                      cycle)
    k = prng.split(prng.fold_in(tk[:, None], torch.arange(iters)[None]))
    u1 = prng.uniform(k[..., 0, :]).numpy()
    u3 = prng.uniform(k[..., 1, :], (3,)).numpy()

    def chain(key):
        def one(it):
            k1, k2 = jax.random.split(jax.random.fold_in(key, it))
            return jax.random.uniform(k1), jax.random.uniform(k2, (3,))
        return jax.vmap(one)(jnp.arange(iters))
    for i, s in enumerate(seeds):
        key = jax.random.fold_in(jax.random.PRNGKey(1000 + s), cycle)
        j1, j3 = jax.jit(chain)(key)
        np.testing.assert_array_equal(np.asarray(j1), u1[i])
        np.testing.assert_array_equal(np.asarray(j3), u3[i])
