"""Port parity: utils/rounding's norms against XLA's CPU sqrt.

XLA's CPU sqrt is correctly rounded. PyTorch's float32 sqrt on the CPU is
a vectorized approximation that misses the correctly rounded root by an
ulp for ~0.6% of inputs, so norm3 and norm2 take the float64 root rounded
once there. The card's float32 sqrt is correctly rounded and stays."""

import jax.numpy as jnp
import numpy as np
import torch

from intent_mpc_torch.utils import rounding

torch.set_num_threads(1)

N = 100_000


def _vectors(seed, dim):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, (N, 1))
    return (rng.standard_normal((N, dim)) * scale).astype(np.float32)


def test_norms_bit_equal_to_xla_sqrt_of_the_same_square_sums():
    """100,000 seeded vectors per norm, spread over six decades: every root
    bit-equal (tolerance 0) to jnp.sqrt of the square sum that
    rounding.sq_norm3 (and norm2's fma chain) computes."""
    d3 = torch.from_numpy(_vectors(0, 3))
    s3 = rounding.sq_norm3(d3)
    want3 = np.asarray(jnp.sqrt(jnp.asarray(s3.numpy())))
    got3 = rounding.norm3(d3).numpy()
    assert int((got3.view(np.uint32) != want3.view(np.uint32)).sum()) == 0

    d2 = torch.from_numpy(_vectors(1, 2))
    s2 = rounding.fma(d2[:, 1], d2[:, 1], d2[:, 0] * d2[:, 0])
    want2 = np.asarray(jnp.sqrt(jnp.asarray(s2.numpy())))
    got2 = rounding.norm2(d2).numpy()
    assert int((got2.view(np.uint32) != want2.view(np.uint32)).sum()) == 0
