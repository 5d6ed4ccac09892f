"""Counter-based random numbers: the Threefry-2x32 generator behind
`jax.random`, bit for bit, in torch integer ops.

The goal-mode RRT (models/global_planner.rrt_plan) draws its samples from
keys made as the JAX package makes them: `prng_key(1000 + seed)`, folded
with the cycle index, folded with the iteration, split in two, and drawn
from with `uniform`. Its routes match the JAX package's only if these bits
do, so this module reproduces `jax.random`'s threefry implementation in its
partitionable form (`jax_threefry_partitionable=True`, the default of
JAX 0.9): the Threefry-2x32 hash of 20 rounds, `fold_in` as the hash of the
counter pair (0, data), `split` and the random bits as the hash of the
(hi, lo) halves of a 64-bit iota over the output shape, and `uniform` from
the top 23 bits of each 32-bit word. `categorical` draws as JAX 0.9's
low-mode Gumbel-max sampler does (`jax._src.random._gumbel`,
`categorical`): `-log(-log(uniform(minval=tiny, maxval=1)))` over the
whole (samples, V) shape, the logits added and the first index of the
largest value taken.

A key is a tensor (..., 2) of uint32 values held in int64 (hi, lo); every
function takes keys with any leading batch shape, runs on the keys'
device, and keeps no state.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2); all uint32 values in int64 tensors that broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def prng_key(seed, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for integer seeds in [0, 2^32): (..., 2)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([(s >> 32) & _MASK, s & _MASK], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: key (..., 2), data a Python int or
    integers that broadcast against the key's batch shape (taken modulo
    2^32). A Python int is filled in on the device, not copied in."""
    if isinstance(data, int):
        d = torch.full(key.shape[:-1], data & _MASK, dtype=torch.int64,
                       device=key.device)
    else:
        d = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def _iota_pairs(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    n = 1
    for s in shape:
        n *= s
    c = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return (c >> 32) & _MASK, c & _MASK


def _hash_iota(key: torch.Tensor, shape: Sequence[int]):
    hi, lo = _iota_pairs(shape, key.device)
    extra = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + extra)
    k2 = key[..., 1].reshape(key.shape[:-1] + extra)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element: `jax.random.bits(key, shape)` for
    uint32, (..., *shape) int64 in [0, 2^32)."""
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=minval, maxval=maxval)` in
    float32: (..., *shape), `max(minval, floats * (maxval - minval) +
    minval)` with floats on [0, 1) and the product and sum as one FMA (the
    contraction of JAX's jitted `_uniform` on the CPU). Only the tests pass
    `minval` and `maxval` today; the port's draws are on [0, 1)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        # the same bits as _scale's +0.0 and clamp at 0, two launches fewer
        return floats
    return _scale(floats, minval, maxval)


def _scale(floats: torch.Tensor, minval: float, maxval: float):
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    if span == 1.0:                 # floats * 1 is exact: one rounding
        scaled = floats + float(lo)
    else:
        scaled = (floats.double() * float(span) + float(lo)).float()
    return torch.clamp(scaled, min=float(lo))


# --- the wide draws of `categorical`: the same hash in int32 lanes --------
#
# The Gumbel sampler hashes one counter per (sample, category): 134M
# counters per scenario for 16 samples over a DYNUS map of 8.38M voxels.
# These helpers run the Threefry rounds on int32 tensors in place
# (additions wrap; the logical right shift is an arithmetic one masked),
# half the bytes of the int64 form above and with no temporaries per op.

def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same 32 bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _rotl32_(x: torch.Tensor, r: int) -> torch.Tensor:
    low = torch.bitwise_right_shift(x, 32 - r).bitwise_and_((1 << r) - 1)
    return x.bitwise_left_shift_(r).bitwise_or_(low)


def _uniform_iota32(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` flattened, for one key (2,) and a
    shape of n < 2^31 elements: (n,) float32 on [0, 1)."""
    k1, k2 = _i32(key[0]), _i32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = torch.zeros((n,), dtype=torch.int32, device=key.device)
    x0 += ks[0]                      # the counters' high halves are 0
    x1 = torch.arange(n, dtype=torch.int32, device=key.device)
    x1 += ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            _rotl32_(x1, r)
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += i + 1
    x0 ^= x1
    x0 = torch.bitwise_right_shift(x0, 9).bitwise_and_(0x7FFFFF) \
        .bitwise_or_(0x3F800000)
    return x0.view(torch.float32).sub_(1.0)


def categorical(key: torch.Tensor, logits: torch.Tensor,
                samples: int) -> torch.Tensor:
    """`jax.random.categorical(key[s], logits[s][None].repeat(samples, 0),
    axis=-1)` for each scenario s: key (S, 2), logits (S, V) float32 ->
    (S, samples) int64 category indices.

    The draws are made one scenario at a time over the whole (samples, V)
    shape, whose iota the bits hash: a chunk of the category axis would
    be a different shape and draw other bits."""
    S, V = logits.shape
    if samples * V >= 1 << 31:
        raise ValueError("categorical: samples x categories must be < 2^31")
    tiny = float(np.finfo(np.float32).tiny)
    out = []
    for s in range(S):
        u = _uniform_iota32(key[s], samples * V).view(samples, V)
        g = _scale(u, tiny, 1.0).log_().neg_().log_().neg_()
        out.append(torch.argmax(g.add_(logits[s]), dim=-1))
    return torch.stack(out)
