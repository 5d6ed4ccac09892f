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
the top 23 bits of each 32-bit word.

A key is a tensor (..., 2) of uint32 values held in int64 (hi, lo); every
function takes keys with any leading batch shape, runs on the keys'
device, and keeps no state.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def uniform(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` in float32 on [0, 1):
    (..., *shape)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
