"""Bit-exact reimplementation of std::mt19937 + libstdc++ uniform_real_distribution.

The reference world generator seeds `std::mt19937 rng(seed)` and draws
`std::uniform_real_distribution<double>(0,1)` values
(dynus_obstacles_ros1/src/dynus_obstacles_node.cpp:74-75). Reproducing the
exact draw sequence lets our seeded scenarios match the reference's obstacle
fields bit-for-bit, which is the reference's reproducibility contract
(same seed => identical world).

This runs host-side at scenario-construction time only; it is not on the
device compute path.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


class MT19937:
    """Standard 32-bit Mersenne Twister (identical to std::mt19937)."""

    def __init__(self, seed: int = 5489):
        self.mt = np.empty(_N, dtype=np.uint64)
        self.mt[0] = seed & _U32
        for i in range(1, _N):
            prev = int(self.mt[i - 1])
            self.mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & _U32
        self.index = _N

    def _twist(self) -> None:
        mt = self.mt
        for i in range(_N):
            y = (int(mt[i]) & _UPPER_MASK) | (int(mt[(i + 1) % _N]) & _LOWER_MASK)
            nxt = int(mt[(i + _M) % _N]) ^ (y >> 1)
            if y & 1:
                nxt ^= _MATRIX_A
            mt[i] = nxt & _U32
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= _N:
            self._twist()
        y = int(self.mt[self.index])
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _U32

    def uniform(self, a: float = 0.0, b: float = 1.0) -> float:
        """libstdc++ uniform_real_distribution<double>: generate_canonical with
        53 bits draws two 32-bit words; u = (w0 + w1*2^32) / 2^64."""
        w0 = self.next_u32()
        w1 = self.next_u32()
        u = (w0 + w1 * 4294967296.0) / 18446744073709551616.0
        if u >= 1.0:  # libstdc++ clamps the (theoretically possible) 1.0
            u = np.nextafter(1.0, 0.0)
        return u * (b - a) + a
