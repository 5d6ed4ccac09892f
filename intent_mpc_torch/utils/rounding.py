"""float32 arithmetic rounded as the JAX package's compiled CPU program
rounds it.

XLA's CPU backend contracts a product into the add that follows it (one
rounding, a fused multiply-add) and reduces a trailing axis of 3 as
fma(z, z, fma(y, y, x * x)); a (..., 3) x (3, 3) product on the CPU, in
XLA and in PyTorch alike, is the same chain. Where the real-perception
stack turns such values into discrete decisions (which voxels are
nearest, which point pairs fall within the DBSCAN radius, which pixel's
ray hits a box), the port computes them with these roundings, emulated
exactly in float64 (the product of two float32 numbers is exact there),
so that its decisions follow JAX's and the card's follow the CPU's.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to float32."""
    return (a.double() * b.double() + c.double()).float()


def fma_sq(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * a + c with one rounding to float32."""
    return (a.double().square_() + c.double()).float()


def sq_sum3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 as fma(z, z, fma(y, y, x * x))."""
    return fma_sq(z, fma_sq(y, x * x))


def sq_norm3(d: torch.Tensor) -> torch.Tensor:
    """sum(d ** 2, -1) of d (..., 3), rounded as sq_sum3."""
    return sq_sum3(d[..., 0], d[..., 1], d[..., 2])


def norm3(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_norm3(d))


def matmul3(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v @ m for v (..., N, 3) and m (..., 3, 3) as the chain
    fma(v2, m[2], fma(v1, m[1], v0 * m[0])) per output column."""
    v = v[..., :, :, None]                                  # (..., N, 3, 1)
    m = m[..., None, :, :]                                  # (..., 1, 3, 3)
    return fma(v[..., 2, :], m[..., 2, :],
               fma(v[..., 1, :], m[..., 1, :], v[..., 0, :] * m[..., 0, :]))
