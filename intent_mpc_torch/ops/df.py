"""Double-float (compensated float32) arithmetic (port of
intent_mpc_tpu/ops/df.py).

Error-free transformations (Knuth two-sum, Dekker two-prod over a
bit-mask split) and a compensated matvec, so that the polish stage
(ops/polish.py) computes its KKT residuals to ~eps32^2 in float32.

These identities hold only if every product is rounded before it meets
an add: a product contracted into an add (an FMA) rounds once where the
transform assumes two, and its error term is garbage. Eager PyTorch runs
each operation as its own kernel and stores its rounded result, so
nothing here contracts, on the CPU or on the GPU. That is what the JAX
version's `_pin` (an opaque zero added to each product, against LLVM's
contraction inside one fused XLA loop) stands in for; this module needs
no such value. It keeps exactness by these rules, which a change must
keep too:
  * every step is one elementwise operation: no `torch.addcmul`,
    `torch.lerp`, `add(..., alpha=)` or `baddbmm`, and no
    `torch.compile` of these functions (its generated kernels may fuse
    a multiply into an add);
  * `split` masks the stored mantissa (immune to any float rewrite);
  * `_comp_reduce` keeps its pairwise halving order and never calls
    `torch.sum`.
tests/test_torch_df.py holds the identities on the CPU, and
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

# clears the low 12 stored-mantissa bits (0xFFFFF000 as int32)
_HI_MASK = -4096


def two_sum(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor):
    """Requires |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 12/12-bit mantissa split by bit masking: hi keeps 12
    significant bits, lo = a - hi is exact (same binade), and all four
    half-products fit float32's 24-bit mantissa exactly."""
    hi = (a.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p + e == a * b exactly (Dekker)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(ah, al, bh, bl):
    """(ah+al) + (bh+bl) -> normalized (hi, lo)."""
    s, e = two_sum(ah, bh)
    e = e + (al + bl)
    return fast_two_sum(s, e)


def df_neg(ah, al):
    return -ah, -al


def df_scale(ah, al, s):
    """(ah+al) * s for exact-ish scalar s (compensated)."""
    p, e = two_prod(ah, s)
    e = e + al * s
    return fast_two_sum(p, e)


def _comp_reduce(p: torch.Tensor, e: torch.Tensor, dim: int):
    """Pairwise-compensated reduction: sums `p` along `dim` with two_sum
    at every combine, accumulating all rounding into `e` (plain-summed:
    its magnitude is already ~eps * |terms|). Returns (hi, lo)."""
    n = p.shape[dim]
    while n > 1:
        half = n // 2
        s, err = two_sum(p.narrow(dim, 0, half), p.narrow(dim, half, half))
        ee = e.narrow(dim, 0, half) + e.narrow(dim, half, half) + err
        if 2 * half < n:   # odd leftover element rides along
            s0n, err0 = two_sum(s.narrow(dim, 0, 1), p.narrow(dim, 2 * half, 1))
            e0n = ee.narrow(dim, 0, 1) + e.narrow(dim, 2 * half, 1) + err0
            s = torch.cat([s0n, s.narrow(dim, 1, half - 1)], dim=dim)
            ee = torch.cat([e0n, ee.narrow(dim, 1, half - 1)], dim=dim)
        p, e = s, ee
        n = half
    return fast_two_sum(p.squeeze(dim), e.squeeze(dim))


def df_matvec(M: torch.Tensor, xh: torch.Tensor, xl: torch.Tensor):
    """M @ (xh + xl) with ~eps^2 accuracy. M (..., m, n) float32, x
    (..., n). Products are exact (two_prod); the reduction over n is
    pairwise-compensated, so massive cancellation (the residual case) is
    captured instead of rounded away. Elementwise work, no matmul."""
    p, e = two_prod(M, xh.unsqueeze(-2))
    e = e + M * xl.unsqueeze(-2)
    return _comp_reduce(p, e, dim=-1)


def df_dot_accurate(a: torch.Tensor, b: torch.Tensor):
    """Compensated dot product of two float32 vectors -> (hi, lo)."""
    p, e = two_prod(a, b)
    return _comp_reduce(p, e, dim=-1)
