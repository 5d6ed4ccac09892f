"""Port parity: intent_mpc_torch.ops.ew_chain (the elementwise ADMM tail)
against the JAX package's ew_reference and its Pallas kernel in interpret
mode. The CUDA kernel against its plain version on a GPU is in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.ops import pallas_ew as pe
from intent_mpc_tpu.ops.qp import ConVec as JConVec
from intent_mpc_torch.ops import ew_chain as ew
from intent_mpc_torch.ops.qp import ConVec

torch.set_num_threads(1)

ALPHA = 1.6
H, W, K, N = 10, 9, 8, 125


def _random_args(rng, batch):
    """x, x_t, then z, y, zt, rho, l, u as lists of 4 group arrays."""
    shapes = [(H, 8), (H, 8), (W, 5), (W, K)]

    def grp(lo, hi):
        return [rng.uniform(lo, hi, batch + s).astype(np.float32)
                for s in shapes]
    x = rng.randn(*batch, N).astype(np.float32)
    x_t = rng.randn(*batch, N).astype(np.float32)
    return [x, x_t, grp(-2, 2), grp(-2, 2), grp(-2, 2), grp(0.05, 2.0),
            grp(-3, 0), grp(0, 3)]


def _production_args(rng, batch):
    """The regime of the infeasible DYNUS QPs: +-inf bounds, equality rows,
    rho = 1e-6 on loose rows, obstacle duals of ~1e4, one NaN row."""
    args = _random_args(rng, batch)
    z, y, zt, rho, lo, hi = args[2:]
    for g in range(4):
        loose = rng.rand(*lo[g].shape) < 0.3
        lo[g][loose | (rng.rand(*lo[g].shape) < 0.1)] = -np.inf
        hi[g][loose] = np.inf
        rho[g][loose] = 1e-6
    lo[0][:] = hi[0]                       # equality rows
    rho[0][:] = 100.0
    y[3] *= 1e4
    z[3][(0,) * len(batch)] = np.nan
    args[0][(1,) * len(batch)] = np.nan
    return args


def _torch_args(args):
    t = [torch.as_tensor(a) for a in args[:2]]
    return t + [ConVec(*(torch.as_tensor(a) for a in grp)) for grp in args[2:]]


def _jax_args(args):
    j = [jnp.asarray(a) for a in args[:2]]
    return j + [JConVec(*(jnp.asarray(a) for a in grp)) for grp in args[2:]]


def _flat(outs):
    x_n, z_n, y_n, rzy = outs
    return [x_n] + list(z_n) + list(y_n) + list(rzy)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def test_reference_matches_jax_and_interpret_kernel():
    """Two batch axes (scenario x candidate), random values. The plain
    version runs the same float32 operations in the same order as
    ew_reference; the interpret-mode Pallas kernel runs them once more
    under two vmap levels. Tolerance atol = rtol = 1e-6 (float32)."""
    rng = np.random.RandomState(0)
    args = _random_args(rng, (2, 5))
    got = ew.ew_chain_reference(ALPHA, *_torch_args(args))
    ref = jax.vmap(jax.vmap(lambda *a: pe.ew_reference(ALPHA, *a)))(
        *_jax_args(args))
    kern = jax.vmap(jax.vmap(lambda *a: pe.ew_chain(
        ALPHA, *a, use_pallas=True, interpret=True)))(*_jax_args(args))
    for g, r, k in zip(_flat(got), _flat(ref), _flat(kern)):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(_np(g), _np(k), atol=1e-6, rtol=1e-6)


def test_production_regime_matches_jax():
    """+-inf bounds, rho = 1e-6, duals of 1e4 and a NaN row. NaN positions
    must be identical (the clip keeps NaN, so a broken iterate stays
    visible to the acceptance test). Elsewhere both sides perform the
    same float32 operations in the same order; rtol 1e-6 admits a one-ulp
    difference should XLA fuse differently, and atol 1e-6 covers values
    that cancel to ~0."""
    rng = np.random.RandomState(1)
    args = _production_args(rng, (3, 2))
    got = ew.ew_chain_reference(ALPHA, *_torch_args(args))
    ref = jax.vmap(jax.vmap(lambda *a: pe.ew_reference(ALPHA, *a)))(
        *_jax_args(args))
    n_nan = 0
    for g, r in zip(_flat(got), _flat(ref)):
        g, r = _np(g), _np(r)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        n_nan += int(np.isnan(g).sum())
        ok = ~np.isnan(g)
        np.testing.assert_allclose(g[ok], r[ok], atol=1e-6, rtol=1e-6)
    assert n_nan > 0


def test_cpu_dispatch_runs_plain_version_and_counts_nothing():
    """On CPU tensors the wrapper runs the plain version; only a kernel
    launch adds to the count."""
    rng = np.random.RandomState(2)
    args = _torch_args(_production_args(rng, (4,)))
    before = ew.EW_LAUNCHES
    got = ew.ew_chain(ALPHA, *args)
    want = ew.ew_chain_reference(ALPHA, *args)
    assert ew.EW_LAUNCHES == before
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


def test_wrapper_rejects_bad_inputs():
    rng = np.random.RandomState(3)
    args = _torch_args(_random_args(rng, (2,)))
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        ew.ew_chain(ALPHA, *bad)
    bad = list(args)
    bad[2] = args[2]._replace(obs=args[2].obs.transpose(-1, -2).contiguous()
                              .transpose(-1, -2))
    with pytest.raises(ValueError):
        ew.ew_chain(ALPHA, *bad)
    bad = list(args)
    bad[3] = args[3]._replace(cb=args[3].cb[:1])
    with pytest.raises(ValueError):
        ew.ew_chain(ALPHA, *bad)
