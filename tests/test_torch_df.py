"""Port parity: intent_mpc_torch.ops.df (double-float arithmetic) against
the JAX package's jitted ops/df.py and float64 numpy, on numpy-seeded
inputs. The six tests of tests/test_df.py, parametrised as there.

The error-free transforms have one exact answer each (s = fl(a + b) and
its error, p = fl(a b) and its error, the masked split), so the port
must give the JAX package's bits: tolerance 0. The compensated matvec
and dot are held to float64 at the JAX tests' limits (1e-12 relative),
and to the JAX results at the same limit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.ops import df as jdf
from intent_mpc_torch.ops import df as tdf

torch.set_num_threads(1)


def _rand(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _f64(*ts):
    return [np.asarray(t, np.float64) for t in ts]


def test_two_sum_exact_under_jit():
    a, b = _rand(0, (4096,)), _rand(1, (4096,), 1e-4)
    s, e = tdf.two_sum(torch.as_tensor(a), torch.as_tensor(b))
    js, je = jax.jit(jdf.two_sum)(jnp.asarray(a), jnp.asarray(b))
    s64, e64, a64, b64 = _f64(s, e, a, b)
    np.testing.assert_array_equal(s64 + e64, a64 + b64)
    assert np.any(e64 != 0.0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_two_prod_exact_under_jit():
    a, b = _rand(2, (4096,)), _rand(3, (4096,))
    p, e = tdf.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    jp, je = jax.jit(jdf.two_prod)(jnp.asarray(a), jnp.asarray(b))
    p64, e64, a64, b64 = _f64(p, e, a, b)
    np.testing.assert_array_equal(p64 + e64, a64 * b64)
    assert np.any(e64 != 0.0)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_split_is_exact_and_fma_immune():
    a = _rand(4, (4096,), 1e6)
    hi, lo = tdf.split(torch.as_tensor(a))
    np.testing.assert_array_equal(hi.numpy() + lo.numpy(), a)
    h64, l64 = _f64(hi, lo)
    np.testing.assert_array_equal(
        (h64 * h64).astype(np.float32).astype(np.float64), h64 * h64)
    np.testing.assert_array_equal(
        (l64 * l64).astype(np.float32).astype(np.float64), l64 * l64)
    jhi, jlo = jax.jit(jdf.split)(jnp.asarray(a))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


@pytest.mark.parametrize("n", [7, 64, 385, 1024])
def test_df_matvec_near_f64(n):
    """Compensated matvec ~eps32^2 accurate against float64, and against
    the JAX package's jitted one."""
    M, x = _rand(5, (n, n)), _rand(6, (n,))
    hi, lo = tdf.df_matvec(torch.as_tensor(M), torch.as_tensor(x),
                           torch.zeros(n))
    ref = M.astype(np.float64) @ x.astype(np.float64)
    h64, l64 = _f64(hi, lo)
    got = h64 + l64
    err = np.max(np.abs(got - ref) / (np.abs(ref) + 1.0))
    assert err < 1e-12, f"compensated matvec err {err:.3e}"
    jh, jl = jax.jit(jdf.df_matvec)(jnp.asarray(M), jnp.asarray(x),
                                    jnp.zeros(n, jnp.float32))
    jgot = np.sum(_f64(jh, jl), axis=0)
    assert np.max(np.abs(got - jgot) / (np.abs(ref) + 1.0)) < 1e-12


def test_df_matvec_captures_cancellation():
    """The residual case: b - M x with b ~ M x. Plain float32 loses all
    signal; the compensated path recovers it (error < 1e-9 and 1e4 times
    below plain float32's), as the JAX one does."""
    n = 385
    M, x = _rand(7, (n, n)), _rand(8, (n,))
    b64 = M.astype(np.float64) @ x.astype(np.float64)
    b = b64.astype(np.float32)
    ref = b.astype(np.float64) - b64
    tM, tx, tb = (torch.as_tensor(v) for v in (M, x, b))
    ph, pl = tdf.df_matvec(tM, tx, torch.zeros_like(tx))
    rh, rl = tdf.df_add(tb, torch.zeros_like(tb), -ph, -pl)
    err_df = np.max(np.abs((rh + rl).numpy().astype(np.float64) - ref))
    err_f32 = np.max(np.abs((tb - tM @ tx).numpy().astype(np.float64) - ref))
    assert err_df < 1e-9, f"df residual err {err_df:.3e}"
    assert err_df < err_f32 * 1e-4, (err_df, err_f32)

    @jax.jit
    def resid_df(M, x, b):
        ph, pl = jdf.df_matvec(M, x, jnp.zeros_like(x))
        rh, rl = jdf.df_add(b, jnp.zeros_like(b), -ph, -pl)
        return rh + rl
    jerr = np.max(np.abs(np.asarray(resid_df(*(jnp.asarray(v) for v in
                                               (M, x, b))), np.float64)
                         - ref))
    assert jerr < 1e-9, jerr


def test_df_dot_exact():
    a, b = _rand(9, (4096,)), _rand(10, (4096,))
    hi, lo = tdf.df_dot_accurate(torch.as_tensor(a), torch.as_tensor(b))
    ref = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    got = float(hi) + float(lo)
    assert abs(got - ref) / (abs(ref) + 1.0) < 1e-12
    jh, jl = jax.jit(jdf.df_dot_accurate)(jnp.asarray(a), jnp.asarray(b))
    assert abs(got - (float(jh) + float(jl))) / (abs(ref) + 1.0) < 1e-12
