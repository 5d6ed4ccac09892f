"""Fixed-iteration over-relaxed ADMM on a materialized, Ruiz-scaled dense
constraint matrix, one candidate per problem (port of
intent_mpc_tpu/ops/pallas_admm.py).

For each candidate, with its scaled A (m_pad, n_pad), explicit inverse
Minv and normal matrix M (n_pad, n_pad):

    x = x0; z = A x; y = 0
    repeat iters:
      rhs = sigma x - q + A^T (rho z - y)
      xt  = Minv rhs;  `refine` times: xt += Minv (rhs - M xt)
      zt  = A xt
      x   = alpha xt + (1 - alpha) x;  zr = alpha zt + (1 - alpha) z
      z   = clip(zr + y / rho, lo, hi);  y = y + rho (zr - z)
    return x   (scaled)

The problem is built by ops/admm.py::_dense_scaled_problem and solved
through the entry point ops/admm.py::admm_solve_dense. No closed-loop
path reaches it.

`admm_iterations_dense` launches the hand-written CUDA kernel
csrc/dense_loop.cu once per call when the problem lies on a CUDA device,
and runs `dense_loop_reference`, the plain PyTorch version with the TPU
kernel's operation order, when it lies on the CPU. There is no
fallback: a CUDA problem either launches the kernel or raises, also
when its shapes exceed what the kernel takes. The kernel holds each
candidate's A as CSR in shared memory, `csr_capacity(n_pad, m_pad)`
nonzeros at most; a candidate with more fails a device-side assert.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from intent_mpc_torch.utils import trace

# what dense_loop_launch returns for shapes the kernel does not take
_CUDA_ERROR_INVALID_VALUE = 1

# The kernel's shared-memory plan (csrc/dense_loop.cu::plan; checked
# against the built kernel when it loads): a block's bytes less its static
# arrays, the Minv ring, and per nonzero of the CSR its value, column, row
# and place in the A^T lists.
_SMEM_BYTES = 232448 - 1024
_RING_BYTES = 16 * 4 * 64 * 16
_BYTES_PER_NONZERO = 10


def _round8(v: int) -> int:
    return (v + 7) & ~7


def csr_capacity(n_pad: int, m_pad: int) -> int:
    """The nonzeros per candidate the kernel's shared-memory CSR holds at
    these shapes (a multiple of 8; 0 when its vectors and ring alone do
    not fit): what is left after the ring, x, x-tilde, rhs, the residual
    and q (n_pad floats each), z, y and rho (m_pad rounded up to 4 each)
    and the row and column pointers (uint16, rounded up to 8 each)."""
    ms = (m_pad + 3) & ~3
    fixed = (_RING_BYTES + 4 * (5 * n_pad + 3 * ms)
             + 2 * (_round8(m_pad + 1) + _round8(n_pad + 1)))
    left = _SMEM_BYTES - fixed
    return 0 if left < 80 else (left // _BYTES_PER_NONZERO) & ~7


class DenseScaledProblem(NamedTuple):
    """Per-candidate scaled problem, leading axis C (candidates). The
    vectors drop the JAX version's trailing column of 1: q and x0 are
    (C, n_pad) where JAX has (C, n_pad, 1), and rho, lo, hi (C, m_pad)."""

    minv: torch.Tensor   # (C, n_pad, n_pad)
    mmat: torch.Tensor   # (C, n_pad, n_pad)
    amat: torch.Tensor   # (C, m_pad, n_pad) scaled constraint matrix
    q: torch.Tensor      # (C, n_pad)
    x0: torch.Tensor     # (C, n_pad)
    rho: torch.Tensor    # (C, m_pad)
    lo: torch.Tensor     # (C, m_pad)
    hi: torch.Tensor     # (C, m_pad)


def dense_loop_reference(sp: DenseScaledProblem, iters: int, sigma: float,
                         alpha: float, refine: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel body (pallas_admm.py:70-116)
    in its operation order, batched over candidates: the CPU path and the
    kernel's check. Returns the scaled x (C, n_pad)."""
    A = sp.amat

    def mv(mat, v):
        return torch.matmul(mat, v[..., None])[..., 0]

    def at_mv(w):     # A^T w without a stored A^T
        return torch.matmul(w[..., None, :], A)[..., 0, :]

    x = sp.x0
    z = mv(A, x)
    y = torch.zeros_like(z)
    for _ in range(iters):
        rhs = sigma * x - sp.q + at_mv(sp.rho * z - y)
        xt = mv(sp.minv, rhs)
        for _ in range(refine):
            r = rhs - mv(sp.mmat, xt)
            xt = xt + mv(sp.minv, r)
        zt = mv(A, xt)
        x_n = alpha * xt + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        z_n = torch.clamp(zr + y / sp.rho, sp.lo, sp.hi)
        y = y + sp.rho * (zr - z_n)
        x, z = x_n, z_n
    return x


_PTR = ctypes.c_void_p


class _DenseArgs(ctypes.Structure):
    """Mirror of `DenseArgs` in csrc/dense_loop.cu (same field order)."""
    _fields_ = (
        [(k, _PTR) for k in ("minv", "mmat", "amat", "q", "x0", "rho", "lo",
                             "hi", "x_out", "status")]
        + [(k, ctypes.c_int) for k in ("C", "n_pad", "m_pad", "iters",
                                       "refine")]
        + [(k, ctypes.c_float) for k in ("sigma", "alpha", "beta")])


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from intent_mpc_torch.ops import build
        lib = build.load("dense_loop")
        lib.dense_loop_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dense_loop_launch.restype = ctypes.c_int
        lib.dense_loop_args_size.argtypes = []
        lib.dense_loop_args_size.restype = ctypes.c_int
        lib.dense_loop_csr_capacity.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dense_loop_csr_capacity.restype = ctypes.c_int
        if lib.dense_loop_args_size() != ctypes.sizeof(_DenseArgs):
            raise RuntimeError("dense_loop argument struct size mismatch: "
                               "%d (CUDA) vs %d (ctypes)"
                               % (lib.dense_loop_args_size(),
                                  ctypes.sizeof(_DenseArgs)))
        for shape in ((512, 2560), (128, 256), (128, 12800)):
            if lib.dense_loop_csr_capacity(*shape) != csr_capacity(*shape):
                raise RuntimeError(
                    "dense_loop CSR capacity at %s: %d (CUDA) vs %d"
                    % (shape, lib.dense_loop_csr_capacity(*shape),
                       csr_capacity(*shape)))
        _LIB = lib
    return _LIB


def _check(sp: DenseScaledProblem) -> None:
    if sp.minv.dim() != 3:
        raise ValueError("DenseScaledProblem.minv must be (C, n_pad, n_pad), "
                         "got shape %s" % (tuple(sp.minv.shape),))
    C, n_pad = sp.minv.shape[0], sp.minv.shape[-1]
    m_pad = sp.amat.shape[-2]
    want = {"minv": (C, n_pad, n_pad), "mmat": (C, n_pad, n_pad),
            "amat": (C, m_pad, n_pad), "q": (C, n_pad), "x0": (C, n_pad),
            "rho": (C, m_pad), "lo": (C, m_pad), "hi": (C, m_pad)}
    dev = sp.minv.device
    for f, shape in want.items():
        t = getattr(sp, f)
        if tuple(t.shape) != shape:
            raise ValueError("DenseScaledProblem.%s has shape %s, expected %s"
                             % (f, tuple(t.shape), shape))
        if t.dtype != torch.float32:
            raise TypeError("DenseScaledProblem.%s must be float32, got %s"
                            % (f, t.dtype))
        if t.device != dev:
            raise ValueError("DenseScaledProblem leaves must share one device")
        if not t.is_contiguous():
            raise ValueError("DenseScaledProblem.%s must be contiguous" % f)


def admm_iterations_dense(sp: DenseScaledProblem, iters: int, sigma: float,
                          alpha: float, refine: int = 1) -> torch.Tensor:
    """Run the whole loop for all candidates; returns the scaled x
    (C, n_pad). A kernel launch counts as "dense_loop.launches" in
    utils/trace."""
    _check(sp)
    dev = sp.minv.device
    if dev.type == "cpu":
        return dense_loop_reference(sp, iters, sigma, alpha, refine)
    if dev.type != "cuda":
        raise ValueError("admm_iterations_dense runs on CPU or CUDA tensors, "
                         "got %s" % dev)
    C, n_pad = sp.q.shape
    m_pad = sp.rho.shape[-1]
    if iters < 0 or refine < 0:
        raise ValueError("iters and refine must be >= 0")
    x = torch.empty((C, n_pad), dtype=torch.float32, device=dev)
    status = torch.empty((C,), dtype=torch.int32, device=dev)
    a = _DenseArgs()
    for k in ("minv", "mmat", "amat", "q", "x0", "rho", "lo", "hi"):
        setattr(a, k, getattr(sp, k).data_ptr())
    a.x_out, a.status = x.data_ptr(), status.data_ptr()
    a.C, a.n_pad, a.m_pad, a.iters, a.refine = C, n_pad, m_pad, iters, refine
    a.sigma, a.alpha = sigma, alpha
    a.beta = 1.0 - alpha      # rounded to float once, as torch rounds it
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().dense_loop_launch(ctypes.addressof(a), stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            "dense_loop kernel does not take n_pad = %d, m_pad = %d: it needs "
            "n_pad a multiple of 4 from kMinN to kMaxN and the block's "
            "vectors and ring within one block's shared memory "
            "(csrc/dense_loop.cu)" % (n_pad, m_pad))
    if err != 0:
        raise RuntimeError("dense_loop kernel launch failed: cudaError %d"
                           % err)
    trace.count("dense_loop.launches")
    # a candidate whose A did not fit the CSR stopped with its count in
    # status: fail on the device, without a host sync
    if C:
        torch._assert_async(
            torch.all(status == 0),
            "dense_loop: a candidate's A has more nonzeros than the kernel's "
            "CSR holds (%d at n_pad = %d, m_pad = %d)"
            % (csr_capacity(n_pad, m_pad), n_pad, m_pad))
    return x
