"""Fused elementwise tail of one ADMM iteration (port of
intent_mpc_tpu/ops/pallas_ew.py).

    x_n = alpha * x_t + (1 - alpha) * x
    zr  = alpha * z_t + (1 - alpha) * z          (per constraint group)
    z_n = clip(zr + y / rho, l, u)
    y_n = y + rho * (zr - z_n)
    rzy = rho * z_n - y_n                        (feeds A^T next iteration)

`ew_chain` launches the hand-written CUDA kernel csrc/ew_chain.cu once
for the whole batch (x and all four groups) when its inputs lie on a
CUDA device, and runs `ew_chain_reference`, the plain PyTorch version
with the same operation order, when they lie on the CPU. There is no
fallback: a CUDA input either launches the kernel or raises.

The TPU version needed a custom_vmap to collapse the engine's
(scenario, candidate) vmaps into one launch; here the batch axes are
already explicit, so the kernel walks each group's contiguous
(..., rows, width) buffer as one flat segment.
"""

from __future__ import annotations

import ctypes

import torch

from intent_mpc_torch.ops.qp import ConVec

# kernel launches since the last reset (only the CUDA path counts)
EW_LAUNCHES = 0

NUM_GROUPS = 4
_PTR = ctypes.c_void_p


class _EwArgs(ctypes.Structure):
    """Mirror of `EwArgs` in csrc/ew_chain.cu (same field order)."""
    _fields_ = (
        [("x", _PTR), ("x_t", _PTR)]
        + [("%s%d" % (k, g), _PTR) for k in ("z", "y", "zt", "rho", "l", "u")
           for g in range(NUM_GROUPS)]
        + [("x_n", _PTR)]
        + [("%s%d" % (k, g), _PTR) for k in ("z_n", "y_n", "rzy")
           for g in range(NUM_GROUPS)]
        + [("n_x", ctypes.c_int64)]
        + [("n%d" % g, ctypes.c_int64) for g in range(NUM_GROUPS)]
        + [("alpha", ctypes.c_float), ("beta", ctypes.c_float)])


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from intent_mpc_torch.ops import build
        lib = build.load("ew_chain")
        lib.ew_chain_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ew_chain_launch.restype = ctypes.c_int
        lib.ew_chain_args_size.argtypes = []
        lib.ew_chain_args_size.restype = ctypes.c_int
        if lib.ew_chain_args_size() != ctypes.sizeof(_EwArgs):
            raise RuntimeError("ew_chain argument struct size mismatch: "
                               "%d (CUDA) vs %d (ctypes)"
                               % (lib.ew_chain_args_size(),
                                  ctypes.sizeof(_EwArgs)))
        _LIB = lib
    return _LIB


def ew_chain_reference(alpha: float, x, x_t, z: ConVec, y: ConVec,
                       zt: ConVec, rho: ConVec, l: ConVec, u: ConVec):
    """Plain PyTorch version of the chain, in the reference's operation
    order (pallas_ew.ew_reference): the CPU path and the kernel's check."""
    x_n = alpha * x_t + (1.0 - alpha) * x
    zr = zt.map(lambda zt_g, z_g: alpha * zt_g + (1.0 - alpha) * z_g, z)
    z_n = zr.map(lambda zr_g, y_g, r_g, l_g, u_g:
                 torch.clamp(zr_g + y_g / r_g, l_g, u_g), y, rho, l, u)
    y_n = y.map(lambda y_g, zr_g, zn_g, r_g: y_g + r_g * (zr_g - zn_g),
                zr, z_n, rho)
    rzy = z_n.map(lambda zn_g, r_g, yn_g: r_g * zn_g - yn_g, rho, y_n)
    return x_n, z_n, y_n, rzy


def _check(x, x_t, groups):
    tensors = [x, x_t] + [a for grp in groups for a in grp]
    dev = x.device
    for a in tensors:
        if a.dtype != torch.float32:
            raise TypeError("ew_chain takes float32 tensors, got %s" % a.dtype)
        if a.device != dev:
            raise ValueError("ew_chain inputs must share one device")
        if not a.is_contiguous():
            raise ValueError("ew_chain inputs must be contiguous")
    if x_t.shape != x.shape:
        raise ValueError("x_t shape %s != x shape %s"
                         % (tuple(x_t.shape), tuple(x.shape)))
    for g in range(NUM_GROUPS):
        shape = groups[0][g].shape
        for arr in groups[1:]:
            if arr[g].shape != shape:
                raise ValueError("group %d: shapes %s and %s differ"
                                 % (g, tuple(shape), tuple(arr[g].shape)))


def ew_chain(alpha: float, x, x_t, z: ConVec, y: ConVec, zt: ConVec,
             rho: ConVec, l: ConVec, u: ConVec):
    """Returns (x_n, z_n: ConVec, y_n: ConVec, rzy: ConVec).

    All inputs are float32, contiguous and on one device; each group's
    six tensors share one shape, and x, x_t share another."""
    global EW_LAUNCHES
    groups = (z, y, zt, rho, l, u)
    _check(x, x_t, groups)
    if x.device.type == "cpu":
        return ew_chain_reference(alpha, x, x_t, z, y, zt, rho, l, u)
    if x.device.type != "cuda":
        raise ValueError("ew_chain runs on CPU or CUDA tensors, got %s"
                         % x.device)

    x_n = torch.empty_like(x)
    z_n = ConVec(*(torch.empty_like(a) for a in z))
    y_n = ConVec(*(torch.empty_like(a) for a in z))
    rzy = ConVec(*(torch.empty_like(a) for a in z))
    args = _EwArgs()
    args.x, args.x_t, args.x_n = x.data_ptr(), x_t.data_ptr(), x_n.data_ptr()
    for g in range(NUM_GROUPS):
        for k, grp in zip(("z", "y", "zt", "rho", "l", "u"), groups):
            setattr(args, "%s%d" % (k, g), grp[g].data_ptr())
        for k, grp in zip(("z_n", "y_n", "rzy"), (z_n, y_n, rzy)):
            setattr(args, "%s%d" % (k, g), grp[g].data_ptr())
        setattr(args, "n%d" % g, z[g].numel())
    args.n_x = x.numel()
    args.alpha = alpha
    args.beta = 1.0 - alpha     # rounded to float once, as torch rounds it
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ew_chain_launch(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError("ew_chain kernel launch failed: cudaError %d" % err)
    EW_LAUNCHES += 1
    return x_n, z_n, y_n, rzy
