"""The scaled constraint operator of the default ADMM iteration.

`admm_solve` applies the QP's constraint matrix A (ops/qp.py's closed
forms) scaled by its Ruiz factors D (columns) and E (rows) in three ways:

    forward(x)                    E * A(D x)                     (a_s)
    transpose(w)                  D * A^T(E * w)                 (at_s)
    normal(rho, h_s, sigma, v)    h_s v + sigma v
                                  + D * A^T(E * rho * E * A(D v))  (m_apply)

`ConstraintOpReference` computes them with plain PyTorch in that order:
the CPU path, and the reference of the kernel's tests. `ConstraintOp`
launches the hand-written CUDA kernel csrc/constraint_op.cu once per
entry for the whole batch; it takes CUDA tensors only, and admm_solve
picks one of the two by the QP's device. There is no fallback: a CUDA
input either launches the kernel or raises.

Both bind one QP batch and its scaling once per solve. The batch axes are
the QP's leading axes (..., C); D, E and h_s either carry them all or
hold one row per group of C (a shared factor, shape (..., 1, ...)): the
kernel then reads them at candidate stride 0, decided from the shapes.
"""

from __future__ import annotations

import ctypes
import math

import torch

from intent_mpc_torch.ops import qp as qplib
from intent_mpc_torch.ops.qp import ConVec, QPData
from intent_mpc_torch.utils import trace
from intent_mpc_torch.utils.config import PlannerConfig

FORWARD, TRANSPOSE, NORMAL = 0, 1, 2   # the kernel's Mode
NUM_GROUPS = 4
_PTR = ctypes.c_void_p
_I32 = ctypes.c_int32


class _OpArgs(ctypes.Structure):
    """Mirror of `OpArgs` in csrc/constraint_op.cu (same field order)."""
    _fields_ = (
        [("x", _PTR), ("w", _PTR * NUM_GROUPS), ("d", _PTR),
         ("e", _PTR * NUM_GROUPS), ("rho", _PTR * NUM_GROUPS), ("hs", _PTR),
         ("g", _PTR), ("dyn", _PTR), ("act", _PTR), ("slk", _PTR),
         ("out", _PTR), ("z", _PTR * NUM_GROUPS),
         ("problems", ctypes.c_int64)]
        + [(k, _I32) for k in ("cands", "horizon", "slots", "d_per_cand",
                               "e_per_cand", "hs_per_cand", "mode")]
        + [(k, ctypes.c_float) for k in ("ts", "c2", "sigma")])


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from intent_mpc_torch.ops import build
        lib = build.load("constraint_op")
        lib.constraint_op_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.constraint_op_launch.restype = ctypes.c_int
        lib.constraint_op_args_size.argtypes = []
        lib.constraint_op_args_size.restype = ctypes.c_int
        if lib.constraint_op_args_size() != ctypes.sizeof(_OpArgs):
            raise RuntimeError("constraint_op argument struct size mismatch: "
                               "%d (CUDA) vs %d (ctypes)"
                               % (lib.constraint_op_args_size(),
                                  ctypes.sizeof(_OpArgs)))
        _LIB = lib
    return _LIB


class ConstraintOpReference:
    """The three entries in plain PyTorch, in admm_solve's operation order
    (any dtype, any device)."""

    def __init__(self, cfg: PlannerConfig, qp: QPData, D: torch.Tensor,
                 E: ConVec):
        self.cfg, self.qp, self.D, self.E = cfg, qp, D, E

    def forward(self, x: torch.Tensor) -> ConVec:
        return qplib.a_matvec(self.cfg, self.qp, self.D * x).scale(self.E)

    def transpose(self, w: ConVec) -> torch.Tensor:
        return self.D * qplib.at_matvec(self.cfg, self.qp, w.scale(self.E))

    def normal(self, rho: ConVec, h_s: torch.Tensor, sigma: float,
               v: torch.Tensor) -> torch.Tensor:
        return h_s * v + sigma * v + self.transpose(self.forward(v).map(
            lambda a, ri: a * ri, rho))


class ConstraintOp:
    """The entries through csrc/constraint_op.cu. Every tensor is float32,
    contiguous and on the QP's CUDA device; the QP's tensors, rho and the
    vectors carry the QP's leading axes, D, E and h_s those or a shared
    factor's. A wrong dtype, shape, device or layout raises before
    anything launches, and so does a QP that is not on a CUDA device.
    Each launch counts as "constraint_op.launches" in utils/trace."""

    def __init__(self, cfg: PlannerConfig, qp: QPData, D: torch.Tensor,
                 E: ConVec):
        self.lead = tuple(qp.q.shape[:-1])
        self.device = qp.q.device
        H, W, K = cfg.horizon, cfg.mpc_window, qp.G.shape[-2]
        self.n = cfg.num_vars
        # the trailing shapes of the groups eq, sb, cb, obs
        self.tails = ((H, qplib.NX), (H, qplib.NX), (W, qplib.NU), (W, K))
        wk = self.tails[3]
        self._check("q", qp.q, (self.n,))
        self._check("G", qp.G, wk + (3,))
        for name in ("obs_dyn", "obs_active", "obs_slack"):
            self._check(name, getattr(qp, name), wk)
        d_pc = self._per_cand("D", D, (self.n,))
        e_pc = {self._per_cand("E", e, t) for e, t in zip(E, self.tails)}
        if len(e_pc) != 1:
            raise ValueError("E's groups must all be shared or all not")
        if self.device.type != "cuda":
            raise ValueError("constraint_op runs on CUDA tensors; the QP is "
                             "on %s" % self.device)
        a = _OpArgs()
        a.d = D.data_ptr()
        for i, e in enumerate(E):
            a.e[i] = e.data_ptr()
        a.g = qp.G.data_ptr()
        a.dyn, a.act, a.slk = (qp.obs_dyn.data_ptr(),
                               qp.obs_active.data_ptr(),
                               qp.obs_slack.data_ptr())
        a.problems = math.prod(self.lead)
        a.cands = self.lead[-1] if self.lead else 1
        a.horizon, a.slots = H, K
        a.d_per_cand, a.e_per_cand = d_pc, e_pc.pop()
        # rounded to float once, as PyTorch rounds a Python scalar factor
        a.ts, a.c2 = cfg.ts, 0.5 * cfg.ts * cfg.ts
        self.args = a

    def _check(self, name, t, tail, shapes=None):
        if not torch.is_tensor(t) or t.dtype != torch.float32:
            raise TypeError("constraint_op takes float32 tensors; %s is %s"
                            % (name, getattr(t, "dtype", type(t))))
        if t.device != self.device:
            raise ValueError("constraint_op: %s is on %s, the QP on %s"
                             % (name, t.device, self.device))
        shapes = shapes or (self.lead + tuple(tail),)
        if tuple(t.shape) not in shapes:
            raise ValueError("constraint_op: %s has shape %s, expected %s"
                             % (name, tuple(t.shape),
                                " or ".join(map(str, shapes))))
        if not t.is_contiguous():
            raise ValueError("constraint_op: %s must be contiguous" % name)

    def _per_cand(self, name, t, tail) -> int:
        """1 if t has a row per problem, 0 if one per group of C."""
        full = self.lead + tuple(tail)
        shared = self.lead[:-1] + (1,) + tuple(tail)
        self._check(name, t, tail, (full, shared) if self.lead else None)
        return int(tuple(t.shape) == full)

    def _launch(self, mode: int) -> None:
        self.args.mode = mode
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = _library().constraint_op_launch(ctypes.addressof(self.args),
                                              stream)
        if err != 0:
            raise RuntimeError("constraint_op kernel launch failed: "
                               "cudaError %d" % err)
        trace.count("constraint_op.launches")

    def forward(self, x: torch.Tensor) -> ConVec:
        self._check("x", x, (self.n,))
        z = ConVec(*(torch.empty(self.lead + t, dtype=torch.float32,
                                 device=self.device) for t in self.tails))
        a = self.args
        a.x = x.data_ptr()
        for i, t in enumerate(z):
            a.z[i] = t.data_ptr()
        self._launch(FORWARD)
        return z

    def transpose(self, w: ConVec) -> torch.Tensor:
        for i, (t, tail) in enumerate(zip(w, self.tails)):
            self._check("w[%d]" % i, t, tail)
        out = torch.empty(self.lead + (self.n,), dtype=torch.float32,
                          device=self.device)
        a = self.args
        for i, t in enumerate(w):
            a.w[i] = t.data_ptr()
        a.out = out.data_ptr()
        self._launch(TRANSPOSE)
        return out

    def normal(self, rho: ConVec, h_s: torch.Tensor, sigma: float,
               v: torch.Tensor) -> torch.Tensor:
        for i, (t, tail) in enumerate(zip(rho, self.tails)):
            self._check("rho[%d]" % i, t, tail)
        hs_pc = self._per_cand("h_s", h_s, (self.n,))
        self._check("v", v, (self.n,))
        out = torch.empty(self.lead + (self.n,), dtype=torch.float32,
                          device=self.device)
        a = self.args
        for i, t in enumerate(rho):
            a.rho[i] = t.data_ptr()
        a.hs, a.hs_per_cand, a.sigma = h_s.data_ptr(), hs_pc, sigma
        a.x, a.out = v.data_ptr(), out.data_ptr()
        self._launch(NORMAL)
        return out
