"""Fleet-fused ADMM solve: every iteration of every candidate QP of a
cycle in one kernel launch (port of intent_mpc_tpu/ops/pallas_fused.py).

Same algorithm as the TPU kernel `_fleet_kernel`:

 * a shared UNSCALED extended operator A_ext (n_ext, n_pad) holds the
   eq/sb/cb rows plus per-step copy rows of the positions and slack
   controls, so the scaled products are a_s(x) = E * (A_ext (D * x)) and
   at_s(w) = D * (A_ext^T (E * w)), with the Ruiz scales applied
   elementwise;
 * the obstacle rows, the only rows that differ per candidate, are
   (W, K) broadcast math on those copy rows, with a lower bound only;
 * the x-update applies the scenario's shared explicit inverse Minv
   (the factor of the candidate-mean QP) and then `refine` stationary
   steps x += Minv (rhs - M x) against the candidate's own normal
   operator M;
 * z and y updates are over-relaxed; the solve returns the scaled x,
   y_lin and y_obs.

Layout. The TPU kernel put problems on lanes: arrays (rows, P) with
P = 8 S. On the card one thread block owns one scenario and its threads
walk the rows of one candidate at a time, so the port keeps each
scenario's data contiguous and each candidate's rows contiguous:
(S, 8, rows) and (S, 8, W, K). Axis 1 is the TPU layout's 8-slot
candidate group (6 live candidates, 2 inert slots with the same fill
values), so `utils/convert.fleet_problem_from_lanes` maps one layout
onto the other element for element. The TPU tiling (scenarios per grid
cell, the VMEM window and the manual DMA of the inverse stack) has no
counterpart here. The kernel reads the eight read-only obstacle arrays
as one record tensor (`pack_obstacle_records`, (S, 6, W, K, 8)), which
the wrapper builds from the FleetProblem fields once per solve.

`fleet_solve` launches the hand-written CUDA kernel csrc/fleet_admm.cu
once per solve when the problem lies on a CUDA device, and runs
`fleet_solve_reference`, the plain PyTorch version with the TPU body's
operation order, when it lies on the CPU. There is no fallback: a CUDA
problem either launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from intent_mpc_torch.ops import qp as qplib
from intent_mpc_torch.ops.admm import (ADMMResult, Factor, admm_factor,
                                       candidate_mean, primal_residual)
from intent_mpc_torch.ops.qp import NU, NX, ConVec, QPData
from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig

# kernel launches since the last reset (only the CUDA path counts)
FLEET_LAUNCHES = 0

# the kernel's phase kinds, in the order of its optional cycle count
# (enum Phase in csrc/fleet_admm.cu; benchmark/fleet_phases.py reads it)
PHASES = ("minv_apply", "csr_a", "csr_at", "linear_rows", "obstacle_rows",
          "vector_updates")

LANES = 8       # candidate slots per scenario in the layout
LIVE = 6        # live candidates per scenario (slots 6, 7 are inert)
BIG = 1e30      # finite stand-in for an infinite bound


# ---------------------------------------------------------------------------
# Static extended operator: A_ext (n_ext, n_pad)
# rows: [eq (8H) | sb (8H) | cb (5W) | pad | px (Wp) | py | pz | u3 | u4]
# ---------------------------------------------------------------------------

class FleetDims(NamedTuple):
    H: int
    W: int
    K: int          # padded obstacle slots (multiple of 8; inert pads)
    n: int          # real variable count
    n_pad: int      # 512-ish
    m_lin: int      # 8H + 8H + 5W real linear rows
    lin_pad: int    # padded linear block
    Wp: int         # W padded to a multiple of 8 (32)
    n_ext: int      # lin_pad + 5 * Wp
    P: int          # problems in the layout = 8 * S


def fleet_dims(cfg: PlannerConfig, K: int, S: int) -> FleetDims:
    H, W = cfg.horizon, cfg.mpc_window
    K = ((K + 7) // 8) * 8
    n = cfg.num_vars
    n_pad = max(512, ((n + 127) // 128) * 128)
    m_lin = 2 * NX * H + NU * W
    lin_pad = ((m_lin + 7) // 8) * 8
    Wp = ((W + 7) // 8) * 8
    n_ext = lin_pad + 5 * Wp
    return FleetDims(H=H, W=W, K=K, n=n, n_pad=n_pad, m_lin=m_lin,
                     lin_pad=lin_pad, Wp=Wp, n_ext=n_ext, P=LANES * S)


@functools.lru_cache(maxsize=8)
def a_ext(cfg: PlannerConfig, K: int) -> np.ndarray:
    """The shared unscaled extended constraint operator (n_ext, n_pad),
    float32, built entry by entry as the TPU version builds it."""
    d = fleet_dims(cfg, K, 1)
    H, W = d.H, d.W
    ts = cfg.ts
    A = np.zeros((d.n_ext, d.n_pad), np.float32)

    def xcol(i, j):
        return NX * i + j

    def ucol(i, j):
        return NX * H + NU * i + j

    # eq rows: row 0 block = -x_0; row block i>=1: A x_{i-1} + B u_{i-1} - x_i
    for j in range(NX):
        A[j, xcol(0, j)] = -1.0
    for i in range(1, H):
        r = NX * i
        for j in range(NX):
            A[r + j, xcol(i, j)] = -1.0
        for j in range(3):
            A[r + j, xcol(i - 1, j)] += 1.0
            A[r + j, xcol(i - 1, j + 3)] += ts
            A[r + j, ucol(i - 1, j)] += 0.5 * ts * ts
            A[r + 3 + j, xcol(i - 1, j + 3)] += 1.0
            A[r + 3 + j, ucol(i - 1, j)] += ts
        A[r + 6, ucol(i - 1, 3)] += 1.0
        A[r + 7, ucol(i - 1, 4)] += 1.0
    # sb rows: identity on x
    for i in range(H):
        for j in range(NX):
            A[NX * H + NX * i + j, xcol(i, j)] = 1.0
    # cb rows: identity on u
    for i in range(W):
        for j in range(NU):
            A[2 * NX * H + NU * i + j, ucol(i, j)] = 1.0
    # copy rows: p-hat components and slack controls per step
    base = d.lin_pad
    for i in range(W):
        A[base + i, xcol(i, 0)] = 1.0                 # px
        A[base + d.Wp + i, xcol(i, 1)] = 1.0          # py
        A[base + 2 * d.Wp + i, xcol(i, 2)] = 1.0      # pz
        A[base + 3 * d.Wp + i, ucol(i, 3)] = 1.0      # u3
        A[base + 4 * d.Wp + i, ucol(i, 4)] = 1.0      # u4
    return A


def csr(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row_ptr int32, col int32, val float32) of a dense matrix, columns
    ascending within a row: the kernel's form of A_ext and A_ext^T."""
    rows, cols = np.nonzero(a)
    ptr = np.zeros(a.shape[0] + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=a.shape[0]), out=ptr[1:])
    return ptr, cols.astype(np.int32), a[rows, cols].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _a_ext_on(cfg: PlannerConfig, K: int, device: torch.device):
    """A_ext on a device, and its CSR arrays and those of its transpose."""
    a = a_ext(cfg, K)
    dense = torch.as_tensor(a, device=device)
    sparse = [torch.as_tensor(t, device=device)
              for t in csr(a) + csr(np.ascontiguousarray(a.T))]
    return dense, sparse


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

class FleetProblem(NamedTuple):
    """Packed solver inputs of S scenarios: (S, 8, rows) per vector and
    (S, 8, W, K) per obstacle array; axis 1 is the candidate slot."""
    a_ext: torch.Tensor     # (n_ext, n_pad) shared, unscaled
    minv: torch.Tensor      # (S, n_pad, n_pad) scenario factor inverses
    d_scale: torch.Tensor   # (S, 8, n_pad) Ruiz column scale (shared per group)
    e_lin: torch.Tensor     # (S, 8, lin_pad) row scale of the linear rows
    q: torch.Tensor         # (S, 8, n_pad) scaled linear cost
    hsig: torch.Tensor      # (S, 8, n_pad) scaled cost diagonal + sigma
    x0: torch.Tensor        # (S, 8, n_pad) scaled warm start
    rho_lin: torch.Tensor   # (S, 8, lin_pad)
    ir_lin: torch.Tensor    # (S, 8, lin_pad) 1/rho
    lo_lin: torch.Tensor    # (S, 8, lin_pad)
    hi_lin: torch.Tensor    # (S, 8, lin_pad)
    gx: torch.Tensor        # (S, 8, W, K) E_obs-scaled obstacle gradients
    gy: torch.Tensor
    gz: torch.Tensor
    s3: torch.Tensor        # (S, 8, W, K) -E_obs * dyn * slack (signed)
    s4: torch.Tensor        # (S, 8, W, K) -E_obs * (1-dyn) * slack
    rho_obs: torch.Tensor
    ir_obs: torch.Tensor
    lo_obs: torch.Tensor


def pack_fleet(cfg: PlannerConfig, qps: QPData, minv: torch.Tensor,
               D: torch.Tensor, E: ConVec, c: torch.Tensor,
               warm: torch.Tensor,
               scfg: Optional[SolverConfig] = None) -> FleetProblem:
    """Pack (S, 6, ...) candidate QPs and per-scenario factors. D (S, n),
    E a ConVec with (S, ...) leaves, c (S,), minv (S, n, n), warm
    (S, 6, n)."""
    scfg = scfg or cfg.solver
    S = minv.shape[0]
    K = qps.G.shape[-2]
    d = fleet_dims(cfg, K, S)
    n = d.n
    dev, dt = qps.q.device, qps.q.dtype

    def lanes(a, fill=0.0):
        """(S, 6, rows...) -> (S, 8, rows...): two inert slots of `fill`."""
        pad = torch.full((S, LANES - LIVE) + a.shape[2:], fill, dtype=dt,
                         device=dev)
        return torch.cat([a, pad], dim=1)

    def lanes_shared(a):
        """(S, rows...) -> (S, 8, rows...) replicated over the group."""
        return a[:, None].expand((S, LANES) + a.shape[1:]).contiguous()

    def padrows(a, rows):
        return torch.cat([a, torch.zeros(a.shape[:-1] + (rows - a.shape[-1],),
                                         dtype=dt, device=dev)], dim=-1)

    hdiag = qplib.hessian_diag(cfg, dev)
    h_s = c[:, None] * D * D * hdiag[None, :]            # (S, n)
    q_s = c[:, None, None] * D[:, None, :] * qps.q        # (S, 6, n)
    rho = qplib.rho_vec(cfg, qps, scfg.rho, scfg.rho_eq_scale)

    def lin_flat(v: ConVec):
        return torch.cat([v.eq.flatten(-2), v.sb.flatten(-2),
                          v.cb.flatten(-2)], dim=-1)

    l_s = qps.l.map(lambda lv, ev: lv * ev[:, None], E)
    u_s = qps.u.map(lambda uv, ev: uv * ev[:, None], E)
    pad_rows = (torch.arange(d.lin_pad, device=dev) >= d.m_lin).to(dt)
    lo_lin = padrows(torch.nan_to_num(lin_flat(l_s), neginf=-BIG), d.lin_pad)
    hi_lin = padrows(torch.nan_to_num(lin_flat(u_s), posinf=BIG), d.lin_pad)
    hi_lin = hi_lin + pad_rows * BIG
    lo_lin = lo_lin - pad_rows * BIG
    rho_lin = padrows(lin_flat(rho), d.lin_pad) + pad_rows * 1e-6
    e_lin = padrows(lin_flat(E), d.lin_pad)

    # obstacle blocks (already include the row scale E_obs; the copy rows
    # carry D * x, so they need no column scale)
    Eo = E.obs[:, None]                                   # (S, 1, W, K)

    def padK(a, fill=0.0):
        return torch.cat([a, torch.full(a.shape[:-1] + (d.K - a.shape[-1],),
                                        fill, dtype=dt, device=dev)], dim=-1)

    gx = padK(qps.G[..., 0] * Eo)
    gy = padK(qps.G[..., 1] * Eo)
    gz = padK(qps.G[..., 2] * Eo)
    s3 = padK(-(qps.obs_dyn * qps.obs_slack) * Eo)
    s4 = padK(-((1.0 - qps.obs_dyn) * qps.obs_active * qps.obs_slack) * Eo)
    rho_obs = padK(rho.obs, fill=1e-6)
    lo_obs = padK(torch.nan_to_num(qps.l.obs * Eo, neginf=-BIG), fill=-BIG)

    def pad_vars(a):   # (..., n) -> (..., n_pad)
        return padrows(a, d.n_pad)

    # the inverse ships as full float32: on the infeasible DYNUS QPs the
    # obstacle duals ramp to ~1e4-1e5 while x stays ~1e1, and every
    # cheaper precision diverged on the TPU (pallas_fused.py:264-272). A
    # bf16 factor (SolverConfig.minv_dtype) is widened exactly here, as
    # JAX's pack_fleet sets it into its float32 array: the kernel reads
    # float32 only
    minv_pad = torch.zeros((S, d.n_pad, d.n_pad), dtype=dt, device=dev)
    minv_pad[:, :n, :n] = minv.to(dt)

    return FleetProblem(
        a_ext=_a_ext_on(cfg, K, torch.device(dev))[0], minv=minv_pad,
        d_scale=lanes_shared(pad_vars(D)),
        e_lin=lanes_shared(e_lin),
        q=lanes(pad_vars(q_s)),
        hsig=lanes_shared(pad_vars(h_s)) + scfg.sigma,
        x0=lanes(pad_vars(warm / D[:, None, :])),
        rho_lin=lanes(rho_lin, fill=1e-6),
        ir_lin=lanes(1.0 / rho_lin, fill=1e6),
        lo_lin=lanes(lo_lin, fill=-BIG),
        hi_lin=lanes(hi_lin, fill=BIG),
        gx=lanes(gx), gy=lanes(gy), gz=lanes(gz), s3=lanes(s3), s4=lanes(s4),
        rho_obs=lanes(rho_obs, fill=1e-6),
        ir_obs=lanes(1.0 / rho_obs, fill=1e6),
        lo_obs=lanes(lo_obs, fill=-BIG),
    )


# the read-only obstacle arrays in the order of a packed record
OBS_FIELDS = ("gx", "gy", "gz", "s3", "s4", "rho_obs", "ir_obs", "lo_obs")


def pack_obstacle_records(fp: FleetProblem) -> torch.Tensor:
    """The kernel's form of the obstacle arrays: the live slots' eight
    per-slot values side by side, (S, 6, W, K, 8) float32, so that the
    kernel reads a slot with two 16-byte loads."""
    return torch.stack([getattr(fp, f)[:, :LIVE] for f in OBS_FIELDS],
                       dim=-1).contiguous()


# ---------------------------------------------------------------------------
# The solve: plain version and kernel
# ---------------------------------------------------------------------------

def fleet_solve_reference(cfg: PlannerConfig, fp: FleetProblem, iters: int,
                          refine: int):
    """Plain PyTorch version of the kernel body (pallas_fused.py:300-413)
    in its operation order, batched over scenarios: the CPU path and the
    kernel's check. Returns the scaled (x, y_lin, y_obs) in the layout."""
    scfg = cfg.solver
    sigma, alpha = scfg.sigma, scfg.alpha
    S, W, K = fp.gx.shape[0], fp.gx.shape[2], fp.gx.shape[3]
    d = fleet_dims(cfg, K, S)
    lp, Wp = d.lin_pad, d.Wp
    A = fp.a_ext
    padW = torch.zeros((S, LANES, Wp - W), dtype=A.dtype, device=A.device)

    def a_s(x):
        """Scaled constraint product: linear rows (S, 8, lp), obstacle
        rows (S, 8, W, K)."""
        ext = torch.matmul(fp.d_scale * x, A.t())         # (S, 8, n_ext)
        zl = fp.e_lin * ext[..., :lp]

        def copy(j):
            return ext[..., lp + j * Wp:lp + j * Wp + W, None]
        zo = (fp.gx * copy(0) + fp.gy * copy(1) + fp.gz * copy(2)
              + fp.s3 * copy(3) + fp.s4 * copy(4))
        return zl, zo

    def at_s(wl, wo):
        """Transpose: back to x space (S, 8, n_pad)."""
        parts = [fp.e_lin * wl]
        for g in (fp.gx, fp.gy, fp.gz, fp.s3, fp.s4):
            parts += [torch.sum(wo * g, dim=-1), padW]
        w_ext = torch.cat(parts, dim=-1)                   # (S, 8, n_ext)
        return fp.d_scale * torch.matmul(w_ext, A)

    def m_apply(x):
        # hsig already carries the sigma shift (pack_fleet)
        zl, zo = a_s(x)
        return fp.hsig * x + at_s(fp.rho_lin * zl, fp.rho_obs * zo)

    def inv_dot(r):
        return torch.matmul(r, fp.minv.transpose(-1, -2))

    def msolve(rhs):
        x = inv_dot(rhs)
        for _ in range(refine):
            x = x + inv_dot(rhs - m_apply(x))
        return x

    x = fp.x0
    zl, zo = a_s(x)
    yl, yo = torch.zeros_like(zl), torch.zeros_like(zo)
    for _ in range(iters):
        rhs = sigma * x - fp.q + at_s(fp.rho_lin * zl - yl,
                                      fp.rho_obs * zo - yo)
        xt = msolve(rhs)
        ztl, zto = a_s(xt)
        x_n = alpha * xt + (1.0 - alpha) * x
        zrl = alpha * ztl + (1.0 - alpha) * zl
        zro = alpha * zto + (1.0 - alpha) * zo
        zl_n = torch.clamp(zrl + yl * fp.ir_lin, fp.lo_lin, fp.hi_lin)
        zo_n = torch.maximum(zro + yo * fp.ir_obs, fp.lo_obs)
        yl = yl + fp.rho_lin * (zrl - zl_n)
        yo = yo + fp.rho_obs * (zro - zo_n)
        x, zl, zo = x_n, zl_n, zo_n
    return x, yl, yo


_PTR = ctypes.c_void_p


class _FleetArgs(ctypes.Structure):
    """Mirror of `FleetArgs` in csrc/fleet_admm.cu (same field order)."""
    _fields_ = (
        [(k, _PTR) for k in ("a_ptr", "a_col", "a_val", "at_ptr", "at_col",
                             "at_val", "minv", "d", "q", "hs", "x0", "el",
                             "rl", "irl", "lol", "hil", "rec", "x_out",
                             "yl_out", "yo_out", "zo", "clk")]
        + [(k, ctypes.c_int) for k in ("S", "n", "n_pad", "lin_pad", "W",
                                       "Wp", "K", "n_ext", "iters",
                                       "refine", "nnz")]
        + [(k, ctypes.c_float) for k in ("sigma", "alpha", "beta")])


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from intent_mpc_torch.ops import build
        lib = build.load("fleet_admm")
        lib.fleet_admm_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fleet_admm_launch.restype = ctypes.c_int
        lib.fleet_admm_args_size.argtypes = []
        lib.fleet_admm_args_size.restype = ctypes.c_int
        lib.fleet_admm_phases.argtypes = []
        lib.fleet_admm_phases.restype = ctypes.c_int
        if lib.fleet_admm_args_size() != ctypes.sizeof(_FleetArgs):
            raise RuntimeError("fleet_admm argument struct size mismatch: "
                               "%d (CUDA) vs %d (ctypes)"
                               % (lib.fleet_admm_args_size(),
                                  ctypes.sizeof(_FleetArgs)))
        if lib.fleet_admm_phases() != len(PHASES):
            raise RuntimeError("fleet_admm counts %d phase kinds, the "
                               "wrapper names %d" % (lib.fleet_admm_phases(),
                                                     len(PHASES)))
        _LIB = lib
    return _LIB


def _check(cfg: PlannerConfig, fp: FleetProblem) -> FleetDims:
    S, K = fp.minv.shape[0], fp.gx.shape[-1]
    d = fleet_dims(cfg, K, S)
    want = {"a_ext": (d.n_ext, d.n_pad), "minv": (S, d.n_pad, d.n_pad)}
    for f in ("d_scale", "q", "hsig", "x0"):
        want[f] = (S, LANES, d.n_pad)
    for f in ("e_lin", "rho_lin", "ir_lin", "lo_lin", "hi_lin"):
        want[f] = (S, LANES, d.lin_pad)
    for f in ("gx", "gy", "gz", "s3", "s4", "rho_obs", "ir_obs", "lo_obs"):
        want[f] = (S, LANES, d.W, d.K)
    dev = fp.minv.device
    for f, shape in want.items():
        t = getattr(fp, f)
        if tuple(t.shape) != shape:
            raise ValueError("FleetProblem.%s has shape %s, expected %s"
                             % (f, tuple(t.shape), shape))
        if t.dtype != torch.float32:
            raise TypeError("FleetProblem.%s must be float32, got %s"
                            % (f, t.dtype))
        if t.device != dev:
            raise ValueError("FleetProblem leaves must share one device")
        if not t.is_contiguous():
            raise ValueError("FleetProblem.%s must be contiguous" % f)
    return d


def fleet_solve(cfg: PlannerConfig, fp: FleetProblem, iters: int,
                refine: int):
    """Run the whole solve; returns the scaled (x (S, 8, n_pad), y_lin
    (S, 8, lin_pad), y_obs (S, 8, W, K)). On the card the inert slots 6
    and 7 are not iterated and come back as zeros."""
    d = _check(cfg, fp)
    dev = fp.minv.device
    if dev.type == "cpu":
        return fleet_solve_reference(cfg, fp, iters, refine)
    if dev.type != "cuda":
        raise ValueError("fleet_solve runs on CPU or CUDA tensors, got %s"
                         % dev)
    return _launch(cfg, fp, d, iters, refine)


def _args(cfg: PlannerConfig, fp: FleetProblem, d: FleetDims, iters: int,
          refine: int) -> _FleetArgs:
    """The kernel's arguments for the problem's inputs and sizes (the
    outputs, scratch and records are set by the caller)."""
    a = _FleetArgs()
    sparse = _a_ext_on(cfg, d.K, fp.minv.device)[1]
    for k, t in zip(("a_ptr", "a_col", "a_val", "at_ptr", "at_col", "at_val"),
                    sparse):
        setattr(a, k, t.data_ptr())
    for k, t in (("minv", fp.minv), ("d", fp.d_scale), ("q", fp.q),
                 ("hs", fp.hsig), ("x0", fp.x0), ("el", fp.e_lin),
                 ("rl", fp.rho_lin), ("irl", fp.ir_lin), ("lol", fp.lo_lin),
                 ("hil", fp.hi_lin)):
        setattr(a, k, t.data_ptr())
    a.S, a.n, a.n_pad, a.lin_pad = fp.minv.shape[0], d.n, d.n_pad, d.lin_pad
    a.W, a.Wp, a.K, a.n_ext = d.W, d.Wp, d.K, d.n_ext
    a.iters, a.refine, a.nnz = iters, refine, sparse[1].numel()
    a.sigma, a.alpha = cfg.solver.sigma, cfg.solver.alpha
    a.beta = 1.0 - cfg.solver.alpha   # rounded to float once, as torch does
    return a


def _launch(cfg: PlannerConfig, fp: FleetProblem, d: FleetDims, iters: int,
            refine: int, clk: Optional[torch.Tensor] = None):
    """One launch of the kernel on a checked CUDA problem. `clk`, an int64
    (S, len(PHASES)) tensor, receives each block's cycles per phase kind
    (benchmark/fleet_phases.py); every other caller passes None."""
    global FLEET_LAUNCHES
    dev = fp.minv.device
    S = fp.minv.shape[0]
    kw = dict(dtype=torch.float32, device=dev)
    x = torch.empty((S, LANES, d.n_pad), **kw)
    yl = torch.empty((S, LANES, d.lin_pad), **kw)
    yo = torch.empty((S, LANES, d.W, d.K), **kw)
    zo = torch.empty((S, LIVE, d.W, d.K), **kw)       # z_obs iterate
    rec = pack_obstacle_records(fp)
    a = _args(cfg, fp, d, iters, refine)
    for k, t in (("rec", rec), ("x_out", x), ("yl_out", yl), ("yo_out", yo),
                 ("zo", zo)):
        setattr(a, k, t.data_ptr())
    if clk is not None:
        if (clk.dtype != torch.int64 or clk.device != dev
                or tuple(clk.shape) != (S, len(PHASES))
                or not clk.is_contiguous()):
            raise ValueError("clk must be a contiguous int64 (S, %d) tensor "
                             "on the problem's device" % len(PHASES))
        a.clk = clk.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().fleet_admm_launch(ctypes.addressof(a), stream)
    if err != 0:
        raise RuntimeError("fleet_admm kernel launch failed: cudaError %d"
                           % err)
    FLEET_LAUNCHES += 1
    return x, yl, yo


def unpack_x(cfg: PlannerConfig, x: torch.Tensor,
             D: torch.Tensor) -> torch.Tensor:
    """(S, 8, n_pad) scaled -> (S, 6, n) unscaled."""
    return x[:, :LIVE, :cfg.num_vars] * D[:, None, :]


# ---------------------------------------------------------------------------
# Entry: solve a whole fleet's candidate QPs in one kernel launch
# ---------------------------------------------------------------------------

def fleet_setup(cfg: PlannerConfig, qps: QPData, warm: torch.Tensor,
                scfg: Optional[SolverConfig] = None, rho_override=None):
    """Factor each scenario's candidate-mean QP (union obstacle activity)
    and pack the fleet. Returns (FleetProblem, Factor)."""
    scfg = scfg or cfg.solver
    S = qps.q.shape[0]
    if rho_override is None:
        rho_override = torch.full((S,), scfg.rho, dtype=qps.q.dtype,
                                  device=qps.q.device)
    fac = admm_factor(cfg, candidate_mean(qps), scfg=scfg,
                      rho_override=rho_override)
    fp = pack_fleet(cfg, qps, fac.Minv, fac.D, fac.E, fac.c, warm, scfg)
    return fp, fac


def fleet_result(cfg: PlannerConfig, qps: QPData, fac: Factor, x_l, yl_l,
                 yo_l, scfg: Optional[SolverConfig] = None,
                 feas_tol: float = 5e-2) -> ADMMResult:
    """Unscaled (S, 6) results from the solve's outputs: x, the duals as
    a ConVec, and the primal residuals."""
    scfg = scfg or cfg.solver
    H, W = cfg.horizon, cfg.mpc_window
    S, K = qps.q.shape[0], qps.G.shape[-2]
    m_lin = 2 * NX * H + NU * W
    x = unpack_x(cfg, x_l, fac.D)                         # (S, 6, n)

    # duals back to ConVec, unscaled (y = ys * E / c)
    y_lin = yl_l[:, :LIVE, :m_lin]
    s0, s1 = NX * H, 2 * NX * H
    cinv = 1.0 / fac.c[:, None, None, None]
    y = ConVec(eq=y_lin[..., :s0].reshape(S, LIVE, H, NX)
               * fac.E.eq[:, None] * cinv,
               sb=y_lin[..., s0:s1].reshape(S, LIVE, H, NX)
               * fac.E.sb[:, None] * cinv,
               cb=y_lin[..., s1:].reshape(S, LIVE, W, NU)
               * fac.E.cb[:, None] * cinv,
               obs=yo_l[:, :LIVE, :, :K] * fac.E.obs[:, None] * cinv)

    prim, _ = primal_residual(cfg, qps, x)
    return ADMMResult(
        x=x, y=y, prim_res=prim,
        dual_res=torch.full_like(prim, float("nan")),
        solved=prim < feas_tol,
        rho_suggest=torch.full_like(prim, scfg.rho))


def fleet_admm(cfg: PlannerConfig, qps: QPData, warm: torch.Tensor,
               max_iter: Optional[int] = None,
               scfg: Optional[SolverConfig] = None,
               rho_override=None, feas_tol: float = 5e-2) -> ADMMResult:
    """Solve (S, 6) candidate QPs with one shared factor per scenario in
    one kernel launch (pallas_fused.fleet_admm): factor the union-activity
    candidate-mean QP of each scenario, run every iteration of every
    candidate, and refine each x-update against the candidate's own
    normal operator `shared_refine_iters` times by the STATIONARY
    recurrence x += Minv r (the TPU kernel's; the default admm_solve path
    uses CG-2 instead). The factor is built with `rho_override` while
    the packed rows use `scfg.rho`, as in the TPU version; the two agree
    while the carried rho stays at scfg.rho (temporal_rho off).

    Returns an ADMMResult with leaves batched (S, 6, ...); dual_res is
    NaN (not computed), rho_suggest is scfg.rho."""
    scfg = scfg or cfg.solver
    iters = max_iter if max_iter is not None else scfg.max_iter
    fp, fac = fleet_setup(cfg, qps, warm, scfg, rho_override)
    x_l, yl_l, yo_l = fleet_solve(cfg, fp, iters, scfg.shared_refine_iters)
    return fleet_result(cfg, qps, fac, x_l, yl_l, yo_l, scfg, feas_tol)
