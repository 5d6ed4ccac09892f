"""Minimum-snap piecewise-polynomial trajectory solver (port of
intent_mpc_tpu/models/poly_traj.py).

Rebuild of trajPlanner::polyTrajSolver (trajectory_planner/polyTrajSolver.cpp):
degree-7 polynomials per path segment in normalized segment time, snap
(4th-derivative) cost, with position endpoint/midpoint constraints,
velocity/acceleration endpoints, continuity up to `continuity_degree`, and
optional corridor inequality rows sampled along each segment.

The reference runs three sequential per-axis OSQP instances
(setUpProblem :162-223, solveX/Y/Z :870-905); here the three axis QPs of
every scenario in a batch of S are one batched dense-ADMM solve
(ops/dense_admm.py). The basis and the snap cost are numpy constants built
on the host; the constraint rows whose values depend on the segment times
(the dt-ratio scaled continuity rows) are built batched on the device.

Reference quirks handled as in the JAX package:
  * constraint rows are written in normalized segment time tau in [0, 1]
    with dt-ratio scaling on continuity rows (constructA :314-555), but
    the endpoint velocity/acceleration bounds are the raw values
    (constructBound :683-774); reproduced as-is (the defaults are 0).
  * getPos/getVel evaluate at the raw time offset t - t_i, not normalized
    (:1032/:1064). sample() defaults to the consistent normalized
    evaluation; reference_compat=True gives the literal behavior.

The corridor sampling count is static (samples_per_segment) instead of the
duration-dependent ceil(duration * res) (:998).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from intent_mpc_torch.ops.dense_admm import solve_dense_qp

INF = float("inf")


class PolyTrajConfig(NamedTuple):
    poly_degree: int = 7          # polynomial_degree (planner_param.yaml)
    diff_degree: int = 4          # differential_degree (snap cost)
    continuity_degree: int = 3
    samples_per_segment: int = 6  # static corridor sampling
    max_iter: int = 400
    # 'legendre': shifted-Legendre segment basis, the same optimal
    # trajectory, ~5 orders of magnitude better-conditioned constraint rows
    # than the reference's monomial basis (matters for a float32 solve).
    # 'monomial': the reference's raw t^d basis.
    basis: str = "legendre"


def _basis_matrix(cfg: PolyTrajConfig) -> np.ndarray:
    """Column d = monomial coefficients of basis function d on tau in [0,1]."""
    D = cfg.poly_degree + 1
    if cfg.basis == "monomial":
        return np.eye(D)
    from numpy.polynomial import legendre as npleg
    from numpy.polynomial import polynomial as nppoly
    B = np.zeros((D, D))
    for d in range(D):
        leg = np.zeros(d + 1)
        leg[d] = 1.0
        poly = npleg.leg2poly(leg)          # coeffs in x on [-1,1]
        out = np.zeros(D)
        for k, a in enumerate(poly):        # substitute x = 2 tau - 1
            pk = nppoly.polypow([-1.0, 2.0], k)
            out[:len(pk)] += a * pk
        B[:, d] = out
    return B


class PolyTrajectory(NamedTuple):
    coeffs: torch.Tensor     # (S, nseg, degree + 1, 3) in `basis_mat` basis
    times: torch.Tensor      # (S, N) knot times
    prim_res: torch.Tensor   # (S, 3) per-axis solver residuals
    basis_mat: torch.Tensor  # (D, D) column d = monomial coeffs of basis fn d


def _snap_cost_block(cfg: PolyTrajConfig) -> np.ndarray:
    """Per-segment P block (constructP :241-272): integral over tau in [0,1]
    of the diff_degree-th derivative squared."""
    D = cfg.poly_degree + 1
    P = np.zeros((D, D))
    dd = cfg.diff_degree
    for i in range(dd, D):
        for j in range(dd, D):
            f = 1.0
            for d in range(dd):
                f *= (i - d) * (j - d)
            f /= (i + j - 2 * dd + 1)
            P[i, j] = f
    return P


def _deriv_row(D: int, order: int, tau: float) -> np.ndarray:
    row = np.zeros(D)
    for d in range(order, D):
        f = 1.0
        for k in range(order):
            f *= (d - k)
        row[d] = f * (tau ** (d - order) if d > order or tau != 0 else 1.0)
    return row


def avg_time_allocation(waypoints: torch.Tensor,
                        desired_vel: float) -> torch.Tensor:
    """avgTimeAllocation (:125-138): knot times (S, N) of waypoints
    (S, N, 3)."""
    dist = torch.linalg.vector_norm(waypoints[:, 1:] - waypoints[:, :-1],
                                    dim=-1)
    return torch.cat([torch.zeros_like(dist[:, :1]),
                      torch.cumsum(dist / desired_vel, dim=1)], dim=1)


class _Rows(NamedTuple):
    """The constraint structure of one (config, segment count, corridor)
    as numpy constants: rows (m, n) before any dt scaling, and for each
    row the dt factor it takes (scale_seg, scale_pow: the row's left part
    is multiplied by dts[scale_seg + 1] ** scale_pow and its right part by
    dts[scale_seg] ** scale_pow; pow 0 = no scaling)."""
    left: np.ndarray         # (m, n) part on segment i (or the whole row)
    right: np.ndarray        # (m, n) part on segment i + 1
    scale_seg: np.ndarray    # (m,) int
    scale_pow: np.ndarray    # (m,) int


@functools.lru_cache(maxsize=None)
def _structure(cfg: PolyTrajConfig, nseg: int, corridor: bool):
    """The rows of `plan` in its order, the basis and the cost (numpy)."""
    D = cfg.poly_degree + 1
    n = nseg * D
    Bm = _basis_matrix(cfg)

    def brow(order, tau):
        return _deriv_row(D, order, tau) @ Bm

    def seg_row(seg, row):
        out = np.zeros((nseg, D))
        out[seg] = row
        return out.reshape(-1)

    left, right, sseg, spow = [], [], [], []

    def add(lrow, rrow=None, seg=0, pw=0):
        left.append(lrow)
        right.append(np.zeros(n) if rrow is None else rrow)
        sseg.append(seg)
        spow.append(pw)

    r0, r1 = brow(0, 0.0), brow(0, 1.0)
    add(seg_row(0, r0))                           # start position
    add(seg_row(nseg - 1, r1))                    # end position
    for i in range(nseg - 1):                     # midpoints
        add(seg_row(i, r1))
    for i in range(nseg - 1):                     # position continuity
        add(seg_row(i, r1) - seg_row(i + 1, r0))
    for order in (1, 2):                          # vel, acc endpoints + cont.
        b0, b1 = brow(order, 0.0), brow(order, 1.0)
        add(seg_row(0, b0))
        add(seg_row(nseg - 1, b1))
        for i in range(nseg - 1):
            add(seg_row(i, b1), -seg_row(i + 1, b0), i, order)
    for order in range(3, cfg.continuity_degree + 1):
        hl, hr = brow(order, 1.0), brow(order, 0.0)
        for i in range(nseg - 1):
            add(seg_row(i, hl), -seg_row(i + 1, hr), i, order)
    if corridor:
        S = cfg.samples_per_segment
        for i in range(nseg):
            for s in range(S):
                add(seg_row(i, brow(0, (s + 1) / (S + 1))))
    rows = _Rows(np.stack(left), np.stack(right), np.asarray(sseg),
                 np.asarray(spow))
    Pblk = Bm.T @ _snap_cost_block(cfg) @ Bm
    P = np.kron(np.eye(nseg), Pblk)
    return rows, Bm, P


def _dt_pow(dts: torch.Tensor, pw: int) -> torch.Tensor:
    """dts ** pw as the JAX package's integer power rounds it (repeated
    squaring: x, x x, x (x x))."""
    acc, x = None, dts
    while pw > 0:
        if pw & 1:
            acc = x if acc is None else acc * x
        pw >>= 1
        if pw > 0:
            x = x * x
    return acc


class _DeviceRows(NamedTuple):
    """_structure's constants on one device and dtype, copied there once
    (a host array copied in every call would wait for the device)."""
    left: torch.Tensor
    right: torch.Tensor
    scaled: tuple            # (pow, row indices, segment indices) per power
    P: torch.Tensor
    basis: torch.Tensor
    tau: torch.Tensor        # (samples_per_segment, 1) corridor sample times


@functools.lru_cache(maxsize=None)
def _on_device(cfg: PolyTrajConfig, nseg: int, corridor: bool, device,
               dtype) -> _DeviceRows:
    rows, Bm, P = _structure(cfg, nseg, corridor)
    kw = dict(dtype=dtype, device=device)
    scaled = []
    for pw in sorted(set(int(p) for p in rows.scale_pow) - {0}):
        sel = np.nonzero(rows.scale_pow == pw)[0]
        scaled.append((pw, torch.as_tensor(sel, device=device),
                       torch.as_tensor(rows.scale_seg[sel], device=device)))
    K = cfg.samples_per_segment
    return _DeviceRows(
        left=torch.as_tensor(rows.left, **kw),
        right=torch.as_tensor(rows.right, **kw), scaled=tuple(scaled),
        P=torch.as_tensor(P, **kw), basis=torch.as_tensor(Bm, **kw),
        tau=torch.tensor([(s + 1) / (K + 1) for s in range(K)],
                         **kw)[:, None])


def _constraint_matrix(rows: _DeviceRows, dts: torch.Tensor) -> torch.Tensor:
    """A (S, m, n) for segment times dts (S, nseg)."""
    S = dts.shape[0]
    m = rows.left.shape[0]
    ls = torch.ones((S, m), dtype=dts.dtype, device=dts.device)
    rs = torch.ones_like(ls)
    for pw, sel, seg in rows.scaled:
        dp = _dt_pow(dts, pw)
        ls[:, sel] = dp[:, seg + 1]
        rs[:, sel] = dp[:, seg]
    return rows.left * ls[..., None] + rows.right * rs[..., None]


def plan(waypoints: torch.Tensor, desired_vel: float,
         cfg: PolyTrajConfig = PolyTrajConfig(),
         corridor_r: Optional[torch.Tensor] = None) -> PolyTrajectory:
    """Solve the min-snap trajectories through waypoints (S, N, 3) with
    zero start and end velocity and acceleration, in the waypoints' dtype.

    corridor_r: optional (S, nseg) corridor half-widths; when given,
    midpoints relax to +-r boxes and sampled corridor rows are added
    (soft-constraint + corridor modes, :629-660 / :815-840). r = 0 disables
    a segment's corridor rows (:990)."""
    S, N, _ = waypoints.shape
    nseg = N - 1
    D = cfg.poly_degree + 1
    dev = waypoints.device
    kw = dict(dtype=waypoints.dtype, device=dev)
    times = avg_time_allocation(waypoints, desired_vel)
    dts = times[:, 1:] - times[:, :-1]
    rows = _on_device(cfg, nseg, corridor_r is not None, dev, waypoints.dtype)
    A = _constraint_matrix(rows, dts)
    zero = torch.zeros((S, 1, 3), **kw)
    w = waypoints
    lbs = [w[:, :1], w[:, -1:]]
    ubs = [w[:, :1], w[:, -1:]]
    mid = w[:, 1:-1]
    if corridor_r is None:
        lbs.append(mid)
        ubs.append(mid)
    else:
        r = corridor_r[:, :nseg - 1, None]
        lbs.append(mid - r)
        ubs.append(mid + r)
    n_zero = (nseg - 1) + 2 * (2 + (nseg - 1)) \
        + (cfg.continuity_degree - 2) * (nseg - 1)
    zeros = zero.expand(S, n_zero, 3)
    # position continuity, then per order the endpoint pair (0 = rest)
    # and the continuity rows: all zero bounds
    lbs.append(zeros)
    ubs.append(zeros)
    if corridor_r is not None:
        pm = w[:, :-1, None] + (w[:, 1:] - w[:, :-1])[:, :, None] * rows.tau
        rr = corridor_r[:, :, None, None]
        active = rr > 0
        lbs.append(torch.where(active, pm - rr, torch.full_like(pm, -INF)
                               ).reshape(S, -1, 3))
        ubs.append(torch.where(active, pm + rr, torch.full_like(pm, INF)
                               ).reshape(S, -1, 3))
    L = torch.cat(lbs, dim=1)                                 # (S, m, 3)
    U = torch.cat(ubs, dim=1)

    Pt = rows.P
    n = Pt.shape[0]
    B = S * 3
    res = solve_dense_qp(Pt.expand(B, n, n), torch.zeros((B, n), **kw),
                         A[:, None].expand(S, 3, *A.shape[1:]).reshape(
                             B, *A.shape[1:]),
                         L.transpose(1, 2).reshape(B, -1),
                         U.transpose(1, 2).reshape(B, -1),
                         max_iter=cfg.max_iter)
    coeffs = res.x.reshape(S, 3, nseg, D).permute(0, 2, 3, 1)
    return PolyTrajectory(coeffs=coeffs, times=times,
                          prim_res=res.prim_res.reshape(S, 3),
                          basis_mat=rows.basis)


def sample(traj: PolyTrajectory, t: torch.Tensor, order: int = 0,
           reference_compat: bool = False) -> torch.Tensor:
    """Position (order 0), velocity (1) or acceleration (2) (S, T, 3) at
    times t (S, T).

    Default: normalized-time evaluation with the dt chain rule. With
    reference_compat=True, evaluates at the raw offset t - t_i like
    getPos/getVel/getAcc (:1058-1122)."""
    times = traj.times
    S, nseg, D, _ = traj.coeffs.shape
    i = torch.clamp(torch.searchsorted(times, t.contiguous(), right=True) - 1,
                    0, nseg - 1)
    ti = torch.gather(times, 1, i)
    dt = torch.gather(times, 1, i + 1) - ti
    if reference_compat:
        tau = t - ti
        scale = torch.ones_like(t)
    else:
        tau = torch.clamp((t - ti) / torch.clamp(dt, min=1e-9), 0.0, 1.0)
        scale = 1.0 / torch.clamp(dt, min=1e-9) ** order
    d = torch.arange(D, device=t.device)
    fac = torch.ones(D, dtype=t.dtype, device=t.device)
    for k in range(order):
        fac = fac * torch.clamp(d - k, min=0)
    ex = torch.clamp(d - order, min=0).to(t.dtype)
    tp = torch.where(d - order >= 0, tau[..., None] ** ex,
                     torch.zeros_like(ex))
    basis = (fac * tp) @ traj.basis_mat                       # (S, T, D)
    c = torch.gather(traj.coeffs, 1,
                     i[..., None, None].expand(S, i.shape[1], D, 3))
    return torch.einsum("stdc,std->stc", c, basis) * scale[..., None]
