"""Batched OSQP-style ADMM solver (port of intent_mpc_tpu/ops/admm.py,
the default closed-loop path). The fleet-fused path
(`SolverConfig.fused_solve`) solves with ops/fleet.py instead and shares
only `admm_factor` with this module.

Same algorithm as OSQP: Ruiz equilibration, per-row penalty rho (1e3x on
equality rows, 1e-6 on loose rows), over-relaxed ADMM:

  x~ = M^{-1} (sigma x - q + A^T (rho z - y))
  x+ = alpha x~ + (1-alpha) x
  z+ = clip(alpha A x~ + (1-alpha) z + y/rho, l, u)
  y+ = y + rho (alpha A x~ + (1-alpha) z - z+)

A never materializes (ops/qp.py closed forms), and the iteration applies
it scaled, its transpose and the normal product through
ops/constraint_op.py: one launch of csrc/constraint_op.cu per product on
a CUDA device, the plain closed forms on the CPU. The x-update normal matrix
has an explicit inverse from the block-tridiagonal Cholesky
(ops/block_chol.py), or with `structured_factor=False` from the dense
Cholesky of the assembled matrix. With a shared Factor (one per scenario), each
candidate refines against its own normal matrix with preconditioned
CG-2, warm-started from the previous iteration's x-tilde, or with
`shared_refine_mode="stationary"` by the recurrence x += Minv (rhs - M x).
The normal operator of that refinement is the closed-form a_s/at_s round
trip, or with `block_refine` the candidate's block-tridiagonal blocks
(block_chol.block_apply), or with `folded_refine` the operator with the
scalings folded into the constraint data (`make_folded_m_op`). With
`woodbury_candidates` and the two slots in which the candidates differ
(`diff_slots`), the x-update is exact instead: a Woodbury correction of
the shared inverse of the base QP without those rows. `minv_dtype="bf16"`
stores the shared inverse in bfloat16; every product reads it as float32.

Iterations are a fixed-count Python loop, or with `truncation="osqp"`
blocks that stop each problem at OSQP 0.6.2's termination test; without a
factor, `adaptive_rho` runs OSQP's in-solve rho rule with
refactorization (`_solve_adaptive`); with a factor, `flat_iter` runs the
loop in flat constraint space (`_solve_flat`); with
`shared_refine_warm_frac` the first iterations refine
`shared_refine_warm` times and the rest `shared_refine_iters` times. The
elementwise tail of each iteration is one launch of the CUDA kernel
ops/ew_chain.py when `ew_kernel` is on, on every one of these loops but
the flat one, the Woodbury x-update and the two-phase refinement (JAX's
dispatch order: its flat branch comes before the kernel's, and its kernel
branch takes neither a custom x-update nor two phases).

Batching: the QP carries leading axes (..., C). A Factor either has the
same leading axes (one factor per problem) or one axis fewer (one factor
per group of C candidates, shared by them, as the planner uses it).

`admm_solve_dense` is a separate entry (port of `admm_solve_pallas`): it
materializes each candidate's scaled dense A, M and Minv and runs every
iteration in one launch of csrc/dense_loop.cu (ops/dense_loop.py). No
closed-loop path calls it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from intent_mpc_torch.ops import block_chol as bc
from intent_mpc_torch.ops import qp as qplib
from intent_mpc_torch.ops.constraint_op import (ConstraintOp,
                                                ConstraintOpReference)
from intent_mpc_torch.ops.dense_loop import (DenseScaledProblem,
                                             admm_iterations_dense,
                                             csr_capacity)
from intent_mpc_torch.ops.ew_chain import ew_chain
from intent_mpc_torch.ops.qp import ConVec, QPData
from intent_mpc_torch.utils import trace
from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig


class ADMMResult(NamedTuple):
    x: torch.Tensor          # (..., n) primal solution (unscaled)
    y: ConVec                # dual (unscaled)
    prim_res: torch.Tensor   # (...) ||Ax - z||_inf (unscaled)
    dual_res: torch.Tensor   # (...) ||Px + q + A^T y||_inf (unscaled)
    solved: torch.Tensor     # (...) bool: primal residual within tolerance
    rho_suggest: torch.Tensor  # OSQP adaptive-rho suggestion for the next solve
    # (...) int32 iterations each problem ran (truncation="osqp" only)
    iters: Optional[torch.Tensor] = None
    # (...) int32 blocks after which the problem's rho moved and its
    # factor was replaced (in-solve adaptive rho only)
    rho_switches: Optional[torch.Tensor] = None


class Scaling(NamedTuple):
    D: torch.Tensor          # (..., n) column scaling
    E: ConVec                # row scaling
    c: torch.Tensor          # (...) cost scaling


class Factor(NamedTuple):
    """Ruiz scaling and explicit normal-matrix inverse of one
    representative QP, reused across candidate solves."""
    D: torch.Tensor
    E: ConVec
    c: torch.Tensor
    Minv: torch.Tensor       # (..., n, n)


def check_supported(scfg: SolverConfig) -> None:
    """Raise ValueError for a solver option value that names no mode:
    every option of SolverConfig runs in this port."""
    for name, value, allowed in (
            ("truncation", scfg.truncation, ("fixed", "osqp")),
            ("shared_refine_mode", scfg.shared_refine_mode,
             ("cg", "stationary")),
            ("minv_dtype", scfg.minv_dtype, ("f32", "bf16"))):
        if value not in allowed:
            raise ValueError("%s must be one of %s, got %r"
                             % (name, ", ".join(map(repr, allowed)), value))


def _ones_like_constraints(cfg: PlannerConfig, qp: QPData) -> ConVec:
    H, W = cfg.horizon, cfg.mpc_window
    lead = qp.q.shape[:-1]
    K = qp.G.shape[-2]
    kw = dict(dtype=qp.q.dtype, device=qp.q.device)
    return ConVec(eq=torch.ones(lead + (H, qplib.NX), **kw),
                  sb=torch.ones(lead + (H, qplib.NX), **kw),
                  cb=torch.ones(lead + (W, qplib.NU), **kw),
                  obs=torch.ones(lead + (W, K), **kw))


def ruiz_equilibrate(cfg: PlannerConfig, qp: QPData, hdiag: torch.Tensor,
                     iters: int) -> Scaling:
    """Ruiz equilibration of [P A^T; A 0] + OSQP cost scaling, on the
    structured representation (qp.a_rowmax / qp.a_colmax). P is diagonal,
    so its scaled column norms are c*D^2*|h|."""
    n = cfg.num_vars
    lead = qp.q.shape[:-1]
    kw = dict(dtype=qp.q.dtype, device=qp.q.device)
    D = torch.ones(lead + (n,), **kw)
    E = _ones_like_constraints(cfg, qp)
    c = torch.ones(lead, **kw)
    habs = torch.abs(hdiag)

    def safe_inv_sqrt(v):
        return torch.where(v > 1e-12, torch.rsqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(iters):
        # column norms of scaled [P; A]
        pcol = c[..., None] * D * D * habs
        acol = qplib.a_colmax(cfg, qp, E) * D
        cn = torch.maximum(pcol, acol)
        D = D * safe_inv_sqrt(cn)
        # row norms of scaled A
        rn = qplib.a_rowmax(cfg, qp, D).scale(E)
        E = E.scale(rn.map(safe_inv_sqrt))
        # cost scaling
        pcol = c[..., None] * D * D * habs
        qs = c[..., None] * D * torch.abs(qp.q)
        denom = torch.maximum(torch.mean(pcol, dim=-1), torch.amax(qs, dim=-1))
        g = torch.where(denom > 1e-12, 1.0 / denom, torch.ones_like(denom))
        c = c * g
    return Scaling(D=D, E=E, c=c)


def candidate_mean(qps: QPData) -> QPData:
    """The QP one shared factor represents for the candidates on axis 1:
    the mean of every leaf, with the union of the obstacle activity."""
    return QPData(
        q=qps.q.mean(1), l=qps.l.map(lambda a: a.mean(1)),
        u=qps.u.map(lambda a: a.mean(1)), G=qps.G.mean(1),
        obs_dyn=qps.obs_dyn.mean(1), obs_active=qps.obs_active.amax(1),
        obs_slack=qps.obs_slack.mean(1))


def admm_factor(cfg: PlannerConfig, qp: QPData,
                scfg: Optional[SolverConfig] = None,
                rho_override=None) -> Factor:
    """Scaling + explicit normal-matrix inverse of one (representative)
    QP per batch entry, for reuse via admm_solve(factor=...), inside the
    span "factor" of utils/trace."""
    scfg = scfg or cfg.solver
    check_supported(scfg)
    with trace.span("factor"):
        hdiag = qplib.hessian_diag(cfg, qp.q.device)
        D, E, c = ruiz_equilibrate(cfg, qp, hdiag, scfg.scaling_iters)
        h_s = c[..., None] * D * D * hdiag
        rho_base = scfg.rho if rho_override is None else rho_override
        rho = qplib.rho_vec(cfg, qp, rho_base, scfg.rho_eq_scale)
        rho_inner = rho.map(lambda r, e: r * e * e, E)
        Minv = _explicit_minv(cfg, qp, h_s, scfg, rho_inner, D)
        if scfg.minv_dtype == "bf16":
            # storage only: every product reads it back as float32 (exact),
            # as JAX's bf16 x f32 matmul promotes
            Minv = Minv.to(torch.bfloat16)
    return Factor(D=D, E=E, c=c, Minv=Minv)


def _explicit_minv(cfg: PlannerConfig, qp: QPData, h_s, scfg: SolverConfig,
                   rho_inner: ConVec, D, M=None) -> torch.Tensor:
    """Explicit inverse (..., n, n) of the scaled x-update normal matrix,
    via the block-tridiagonal factorization (default) or the dense
    Cholesky of the assembled matrix (`structured_factor=False`; a caller
    that has assembled it already passes it as M)."""
    if scfg.structured_factor:
        return bc.structured_minv(cfg, qp, h_s, scfg.sigma, rho_inner, D)
    if M is None:
        M = qplib.assemble_normal_matrix(cfg, qp, h_s, scfg.sigma, rho_inner,
                                         col_scale=D)
    # cholesky_ex: no host sync on the info flag; a matrix that is not
    # positive definite gives a non-finite inverse, as in the JAX version
    L, _ = torch.linalg.cholesky_ex(M)
    eye = torch.eye(cfg.num_vars, dtype=M.dtype, device=M.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return torch.matmul(Linv.mT, Linv)


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def make_folded_m_op(cfg: PlannerConfig, qp: QPData, h_s, sigma: float,
                     rho_inner: ConVec, D):
    """The scaled normal matrix M = H_s + sigma I + (DA)^T E^2 rho (AD) as
    an apply with the D/E/rho scalings and activity masks folded into the
    constraint data once per solve (SolverConfig.folded_refine, JAX
    admm.py:79-167): each row r contributes (e_r^T v) e_r with e_r =
    sqrt(rho_r) E_r (row_r . D). The bound rows fold into one diagonal;
    the dynamics rows stay in closed-form shift form; the obstacle rows go
    through one pre-scaled gradient tensor. Leading axes broadcast (a
    shared factor's D (..., 1, n) against the candidates' QP)."""
    H, W = cfg.horizon, cfg.mpc_window
    NXc, NUc = qplib.NX, qplib.NU
    ts = cfg.ts
    Dx = D[..., :NXc * H].unflatten(-1, (H, NXc))
    Du = D[..., NXc * H:].unflatten(-1, (W, NUc))
    se = rho_inner.map(torch.sqrt)           # sqrt(rho) E per row
    diag = h_s + sigma + qplib.merge_z((se.sb * Dx) ** 2, (se.cb * Du) ** 2)
    re_eq = rho_inner.eq                                         # (..., H, 8)
    eo = se.obs * qp.obs_active                                  # (..., W, K)
    Gh = qp.G * eo[..., None]                                    # (..., W, K, 3)
    sl = eo * qp.obs_slack
    sd = sl * qp.obs_dyn
    ss = sl * (1.0 - qp.obs_dyn)

    def m_op(v):
        X = Dx * v[..., :NXc * H].unflatten(-1, (H, NXc))
        U = Du * v[..., NXc * H:].unflatten(-1, (W, NUc))
        p, vl, dd = X[..., 0:3], X[..., 3:6], X[..., 6:8]
        a, s = U[..., 0:3], U[..., 3:5]
        # dynamics rows weighted by rho E^2, then their transpose; the
        # zero rows keep JAX's order of the scatter-adds
        nxt_p = p[..., :-1, :] + ts * vl[..., :-1, :] + 0.5 * ts * ts * a \
            - p[..., 1:, :]
        nxt_v = vl[..., :-1, :] + ts * a - vl[..., 1:, :]
        nxt_d = s - dd[..., 1:, :]
        eq = torch.cat([-X[..., 0:1, :],
                        torch.cat([nxt_p, nxt_v, nxt_d], dim=-1)], dim=-2)
        w_eq = re_eq * eq
        wn = w_eq[..., 1:, :]                                    # (..., W, 8)
        zrow = torch.zeros_like(w_eq[..., :1, :])
        atw = torch.cat([wn[..., 0:3], ts * wn[..., 0:3] + wn[..., 3:6],
                         torch.zeros_like(wn[..., 6:8])], dim=-1)
        yX = torch.cat([-w_eq[..., 0:1, :], torch.zeros_like(wn)], dim=-2)
        yX = yX + torch.cat([atw, zrow], dim=-2)
        yX = yX + torch.cat([zrow, -wn], dim=-2)
        yU = torch.cat([0.5 * ts * ts * wn[..., 0:3] + ts * wn[..., 3:6],
                        wn[..., 6:8]], dim=-1)
        # obstacle rows through the pre-scaled gradient tensor
        r = qplib._wd(Gh, p[..., :-1, :]) - sd * s[..., 0:1] \
            - ss * s[..., 1:2]
        g = qplib._dw(r, Gh)                                     # (..., W, 3)
        yX = yX + torch.cat([torch.cat([g, torch.zeros_like(wn[..., 3:8])],
                                       dim=-1), zrow], dim=-2)
        yU = yU + torch.cat([torch.zeros_like(g),
                             -torch.sum(r * sd, dim=-1)[..., None],
                             -torch.sum(r * ss, dim=-1)[..., None]], dim=-1)
        return diag * v + qplib.merge_z(Dx * yX, Du * yU)

    return m_op


def _take_slots(a: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """a (..., W, K) at the obstacle slots (..., J): (..., W, J), the
    leading axes of both broadcast."""
    lead = torch.broadcast_shapes(a.shape[:-2], slots.shape[:-1])
    idx = slots[..., None, :].expand(lead + (a.shape[-2], slots.shape[-1]))
    return torch.gather(a.expand(lead + a.shape[-2:]), -1, idx)


def _slot_columns(cfg: PlannerConfig, qp: QPData, rho_obs: torch.Tensor,
                  D: torch.Tensor, E_obs: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """The scaled sqrt(rho)-weighted rows of the obstacle rows in `slots`
    (..., J), as U^T (..., 2 J W, n), JAX admm.py:282-326. An obstacle row
    of dynamic-slack mix d adds rho a a^T to the scaled normal matrix,
    split into two rank-1 terms sqrt(rho d) [g ; -1 at u_w[3]] and
    sqrt(rho (1 - d)) [g ; -1 at u_w[4]] (scaled by E and D); inactive
    rows give zero rows. Row order is JAX's column order: step-major, the
    u[3] terms of the J slots, then the u[4] terms."""
    H, W = cfg.horizon, cfg.mpc_window
    n = cfg.num_vars
    J = slots.shape[-1]
    dev = qp.G.device
    Es = _take_slots(E_obs, slots)                               # (..., W, J)
    rho_s = _take_slots(rho_obs, slots) * _take_slots(qp.obs_active, slots)
    dyn = _take_slots(qp.obs_dyn, slots)
    slk = _take_slots(qp.obs_slack, slots)
    G = torch.stack([_take_slots(qp.G[..., d], slots) for d in range(3)],
                    dim=-1)                                      # (..., W, J, 3)
    wi = torch.arange(W, device=dev)
    ji = torch.arange(J, device=dev)
    xcols = qplib.NX * wi[:, None] + torch.arange(3, device=dev)  # (W, 3)
    u3 = qplib.NX * H + qplib.NU * wi + 3
    gv = Es[..., None] * G * D[..., xcols][..., :, None, :]      # (..., W, J, 3)
    lead = torch.broadcast_shapes(gv.shape[:-3], rho_s.shape[:-2],
                                  D.shape[:-1])

    def side(ucol, weight):
        base = torch.zeros(lead + (W, J, n), dtype=G.dtype, device=dev)
        base[..., wi[:, None, None], ji[None, :, None],
             xcols[:, None, :]] = gv
        sv = -Es * slk * D[..., ucol][..., :, None]              # (..., W, J)
        base[..., wi[:, None], ji[None, :], ucol[:, None]] = sv
        w = torch.sqrt(torch.clamp(rho_s * weight, min=0.0))
        return base * w[..., None]

    rows = torch.cat([side(u3, dyn), side(u3 + 1, 1.0 - dyn)], dim=-2)
    return rows.reshape(lead + (2 * J * W, n))


def _woodbury_msolve(cfg: PlannerConfig, qp: QPData, rho: ConVec, D, E,
                     Minv: torch.Tensor, minv_mv, diff_slots: torch.Tensor,
                     shared: bool):
    """The exact x-update of each candidate (JAX admm.py:509-541): the
    shared factor inverts the base QP without the rows of `diff_slots`,
    so the candidate's normal matrix is M_base + U U^T with U its scaled
    rows of those slots (_slot_columns), and M_cand^{-1} v = Minv v -
    T (U^T Minv v), T = Minv U C^{-1}, C = I + U^T Minv U (SPD: a small
    Cholesky per candidate, batched). Returns msolve(rhs, x_init)."""
    Ut = _slot_columns(cfg, qp, rho.obs, D, E.obs, diff_slots)  # (..., k2, n)
    k2 = Ut.shape[-2]
    M = Minv.unsqueeze(-3) if shared else Minv
    Wu = torch.matmul(M, Ut.mT)                                  # (..., n, k2)
    eye = torch.eye(k2, dtype=Ut.dtype, device=Ut.device)
    C = eye + torch.matmul(Ut, Wu)
    Lc, _ = torch.linalg.cholesky_ex(C)
    Lci = torch.linalg.solve_triangular(Lc, eye.expand_as(Lc), upper=False)
    T = torch.matmul(Wu, torch.matmul(Lci.mT, Lci))

    def msolve(rhs, x_init):
        v = minv_mv(rhs)
        return v - torch.matmul(T, torch.matmul(Ut, v[..., None]))[..., 0]
    return msolve


def admm_solve(cfg: PlannerConfig, qp: QPData,
               x0: Optional[torch.Tensor] = None,
               max_iter: Optional[int] = None,
               scfg: Optional[SolverConfig] = None,
               feas_tol: float = 5e-2,
               rho_override=None,
               factor: Optional[Factor] = None,
               diff_slots: Optional[torch.Tensor] = None) -> ADMMResult:
    """Solve a batch of QPs (leading axes of `qp`).

    rho_override: base penalty replacing scfg.rho (a float or a tensor
    that broadcasts against the batch).
    factor: a Factor from admm_factor. Skips this QP's Ruiz scaling and
    factorization; the factor's Minv preconditions `shared_refine_iters`
    steps of refinement against THIS QP's normal matrix, applied in
    closed form (or through its blocks with `block_refine`, or folded
    with `folded_refine`).
    diff_slots: (..., 2) the obstacle slots in which the candidates differ
    from the factored base QP, with the factor's leading axes; with
    `woodbury_candidates` and a factor the x-update is the exact Woodbury
    solve (no refinement).

    The paths, in JAX's order of precedence: without a factor and with
    `adaptive_rho`, `_solve_adaptive` (OSQP's in-solve rho rule);
    `truncation="osqp"` stops each problem at OSQP's termination test
    (`_iterate_truncated`); with a factor, `flat_iter` runs `_solve_flat`
    unless the x-update is Woodbury's, the refinement is by blocks or
    folded, or the refinement has two phases; then exactly max_iter
    iterations with the ew_chain tail (`ew_kernel`, neither a Woodbury
    x-update nor two phases) or the grouped tail, the first
    int(max_iter * shared_refine_warm_frac) of them with
    `shared_refine_warm` refinement steps.
    """
    scfg = scfg or cfg.solver
    check_supported(scfg)
    dev = qp.q.device
    n = cfg.num_vars
    nb = qp.q.dim() - 1
    hdiag = qplib.hessian_diag(cfg, dev)
    sigma, alpha = scfg.sigma, scfg.alpha

    shared = False
    if factor is None:
        D, E, c = ruiz_equilibrate(cfg, qp, hdiag, scfg.scaling_iters)
    else:
        D, E, c = factor.D, factor.E, factor.c
        shared = factor.Minv.dim() - 2 < nb
        if shared:       # one factor per candidate group: broadcast over C
            D = D.unsqueeze(-2)
            E = E.map(lambda e: e.unsqueeze(-3))
            c = c.unsqueeze(-1)
            if diff_slots is not None:
                diff_slots = diff_slots.unsqueeze(-2)
    h_s = c[..., None] * D * D * hdiag
    q_s = c[..., None] * D * qp.q
    l_s = qp.l.scale(E)
    u_s = qp.u.scale(E)

    rho_base = scfg.rho if rho_override is None else rho_override
    rho = qplib.rho_vec(cfg, qp, rho_base, scfg.rho_eq_scale)

    # the scaled constraint operator: one kernel launch per product on a
    # CUDA device (ops/constraint_op.py), plain PyTorch on the CPU
    if dev.type == "cuda":
        op = ConstraintOp(cfg, _contiguous(qp), D.contiguous(),
                          E.map(torch.Tensor.contiguous))
    else:
        op = ConstraintOpReference(cfg, qp, D, E)
    a_s = op.forward         # scaled A: E * A(D x)
    at_s = op.transpose      # scaled A^T: D * A^T(E w)

    def m_apply(v):
        # THIS QP's scaled normal matrix in closed form
        return op.normal(rho, h_s, sigma, v)

    if x0 is None:
        x0 = torch.zeros(qp.q.shape[:-1] + (n,), dtype=qp.q.dtype, device=dev)
    xs = x0 / D                  # to scaled space
    zs = a_s(xs)
    ys = ConVec(*(torch.zeros_like(a) for a in zs))
    iters = max_iter if max_iter is not None else scfg.max_iter
    unscale = _Unscale(cfg, qp, hdiag, D, E, c)

    if scfg.adaptive_rho and factor is None:
        return _solve_adaptive(cfg, qp, scfg, h_s, q_s, l_s, u_s, a_s, at_s,
                               xs, zs, ys, iters, rho_base, D, E, unscale,
                               feas_tol)

    tiny = 1e-30     # CG's guard, in the factor's dtype as in JAX
    if factor is None:
        rho_inner = rho.map(lambda r, e: r * e * e, E)
        Minv = _explicit_minv(cfg, qp, h_s, scfg, rho_inner, D)
        refine = scfg.refine_iters
    else:
        Minv = factor.Minv
        if Minv.dtype != torch.float32:
            # a bf16 factor: float32 products, as JAX's bf16 x f32 matmul
            # promotes (the conversion is exact)
            tiny = float(torch.tensor(tiny, dtype=Minv.dtype))
            Minv = Minv.to(torch.float32)
        refine = scfg.shared_refine_iters

    if shared:
        def minv_mv(v):   # (..., C, n) rows against one (..., n, n) Minv
            return torch.matmul(v, Minv.transpose(-1, -2))
    else:
        def minv_mv(v):
            return torch.matmul(Minv, v[..., None])[..., 0]

    m_op = m_apply   # the refinement's normal operator
    custom = None    # an x-update that replaces the refinement
    if factor is not None:
        if diff_slots is not None and scfg.woodbury_candidates:
            custom = _woodbury_msolve(cfg, qp, rho, D, E, Minv, minv_mv,
                                      diff_slots, shared)
        elif scfg.block_refine:
            Dblk, Eblk = bc.build_blocks(cfg, qp, h_s, sigma, rho.map(
                lambda r, e: r * e * e, E), D)
            perm = bc.flat_to_block_perm(cfg, dev)

            def m_op(v):
                return bc.block_apply(Dblk, Eblk, perm, v)
        elif scfg.folded_refine:
            m_op = make_folded_m_op(cfg, qp, h_s, sigma, rho.map(
                lambda r, e: r * e * e, E), D)

    cg = scfg.shared_refine_mode == "cg"
    warm_x0 = factor is not None and cg and scfg.shared_refine_x0 == "prev"
    warm = (int(iters * scfg.shared_refine_warm_frac)
            if factor is not None else 0)

    def make_step(refine_k: int, ew: bool):
        msolve = custom or _make_msolve(minv_mv, m_op, refine_k, cg, tiny)

        def x_update(xs, rzy, xt_prev):
            rhs = sigma * xs - q_s + at_s(rzy)
            return msolve(rhs, xt_prev if warm_x0 else None)

        if ew:
            # the carry (x, z, y, previous x-tilde, rho z - y): the
            # chain's tail feeds the next iteration's A^T
            def step(carry):
                xs, zs, ys, xt_prev, rzy = carry
                x_t = x_update(xs, rzy, xt_prev)
                xs, zs, ys, rzy = ew_chain(alpha, xs, x_t, zs, ys, a_s(x_t),
                                           rho, l_s, u_s)
                return xs, zs, ys, x_t, rzy
            return step

        def step(carry):
            xs, zs, ys, xt_prev = carry
            x_t = x_update(xs, zs.map(lambda zi, ri, yi: ri * zi - yi, rho,
                                      ys), xt_prev)
            return _grouped_tail(alpha, xs, x_t, zs, ys, a_s(x_t), rho,
                                 l_s, u_s) + (x_t,)
        return step

    ew = scfg.ew_kernel and custom is None
    if ew:
        carry = (xs, zs, ys, xs,
                 zs.map(lambda zi, ri, yi: ri * zi - yi, rho, ys))
    else:
        carry = (xs, zs, ys, xs)
    ran = None
    if scfg.truncation == "osqp":
        # every iteration at `refine`: JAX's truncation loop has no
        # two-phase refinement
        carry, ran = _iterate_truncated(make_step(refine, ew), carry, iters,
                                        scfg, unscale)
    elif (factor is not None and scfg.flat_iter and custom is None
          and not scfg.block_refine and not scfg.folded_refine
          and warm == 0):
        # the flat constraint-space iteration: JAX dispatches it before the
        # elementwise-kernel branch, so this path launches no ew_chain
        xs, zs, ys = _solve_flat(cfg, qp, scfg, D, E, h_s, q_s, rho, xs,
                                 iters, minv_mv, refine, cg, warm_x0, tiny)
        return _finish(cfg, qp, hdiag, unscale, xs, zs, ys, rho_base,
                       feas_tol)
    elif ew and warm == 0:
        step = make_step(refine, True)
        for _ in range(iters):
            carry = step(carry)
    else:
        carry = carry[:4]
        for k, n_k in ((scfg.shared_refine_warm, warm),
                       (refine, iters - warm)):
            step = make_step(k, False)
            for _ in range(n_k):
                carry = step(carry)
    xs, zs, ys = carry[:3]
    return _finish(cfg, qp, hdiag, unscale, xs, zs, ys, rho_base, feas_tol,
                   ran)


def _make_msolve(minv_mv, m_apply, refine: int, cg: bool,
                 tiny: float = 1e-30):
    """The x-update solve of M x = rhs with Minv as the preconditioner:
    Minv rhs alone at refine 0; else `refine` steps of preconditioned CG
    (shared_refine_mode "cg", whose x_init, the previous x-tilde, saves a
    Minv read) or of the stationary recurrence x += Minv (rhs - M x)
    (mode "stationary", which ignores x_init), as JAX's msolve does.
    `tiny` guards CG's step and conjugation quotients."""

    def msolve(rhs, x_init):
        if refine == 0:
            return minv_mv(rhs)
        if not cg:
            x = minv_mv(rhs)
            for _ in range(refine):
                x = x + minv_mv(rhs - m_apply(x))
            return x
        x = minv_mv(rhs) if x_init is None else x_init
        r = rhs - m_apply(x)
        z = minv_mv(r)
        p = z
        rz = _vdot(r, z)
        for j in range(refine):
            ap = m_apply(p)
            pap = _vdot(p, ap)
            a = torch.where(torch.abs(pap) > tiny, rz / pap,
                            torch.zeros_like(pap))
            x = x + a[..., None] * p
            if j < refine - 1:
                r = r - a[..., None] * ap
                z = minv_mv(r)
                rz_n = _vdot(r, z)
                b = torch.where(torch.abs(rz) > tiny, rz_n / rz,
                                torch.zeros_like(rz))
                rz = rz_n
                p = z + b[..., None] * p
        return x
    return msolve


def _finish(cfg, qp, hdiag, unscale, xs, zs, ys, rho_base, feas_tol,
            ran=None) -> ADMMResult:
    """The ADMMResult of scaled iterates: unscaled x, y and residuals, and
    OSQP's adaptive-rho suggestion from the relative residuals."""
    x, y, z, ax, aty = unscale(xs, zs, ys)
    prim, dual, ratio = _residual_ratio(ax, z, hdiag * x, aty, qp.q)
    do_adapt = (ratio > 5.0) | (ratio < 0.2)
    rho_b = torch.as_tensor(rho_base, dtype=ratio.dtype, device=x.device)
    rho_next = torch.where(do_adapt, torch.clamp(rho_b * ratio, 1e-4, 1e3),
                           rho_b)
    return ADMMResult(x=x, y=y, prim_res=prim, dual_res=dual,
                      solved=prim < feas_tol, rho_suggest=rho_next,
                      iters=ran)


@functools.lru_cache(maxsize=16)
def _static_a_top(horizon: int, window: int, ts: float,
                  device: torch.device) -> torch.Tensor:
    """The QP-independent top block of the constraint matrix: the dynamics
    equality rows, the state-bound identity and the control-bound
    identity, in con_to_flat order [eq (8H), sb (8H), cb (5W)], as one
    dense (16H + 5W, n) float32 matrix on `device`, built once and shared
    by every candidate, scenario and cycle (JAX admm.py:170-205, entry by
    entry). Do not modify it in place."""
    H, W = horizon, window
    NXc, NUc = qplib.NX, qplib.NU
    n = NXc * H + NUc * W
    A = np.zeros((NXc, NXc), np.float32)
    A[0:3, 0:3] = np.eye(3)
    A[0:3, 3:6] = np.eye(3) * ts
    A[3:6, 3:6] = np.eye(3)
    B = np.zeros((NXc, NUc), np.float32)
    B[0:3, 0:3] = np.eye(3) * 0.5 * ts * ts
    B[3:6, 0:3] = np.eye(3) * ts
    B[6:8, 3:5] = np.eye(2)
    top = np.zeros((2 * NXc * H + NUc * W, n), np.float32)
    top[0:NXc, 0:NXc] = -np.eye(NXc)
    for i in range(1, H):
        r = NXc * i
        top[r:r + NXc, NXc * (i - 1):NXc * i] = A
        top[r:r + NXc, NXc * H + NUc * (i - 1):NXc * H + NUc * i] = B
        top[r:r + NXc, NXc * i:NXc * (i + 1)] -= np.eye(NXc)
    top[NXc * H:2 * NXc * H, 0:NXc * H] = np.eye(NXc * H)
    top[2 * NXc * H:, NXc * H:] = np.eye(NUc * W)
    return torch.as_tensor(top, device=device)


def _solve_flat(cfg: PlannerConfig, qp: QPData, scfg: SolverConfig, D, E,
                h_s, q_s, rho: ConVec, xs0, iters: int, minv_mv,
                refine: int, cg: bool, warm_x0: bool, tiny: float):
    """The ADMM iteration in flat constraint space (SolverConfig.flat_iter,
    JAX admm.py:329-441): z, y, l, u and rho are single (..., m) vectors;
    the QP-invariant eq/sb/cb part of A and A^T is one product with the
    static _static_a_top matrix, and the obstacle rows apply through
    coefficient tensors folded once per solve (G E D, and the slack
    columns' E D). The same iteration as the grouped loop, in fewer ops
    per iteration; its elementwise tail is torch ops (no ew_chain, as in
    JAX's dispatch). Returns the scaled (xs, zs, ys), z and y as ConVec."""
    H, W = cfg.horizon, cfg.mpc_window
    NXc, NUc = qplib.NX, qplib.NU
    K = qp.G.shape[-2]
    sigma, alpha = scfg.sigma, scfg.alpha

    A_top = _static_a_top(H, W, cfg.ts, xs0.device)
    m_top = A_top.shape[0]
    Dx = D[..., :NXc * H].unflatten(-1, (H, NXc))
    Du = D[..., NXc * H:].unflatten(-1, (W, NUc))

    e_top = qplib.con_to_flat(E)[..., :m_top]
    rho_f = qplib.con_to_flat(rho)
    l_f = qplib.con_to_flat(qp.l.scale(E))
    u_f = qplib.con_to_flat(qp.u.scale(E))

    # folded obstacle coefficients (scaled rows on the unscaled x):
    # row (w, k): e [G . (Dx_w p) - slack (dyn Du3 u3 + (1 - dyn) Du4 u4)]
    Gh = qp.G * E.obs[..., None] * Dx[..., :-1, None, 0:3]      # (.., W, K, 3)
    sl = E.obs * qp.obs_slack * qp.obs_active
    sd = sl * qp.obs_dyn * Du[..., :, 3:4]                       # (.., W, K)
    ss = sl * (1.0 - qp.obs_dyn) * Du[..., :, 4:5]

    def a_flat(x):
        top = e_top * torch.matmul(D * x, A_top.t())
        Xu = x[..., :NXc * H].unflatten(-1, (H, NXc))
        Uu = x[..., NXc * H:].unflatten(-1, (W, NUc))
        obs = qplib._wd(Gh, Xu[..., :-1, 0:3]) \
            - sd * Uu[..., :, 3:4] - ss * Uu[..., :, 4:5]
        return torch.cat([top, obs.flatten(-2)], dim=-1)

    def at_flat(w):
        top = torch.matmul(e_top * w[..., :m_top], A_top)
        wo = w[..., m_top:].unflatten(-1, (W, K))
        gp = qplib._dw(wo, Gh)                                   # (.., W, 3)
        kw = dict(dtype=gp.dtype, device=gp.device)
        Xg = torch.cat([
            torch.cat([gp, torch.zeros(gp.shape[:-1] + (NXc - 3,), **kw)],
                      dim=-1),
            torch.zeros(gp.shape[:-2] + (1, NXc), **kw)], dim=-2)
        Ug = torch.cat([torch.zeros(gp.shape[:-1] + (3,), **kw),
                        -torch.sum(wo * sd, dim=-1)[..., None],
                        -torch.sum(wo * ss, dim=-1)[..., None]], dim=-1)
        return D * top + qplib.merge_z(Xg, Ug)

    def m_op(v):
        return h_s * v + sigma * v + at_flat(rho_f * a_flat(v))

    msolve = _make_msolve(minv_mv, m_op, refine, cg, tiny)
    x = xs0
    z = a_flat(xs0)
    y = torch.zeros_like(z)
    xt_prev = xs0
    for _ in range(iters):
        rhs = sigma * x - q_s + at_flat(rho_f * z - y)
        x_t = msolve(rhs, xt_prev if warm_x0 else None)
        ax = a_flat(x_t)
        x = alpha * x_t + (1.0 - alpha) * x
        z_relax = alpha * ax + (1.0 - alpha) * z
        z_n = torch.clamp(z_relax + y / rho_f, l_f, u_f)
        y = y + rho_f * (z_relax - z_n)
        z, xt_prev = z_n, x_t
    return x, qplib.flat_to_con(z, cfg, K), qplib.flat_to_con(y, cfg, K)


def _residual_ratio(ax: ConVec, z: ConVec, px, aty, q):
    """OSQP's adapt-rho measure from A x, z, P x, A^T y and q (all scaled
    or all unscaled): (||A x - z||, ||P x + q + A^T y||, sqrt(prim_rel /
    dual_rel)), inf-norms per problem, each relative residual over the
    largest of its terms' norms."""
    prim = (ax - z).inf_norm()
    dual = torch.amax(torch.abs(px + q + aty), dim=-1)
    prim_rel = prim / torch.clamp(torch.maximum(ax.inf_norm(), z.inf_norm()),
                                  min=1e-10)
    dual_rel = dual / torch.clamp(
        torch.maximum(torch.amax(torch.abs(px), dim=-1),
                      torch.maximum(torch.amax(torch.abs(aty), dim=-1),
                                    torch.amax(torch.abs(q), dim=-1))),
        min=1e-10)
    return prim, dual, torch.sqrt(prim_rel / torch.clamp(dual_rel, min=1e-12))


def _grouped_tail(alpha, xs, x_t, zs, ys, z_t, rho, l_s, u_s):
    """The elementwise tail of one iteration as grouped torch ops (the
    path with `ew_kernel` off; ew_chain computes the same bits)."""
    x_n = alpha * x_t + (1.0 - alpha) * xs
    z_relax = z_t.map(lambda zt, zi: alpha * zt + (1.0 - alpha) * zi, zs)
    z_n = z_relax.map(
        lambda zr, yi, ri, li, ui: torch.clamp(zr + yi / ri, li, ui),
        ys, rho, l_s, u_s)
    y_n = ys.map(lambda yi, zr, zn, ri: yi + ri * (zr - zn),
                 z_relax, z_n, rho)
    return x_n, z_n, y_n


class _Unscale:
    """Scaled iterates back to the QP's units, with the products the
    residuals need: (x, y, z, A x, A^T y)."""

    def __init__(self, cfg, qp, hdiag, D, E, c):
        self.cfg, self.qp, self.hdiag, self.D, self.E = cfg, qp, hdiag, D, E
        self.cg = c[..., None, None]

    def __call__(self, xs, zs, ys):
        x = self.D * xs
        y = ys.scale(self.E).map(lambda v: v / self.cg)
        z = zs.map(lambda zi, ei: zi / ei, self.E)
        return (x, y, z, qplib.a_matvec(self.cfg, self.qp, x),
                qplib.at_matvec(self.cfg, self.qp, y))

    def converged(self, scfg: SolverConfig, xs, zs, ys) -> torch.Tensor:
        """OSQP 0.6.2's termination test on the unscaled residuals, per
        problem: ||A x - z|| < eps_abs + eps_rel max(||A x||, ||z||) and
        ||P x + q + A^T y|| < eps_abs + eps_rel max(||P x||, ||A^T y||,
        ||q||), all inf-norms."""
        x, _, z, ax, aty = self(xs, zs, ys)
        q = self.qp.q
        prim_r = (ax - z).inf_norm()
        dual_r = torch.amax(torch.abs(self.hdiag * x + q + aty), dim=-1)
        eps_p = scfg.eps_abs + scfg.eps_rel * torch.maximum(
            ax.inf_norm(), z.inf_norm())
        eps_d = scfg.eps_abs + scfg.eps_rel * torch.maximum(
            torch.amax(torch.abs(self.hdiag * x), dim=-1),
            torch.maximum(torch.amax(torch.abs(aty), dim=-1),
                          torch.amax(torch.abs(q), dim=-1)))
        return (prim_r < eps_p) & (dual_r < eps_d)


def _keep(done: torch.Tensor, new, old):
    """Per problem: `old` where done, else `new` (a tensor (..., n) or a
    ConVec of (..., rows, width) groups)."""
    if isinstance(new, ConVec):
        d = done[..., None, None]
        return ConVec(*(torch.where(d, o, v) for v, o in zip(new, old)))
    return torch.where(done[..., None], old, new)


def _iterate_truncated(step, carry, iters: int, scfg: SolverConfig,
                       unscale: _Unscale):
    """OSQP-termination emulation (JAX admm.py:677-729): iterate in blocks
    of `term_check_interval`; a problem that meets OSQP's unscaled
    eps_abs/eps_rel test at a block end freezes at that iterate (what
    OSQP would have returned), the others go on to the max_iter cap.
    Full blocks run while any problem is live, then a remainder block of
    iters % blk runs once for the problems still live, so the cap is
    exact. As JAX's while_loop stops once every lane is done, the loop
    reads one boolean per block on the host (not after the last full
    block), counted as "admm.host_reads" in utils/trace: the only
    synchronization of this path. Frozen problems are computed with the
    rest and then kept, as under vmap.

    Returns (carry, iterations each problem ran)."""
    blk = scfg.term_check_interval
    nfull = (iters // blk) * blk
    xs = carry[0]
    done = torch.zeros(xs.shape[:-1], dtype=torch.bool, device=xs.device)
    ran = torch.zeros(xs.shape[:-1], dtype=torch.int32, device=xs.device)
    k = 0
    all_done = False
    while k < nfull:
        new = carry
        for _ in range(blk):
            new = step(new)
        carry = tuple(_keep(done, a, b) for a, b in zip(new, carry))
        ran = torch.where(done, ran, ran + blk)
        done = done | unscale.converged(scfg, *carry[:3])
        k += blk
        if k < nfull:
            trace.count("admm.host_reads")
            if bool(done.all()):
                all_done = True
                break
    rem = iters - nfull
    if rem > 0 and not all_done:
        new = carry
        for _ in range(rem):
            new = step(new)
        carry = tuple(_keep(done, a, b) for a, b in zip(new, carry))
        ran = torch.where(done, ran, ran + rem)
    return carry, ran


def _solve_adaptive(cfg, qp, scfg, h_s, q_s, l_s, u_s, a_s, at_s, xs, zs,
                    ys, iters, rho_base, D, E, unscale, feas_tol):
    """OSQP's in-solve adaptive rho with refactorization (JAX
    admm.py:779-868): blocks of `adapt_interval` iterations, max(iters //
    interval, 1) of them; after each, compare the scaled relative primal
    and dual residuals, rescale rho by sqrt(prim_rel / dual_rel) when the
    ratio leaves [0.2, 5] (clipped to [1e-6, 1e6]) and refactorize. Each
    x-update is Minv rhs plus `refine_iters` stationary steps x += Minv r
    against the problem's own normal matrix (not CG).

    JAX's lax.cond under vmap is a per-lane select: here every problem is
    refactored after a block (no host read decides whether any needs it;
    not after the last block, whose factor nothing reads) and keeps the
    new Minv only where its rho moved. With `ew_kernel` the elementwise
    tail is one ew_chain launch per iteration; its rho z - y carry is
    recomputed with the block's rho at the start of each block, since the
    chain wrote it with the previous rho. The returned prim_res is
    measured against clip(A x, l, u); rho_suggest is each problem's final
    rho; rho_switches counts the blocks at whose end it moved."""
    sigma, alpha = scfg.sigma, scfg.alpha
    interval = scfg.adapt_interval
    n_blocks = max(iters // interval, 1)
    lead = qp.q.shape[:-1]
    dev, dt = qp.q.device, qp.q.dtype

    def rho_rows(rho_b):
        return qplib.rho_vec(cfg, qp, rho_b, scfg.rho_eq_scale)

    def factor_for(rho):
        rho_inner = rho.map(lambda r, e: r * e * e, E)
        return _explicit_minv(cfg, qp, h_s, scfg, rho_inner, D)

    rho_b = torch.as_tensor(rho_base, dtype=dt, device=dev).expand(lead)
    rho_b = rho_b.contiguous()
    Minv = factor_for(rho_rows(rho_b))
    switches = torch.zeros(lead, dtype=torch.int32, device=dev)

    def minv_mv(v):
        return torch.matmul(Minv, v[..., None])[..., 0]

    for b in range(n_blocks):
        rho = rho_rows(rho_b)
        rzy = zs.map(lambda zi, ri, yi: ri * zi - yi, rho, ys)
        for _ in range(interval):
            rhs = sigma * xs - q_s + at_s(rzy)
            x_t = minv_mv(rhs)
            for _ in range(scfg.refine_iters):
                r = rhs - (h_s * x_t + sigma * x_t + at_s(a_s(x_t).map(
                    lambda a, ri: a * ri, rho)))
                x_t = x_t + minv_mv(r)
            z_t = a_s(x_t)
            if scfg.ew_kernel:
                xs, zs, ys, rzy = ew_chain(alpha, xs, x_t, zs, ys, z_t, rho,
                                           l_s, u_s)
            else:
                xs, zs, ys = _grouped_tail(alpha, xs, x_t, zs, ys, z_t, rho,
                                           l_s, u_s)
                rzy = zs.map(lambda zi, ri, yi: ri * zi - yi, rho, ys)

        # scaled relative residuals (OSQP adapt rule)
        _, _, ratio = _residual_ratio(a_s(xs), zs, h_s * xs, at_s(ys), q_s)
        do_adapt = (ratio > 5.0) | (ratio < 0.2)
        rho_b = torch.where(do_adapt, torch.clamp(rho_b * ratio, 1e-6, 1e6),
                            rho_b)
        switches = switches + do_adapt.to(torch.int32)
        if b < n_blocks - 1:
            Minv = torch.where(do_adapt[..., None, None],
                               factor_for(rho_rows(rho_b)), Minv)

    x, y, _, ax, aty = unscale(xs, zs, ys)
    z_clip = ax.map(lambda a, li, ui: torch.clamp(a, li, ui), qp.l, qp.u)
    prim = (ax - z_clip).inf_norm()
    dual = torch.amax(torch.abs(unscale.hdiag * x + qp.q + aty), dim=-1)
    return ADMMResult(x=x, y=y, prim_res=prim, dual_res=dual,
                      solved=prim < feas_tol, rho_suggest=rho_b,
                      rho_switches=switches)


# ---------------------------------------------------------------------------
# Dense-A path: setup (scaling, factorization, dense-A materialization) in
# PyTorch, the iteration loop in one launch of csrc/dense_loop.cu
# (ops/dense_loop.py)
# ---------------------------------------------------------------------------

def _dense_scaled_problem(cfg: PlannerConfig, qp: QPData, x0: torch.Tensor,
                          scfg: SolverConfig, n_pad: int, m_pad: int):
    """Per-candidate kernel inputs, Ruiz scaling applied to the dense A,
    for a QP with leading axes (...). Returns (DenseScaledProblem with the
    same leading axes, (D, E, c)). Padded rows and columns: Minv and M
    take the identity there, A zeros, rho 1e-6 and the bounds +-inf."""
    n = cfg.num_vars
    lead = qp.q.shape[:-1]
    dev, dt = qp.q.device, qp.q.dtype
    hdiag = qplib.hessian_diag(cfg, dev)
    D, E, c = ruiz_equilibrate(cfg, qp, hdiag, scfg.scaling_iters)
    h_s = c[..., None] * D * D * hdiag
    q_s = c[..., None] * D * qp.q
    rho = qplib.rho_vec(cfg, qp, scfg.rho, scfg.rho_eq_scale)
    rho_inner = rho.map(lambda r, e: r * e * e, E)
    M = qplib.assemble_normal_matrix(cfg, qp, h_s, scfg.sigma, rho_inner,
                                     col_scale=D)
    # the same Minv as admm_solve's (structured by default), so that both
    # paths share their iterates
    Minv = _explicit_minv(cfg, qp, h_s, scfg, rho_inner, D, M)

    # E A D, scaled in place: at 768 candidates A alone is ~3 GB
    A = qplib.dense_a_matrix(cfg, qp)                     # (..., m, n)
    A.mul_(qplib.con_to_flat(E)[..., :, None]).mul_(D[..., None, :])
    m = A.shape[-2]
    A_pad = torch.zeros(lead + (m_pad, n_pad), dtype=dt, device=dev)
    A_pad[..., :m, :n] = A
    del A

    def pad_mat(Mx):
        out = torch.eye(n_pad, dtype=dt, device=dev).repeat(lead + (1, 1))
        out[..., :n, :n] = Mx
        return out

    def pad_vec(v, size, fill):
        out = torch.full(lead + (size,), fill, dtype=dt, device=dev)
        out[..., :v.shape[-1]] = v
        return out

    sp = DenseScaledProblem(
        minv=pad_mat(Minv), mmat=pad_mat(M), amat=A_pad,
        q=pad_vec(q_s, n_pad, 0.0), x0=pad_vec(x0 / D, n_pad, 0.0),
        rho=pad_vec(qplib.con_to_flat(rho), m_pad, 1e-6),
        lo=pad_vec(qplib.con_to_flat(qp.l.scale(E)), m_pad, -qplib.INF),
        hi=pad_vec(qplib.con_to_flat(qp.u.scale(E)), m_pad, qplib.INF))
    return sp, (D, E, c)


def primal_residual(cfg: PlannerConfig, qps: QPData, x: torch.Tensor):
    """(||A x - clip(A x, l, u)||_inf, A x) of an unscaled x, in closed
    form: the residual of the solves that return no z."""
    ax = qplib.a_matvec(cfg, qps, x)
    z = ax.map(lambda a, lo, hi: torch.clamp(a, lo, hi), qps.l, qps.u)
    return (ax - z).inf_norm(), ax


def dense_result(cfg: PlannerConfig, qps: QPData, x: torch.Tensor,
                 scfg: SolverConfig, feas_tol: float = 5e-2) -> ADMMResult:
    """The ADMMResult of the dense path from the unscaled x. The kernel
    returns no duals, so y and dual_res are NaN (a caller comparing them
    with admm_solve fails loudly), and rho_suggest is scfg.rho."""
    prim, ax = primal_residual(cfg, qps, x)
    return ADMMResult(
        x=x, y=ax.map(lambda a: torch.full_like(a, float("nan"))),
        prim_res=prim, dual_res=torch.full_like(prim, float("nan")),
        solved=prim < feas_tol, rho_suggest=torch.full_like(prim, scfg.rho))


def dense_pads(cfg: PlannerConfig, K: int):
    """(n_pad, m_pad) of the dense path: the variable and constraint-row
    counts rounded up to multiples of 128, as the JAX version pads."""
    n = cfg.num_vars
    m = 2 * qplib.NX * cfg.horizon + (qplib.NU + K) * cfg.mpc_window
    return ((n + 127) // 128) * 128, ((m + 127) // 128) * 128


def _contiguous(qp: QPData) -> QPData:
    """The QP with every tensor contiguous (each one itself if it is)."""
    return QPData(*(v.map(torch.Tensor.contiguous) if isinstance(v, ConVec)
                    else v.contiguous() for v in qp))


def _flatten(qp: QPData, nb: int) -> QPData:
    """The QP with its nb leading axes merged into one."""
    def f(t):
        return t.reshape((-1,) + t.shape[nb:])
    return QPData(*(ConVec(*map(f, v)) if isinstance(v, ConVec) else f(v)
                    for v in qp))


def admm_solve_dense(cfg: PlannerConfig, qps: QPData, x0: torch.Tensor,
                     max_iter: Optional[int] = None,
                     scfg: Optional[SolverConfig] = None,
                     feas_tol: float = 5e-2) -> ADMMResult:
    """Batched solve on each candidate's materialized, scaled dense A, with
    every iteration in one launch of the dense-loop kernel (port of
    `admm_solve_pallas`, intent_mpc_tpu/ops/admm.py:927-972). qps and x0
    carry any leading batch axes (the planner's (S, 6) included); they are
    flattened to one candidate axis for the solve. Runs where the QP's
    tensors lie: CUDA launches the kernel, the CPU runs its plain version.

    The setup follows the JAX version: Ruiz scaling, the penalty from
    scfg.rho (no rho_override), Minv from `_explicit_minv`, n and m padded
    to multiples of 128, `refine_iters` stationary refinement steps
    through the dense M. The kernel returns x in scaled space; this
    unscales it (x = D xs[:n]) and computes the primal residual in closed
    form. y and dual_res are NaN and rho_suggest is scfg.rho, as in JAX."""
    scfg = scfg or cfg.solver
    iters = max_iter if max_iter is not None else scfg.max_iter
    n = cfg.num_vars
    K = qps.G.shape[-2]
    n_pad, m_pad = dense_pads(cfg, K)
    if qps.q.device.type == "cuda":
        need, cap = qplib.dense_a_nnz_max(cfg, K), csr_capacity(n_pad, m_pad)
        if need > cap:
            raise ValueError(
                "dense_loop kernel cannot hold A: up to %d nonzeros per "
                "candidate at %d obstacle slots, its CSR holds %d at n_pad "
                "= %d, m_pad = %d" % (need, K, cap, n_pad, m_pad))
    lead = qps.q.shape[:-1]
    flat = _flatten(qps, len(lead))
    sp, (D, _, _) = _dense_scaled_problem(
        cfg, flat, x0.expand(lead + (n,)).reshape(-1, n), scfg, n_pad, m_pad)
    xs = admm_iterations_dense(sp, iters, scfg.sigma, scfg.alpha,
                               refine=scfg.refine_iters)
    x = (D * xs[:, :n]).reshape(lead + (n,))
    return dense_result(cfg, qps, x, scfg, feas_tol)
