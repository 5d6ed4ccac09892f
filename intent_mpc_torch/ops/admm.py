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

A never materializes (ops/qp.py closed forms); the x-update normal matrix
has an explicit inverse from the block-tridiagonal Cholesky
(ops/block_chol.py). With a shared Factor (one per scenario), each
candidate refines against its own normal matrix with preconditioned
CG-2, warm-started from the previous iteration's x-tilde. Iterations are
a fixed-count Python loop. The elementwise tail of each iteration is one
launch of the CUDA kernel ops/ew_chain.py when `ew_kernel` is on.

Batching: the QP carries leading axes (..., C). A Factor either has the
same leading axes (one factor per problem) or one axis fewer (one factor
per group of C candidates, shared by them, as the planner uses it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from intent_mpc_torch.ops import qp as qplib
from intent_mpc_torch.ops.block_chol import structured_minv
from intent_mpc_torch.ops.ew_chain import ew_chain
from intent_mpc_torch.ops.qp import ConVec, QPData
from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig


class ADMMResult(NamedTuple):
    x: torch.Tensor          # (..., n) primal solution (unscaled)
    y: ConVec                # dual (unscaled)
    prim_res: torch.Tensor   # (...) ||Ax - z||_inf (unscaled)
    dual_res: torch.Tensor   # (...) ||Px + q + A^T y||_inf (unscaled)
    solved: torch.Tensor     # (...) bool: primal residual within tolerance
    rho_suggest: torch.Tensor  # OSQP adaptive-rho suggestion for the next solve


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


# options that only admm_solve reads: the fleet-fused solve (ops/fleet.py)
# ignores them, as the JAX planner's fused branch does (mpc.py:419-453)
_SOLVE_ONLY = ("truncation", "adaptive_rho", "woodbury_candidates",
               "block_refine", "folded_refine", "flat_iter",
               "shared_refine_warm_frac", "shared_factor",
               "shared_refine_mode", "factor_drift_refresh")


def check_supported(scfg: SolverConfig, fused: Optional[bool] = None) -> None:
    """Raise for the solver options this port does not run yet. With
    `fused` True the options that only admm_solve reads are not checked
    (the fleet-fused solve and the factor ignore them); by default
    `fused` is the config's own fused_solve, and admm_solve passes
    False."""
    fused = scfg.fused_solve if fused is None else fused
    unported = {
        "truncation": scfg.truncation != "fixed",
        "adaptive_rho": scfg.adaptive_rho,
        "woodbury_candidates": scfg.woodbury_candidates,
        "block_refine": scfg.block_refine,
        "folded_refine": scfg.folded_refine,
        "flat_iter": scfg.flat_iter,
        "minv_dtype": scfg.minv_dtype != "f32",
        "shared_refine_warm_frac": scfg.shared_refine_warm_frac != 0.0,
        "structured_factor": not scfg.structured_factor,
        "shared_factor": not scfg.shared_factor,
        "shared_refine_mode": scfg.shared_refine_mode != "cg",
        "factor_drift_refresh": scfg.factor_drift_refresh > 0,
        "temporal_rho": scfg.temporal_rho,
        "polish": scfg.polish,
    }
    bad = [k for k, v in unported.items()
           if v and not (fused and k in _SOLVE_ONLY)]
    if bad:
        raise NotImplementedError(
            "solver options not ported: %s" % ", ".join(bad))


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
    QP per batch entry, for reuse via admm_solve(factor=...)."""
    scfg = scfg or cfg.solver
    # both solves use this factor: check only what they share
    check_supported(scfg, fused=True)
    hdiag = qplib.hessian_diag(cfg, qp.q.device)
    D, E, c = ruiz_equilibrate(cfg, qp, hdiag, scfg.scaling_iters)
    h_s = c[..., None] * D * D * hdiag
    rho_base = scfg.rho if rho_override is None else rho_override
    rho = qplib.rho_vec(cfg, qp, rho_base, scfg.rho_eq_scale)
    rho_inner = rho.map(lambda r, e: r * e * e, E)
    Minv = structured_minv(cfg, qp, h_s, scfg.sigma, rho_inner, D)
    return Factor(D=D, E=E, c=c, Minv=Minv)


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def admm_solve(cfg: PlannerConfig, qp: QPData,
               x0: Optional[torch.Tensor] = None,
               max_iter: Optional[int] = None,
               scfg: Optional[SolverConfig] = None,
               feas_tol: float = 5e-2,
               rho_override=None,
               factor: Optional[Factor] = None) -> ADMMResult:
    """Solve a batch of QPs (leading axes of `qp`).

    rho_override: base penalty replacing scfg.rho (a float or a tensor
    that broadcasts against the batch).
    factor: a Factor from admm_factor. Skips this QP's Ruiz scaling and
    factorization; the factor's Minv preconditions `shared_refine_iters`
    steps of refinement against THIS QP's normal matrix, applied in
    closed form.
    """
    scfg = scfg or cfg.solver
    check_supported(scfg, fused=False)
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
    h_s = c[..., None] * D * D * hdiag
    q_s = c[..., None] * D * qp.q
    l_s = qp.l.scale(E)
    u_s = qp.u.scale(E)

    rho_base = scfg.rho if rho_override is None else rho_override
    rho = qplib.rho_vec(cfg, qp, rho_base, scfg.rho_eq_scale)

    def a_s(x):      # scaled A: E * A(D x)
        return qplib.a_matvec(cfg, qp, D * x).scale(E)

    def at_s(w):     # scaled A^T: D * A^T(E w)
        return D * qplib.at_matvec(cfg, qp, w.scale(E))

    def m_apply(v):
        # THIS QP's scaled normal matrix in closed form
        return h_s * v + sigma * v + at_s(a_s(v).map(
            lambda a, ri: a * ri, rho))

    if factor is None:
        rho_inner = rho.map(lambda r, e: r * e * e, E)
        Minv = structured_minv(cfg, qp, h_s, sigma, rho_inner, D)
        refine = scfg.refine_iters
    else:
        Minv = factor.Minv
        refine = scfg.shared_refine_iters

    if shared:
        def minv_mv(v):   # (..., C, n) rows against one (..., n, n) Minv
            return torch.matmul(v, Minv.transpose(-1, -2))
    else:
        def minv_mv(v):
            return torch.matmul(Minv, v[..., None])[..., 0]

    warm_x0 = factor is not None and scfg.shared_refine_x0 == "prev"
    tiny = 1e-30

    def msolve(rhs, x_init):
        if refine == 0:
            return minv_mv(rhs)
        # preconditioned CG (refine steps) on this candidate's normal
        # system, Minv as preconditioner; x_init (the previous x-tilde)
        # saves a Minv read
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

    if x0 is None:
        x0 = torch.zeros(qp.q.shape[:-1] + (n,), dtype=qp.q.dtype, device=dev)
    xs = x0 / D                  # to scaled space
    zs = a_s(xs)
    ys = ConVec(*(torch.zeros_like(a) for a in zs))
    xt_prev = xs
    iters = max_iter if max_iter is not None else scfg.max_iter

    if scfg.ew_kernel:
        # the chain's tail (rho z - y) feeds the next iteration's A^T
        rzy = zs.map(lambda zi, ri, yi: ri * zi - yi, rho, ys)
        for _ in range(iters):
            rhs = sigma * xs - q_s + at_s(rzy)
            x_t = msolve(rhs, xt_prev if warm_x0 else None)
            z_t = a_s(x_t)
            xs, zs, ys, rzy = ew_chain(alpha, xs, x_t, zs, ys, z_t, rho,
                                       l_s, u_s)
            xt_prev = x_t
    else:
        for _ in range(iters):
            rz_y = zs.map(lambda zi, ri, yi: ri * zi - yi, rho, ys)
            rhs = sigma * xs - q_s + at_s(rz_y)
            x_t = msolve(rhs, xt_prev if warm_x0 else None)
            z_t = a_s(x_t)
            x_n = alpha * x_t + (1.0 - alpha) * xs
            z_relax = z_t.map(lambda zt, zi: alpha * zt + (1.0 - alpha) * zi,
                              zs)
            z_n = z_relax.map(
                lambda zr, yi, ri, li, ui: torch.clamp(zr + yi / ri, li, ui),
                ys, rho, l_s, u_s)
            ys = ys.map(lambda yi, zr, zn, ri: yi + ri * (zr - zn),
                        z_relax, z_n, rho)
            xs, zs, xt_prev = x_n, z_n, x_t

    # unscale
    cg = c[..., None, None]
    x = D * xs
    y = ys.scale(E).map(lambda v: v / cg)
    z = zs.map(lambda zi, ei: zi / ei, E)

    ax = qplib.a_matvec(cfg, qp, x)
    prim = (ax - z).inf_norm()
    aty = qplib.at_matvec(cfg, qp, y)
    dual = torch.amax(torch.abs(hdiag * x + qp.q + aty), dim=-1)

    # OSQP adaptive-rho suggestion from relative residuals
    prim_rel = prim / torch.clamp(torch.maximum(ax.inf_norm(), z.inf_norm()),
                                  min=1e-10)
    dual_rel = dual / torch.clamp(
        torch.maximum(torch.amax(torch.abs(hdiag * x), dim=-1),
                      torch.maximum(torch.amax(torch.abs(aty), dim=-1),
                                    torch.amax(torch.abs(qp.q), dim=-1))),
        min=1e-10)
    ratio = torch.sqrt(prim_rel / torch.clamp(dual_rel, min=1e-12))
    do_adapt = (ratio > 5.0) | (ratio < 0.2)
    rho_b = torch.as_tensor(rho_base, dtype=ratio.dtype, device=dev)
    rho_next = torch.where(do_adapt, torch.clamp(rho_b * ratio, 1e-4, 1e3),
                           rho_b)
    return ADMMResult(x=x, y=y, prim_res=prim, dual_res=dual,
                      solved=prim < feas_tol, rho_suggest=rho_next)
