"""Batched dense-QP solver (OSQP-style ADMM) in plain PyTorch (port of
intent_mpc_tpu/ops/dense_admm.py).

For components whose QPs are small and irregular, such as the min-snap
polynomial trajectories (polyTrajSolver.cpp solves three per-axis OSQP
problems), where the structured MPC solver (ops/admm.py) does not apply.
Dense P (B, n, n), A (B, m, n): the leading axis batches the problems (the
three axis problems of every scenario's poly solve are one batch). This is
not a TPU kernel in the JAX package (no Pallas call), so it runs as torch
ops: every product is an IEEE float32 batched matmul (utils/device turns
TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DenseQPResult(NamedTuple):
    x: torch.Tensor          # (B, n)
    y: torch.Tensor          # (B, m)
    prim_res: torch.Tensor   # (B,)
    dual_res: torch.Tensor   # (B,)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (B, r, c) @ (B, c) -> (B, r)."""
    return torch.matmul(M, v[..., None])[..., 0]


def _amax(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(v), dim=-1)


def _ruiz(P, q, A, iters: int):
    B, n = q.shape
    m = A.shape[1]
    D = torch.ones((B, n), dtype=P.dtype, device=P.device)
    E = torch.ones((B, m), dtype=P.dtype, device=P.device)
    c = torch.ones((B,), dtype=P.dtype, device=P.device)
    Ph, qh, Ah = P, q, A

    def safe_inv_sqrt(v):
        return torch.where(v > 1e-12, torch.rsqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(iters):
        cn = torch.amax(torch.abs(Ph), dim=1)
        if m:
            cn = torch.maximum(cn, torch.amax(torch.abs(Ah), dim=1))
        dd = safe_inv_sqrt(cn)
        Ph = dd[:, :, None] * Ph * dd[:, None, :]
        qh = dd * qh
        Ah = Ah * dd[:, None, :]
        D = D * dd
        de = safe_inv_sqrt(torch.amax(torch.abs(Ah), dim=2))
        Ah = de[:, :, None] * Ah
        E = E * de
        pcol = torch.mean(torch.amax(torch.abs(Ph), dim=1), dim=-1)
        denom = torch.maximum(pcol, _amax(qh))
        g = torch.where(denom > 1e-12, 1.0 / denom, torch.ones_like(denom))
        Ph = Ph * g[:, None, None]
        qh = qh * g[:, None]
        c = c * g
    return Ph, qh, Ah, D, E, c


def _inverse(M: torch.Tensor) -> torch.Tensor:
    """M^-1 of SPD M (B, n, n) as L^-T L^-1 from its Cholesky factor
    (cholesky_ex: its info flag stays on the device; a problem whose factor
    fails gets NaN, as jnp.linalg.cholesky gives it)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[:, None, None], L,
                    torch.full_like(L, float("nan")))
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(M), upper=False)
    return torch.matmul(Linv.transpose(-1, -2), Linv)


def _normal_matrix(Ph, Ah, rho_v, sigma):
    eye = torch.eye(Ph.shape[-1], dtype=Ph.dtype, device=Ph.device)
    return Ph + sigma * eye \
        + torch.matmul(Ah.transpose(-1, -2) * rho_v[:, None, :], Ah)


def _iterate(x, z, y, qh, Ah, lo, hi, rho_v, M, Minv, sigma, alpha,
             iters: int):
    """`iters` ADMM steps with one refinement of each x-solve."""
    AhT = Ah.transpose(-1, -2)
    for _ in range(iters):
        rhs = sigma * x - qh + _mv(AhT, rho_v * z - y)
        x_t = _mv(Minv, rhs)
        x_t = x_t + _mv(Minv, rhs - _mv(M, x_t))
        z_t = _mv(Ah, x_t)
        x_n = alpha * x_t + (1 - alpha) * x
        z_rel = alpha * z_t + (1 - alpha) * z
        z_n = torch.clamp(z_rel + y / rho_v, lo, hi)
        y = y + rho_v * (z_rel - z_n)
        x, z = x_n, z_n
    return x, z, y


def solve_dense_qp(P: torch.Tensor, q: torch.Tensor, A: torch.Tensor,
                   l: torch.Tensor, u: torch.Tensor,
                   max_iter: int = 400, rho: float = 0.1,
                   sigma: float = 1e-6, alpha: float = 1.6,
                   scaling_iters: int = 3, adapt_blocks: int = 4,
                   polish_iters: int = 40,
                   x0: Optional[torch.Tensor] = None) -> DenseQPResult:
    """min 1/2 x'Px + q'x  s.t. l <= Ax <= u for a batch: P (B, n, n),
    q (B, n), A (B, m, n), l, u (B, m).

    Adaptive rho: the iterations split into `adapt_blocks` blocks; between
    blocks rho scales by sqrt(scaled prim res / scaled dual res) (OSQP's
    update rule) where that ratio leaves [1/5, 5], and the normal matrix is
    refactorized."""
    B, n = q.shape
    Ph, qh, Ah, D, E, c = _ruiz(P, q, A, scaling_iters)
    lh, uh = E * l, E * u

    eqr = torch.isfinite(lh) & torch.isfinite(uh) \
        & (torch.abs(uh - lh) < 1e-12)
    loose = torch.isneginf(lh) & torch.isposinf(uh)
    tiny = torch.full_like(lh, 1e-6)

    def mk_rho(r):
        return torch.where(eqr, torch.clamp(r * 1e3, 1e-6, 1e6)[:, None],
                           torch.where(loose, tiny, r[:, None].expand_as(lh)))

    xs = torch.zeros_like(q) if x0 is None else x0 / D
    zs = _mv(Ah, xs)
    ys = torch.zeros_like(lh)

    r_s = torch.full((B,), rho, dtype=P.dtype, device=P.device)
    block_iters = max(max_iter // max(adapt_blocks, 1), 1)
    for b in range(adapt_blocks):
        rho_v = mk_rho(r_s)
        M = _normal_matrix(Ph, Ah, rho_v, sigma)
        xs, zs, ys = _iterate(xs, zs, ys, qh, Ah, lh, uh, rho_v, M,
                              _inverse(M), sigma, alpha, block_iters)
        if b < adapt_blocks - 1:
            ax = _mv(Ah, xs)
            aty = _mv(Ah.transpose(-1, -2), ys)
            px = _mv(Ph, xs)
            pr = _amax(ax - zs)
            dr = _amax(px + qh + aty)
            prs = pr / torch.clamp(torch.maximum(_amax(ax), _amax(zs)),
                                   min=1e-10)
            drs = dr / torch.clamp(torch.maximum(
                _amax(px), torch.maximum(_amax(aty), _amax(qh))), min=1e-10)
            ratio = torch.sqrt(prs / torch.clamp(drs, min=1e-12))
            # OSQP rule: adapt only when the ratio leaves [1/5, 5]
            do = (ratio > 5.0) | (ratio < 0.2)
            r_s = torch.where(do, torch.clamp(r_s * ratio, 1e-6, 1e6), r_s)

    # ---- fixed-shape polish (OSQP polish analogue): snap the active set
    # of the final iterate to equalities under a high penalty, run a short
    # second phase, keep it only if it reduces the primal violation ----
    if polish_iters > 0:
        axs = _mv(Ah, xs)
        tol = 1e-3
        low_act = (axs - lh < tol * (1.0 + torch.abs(lh))) \
            & torch.isfinite(lh)
        upp_act = (uh - axs < tol * (1.0 + torch.abs(uh))) \
            & torch.isfinite(uh)
        act = low_act | upp_act | eqr
        bnd = torch.where(upp_act & ~eqr, uh, lh)
        lp = torch.where(act, bnd, lh)
        up = torch.where(act, bnd, uh)
        rho_p = torch.where(act, torch.full_like(lh, 1e3),
                            torch.where(loose, tiny,
                                        torch.full_like(lh, 1e-2)))
        Mp = _normal_matrix(Ph, Ah, rho_p, sigma)
        xp, _, yp = _iterate(xs, zs, ys, qh, Ah, lp, up, rho_p, Mp,
                             _inverse(Mp), sigma, alpha, polish_iters)

        def viol(xv):
            av = _mv(Ah, xv)
            return torch.amax(torch.maximum(torch.clamp(lh - av, min=0.0),
                                            torch.clamp(av - uh, min=0.0)),
                              dim=-1)

        better = (viol(xp) < viol(xs))[:, None]
        xs = torch.where(better, xp, xs)
        ys = torch.where(better, yp, ys)

    x = D * xs
    y = (E * ys) / c[:, None]
    ax = _mv(A, x)
    prim = _amax(ax - torch.clamp(ax, l, u))
    dual = _amax(_mv(P, x) + q + _mv(A.transpose(-1, -2), y))
    return DenseQPResult(x=x, y=y, prim_res=prim, dual_res=dual)
