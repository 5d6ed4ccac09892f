"""OSQP-style solution polish in float32 with double-float residuals
(port of intent_mpc_tpu/ops/polish.py), batched over leading axes.

OSQP polishes after convergence: it detects the active constraint set
from (z, y), solves the KKT system restricted to the active rows, and
refines iteratively (semantics mirrored by the port's float64 oracle,
intent_mpc_torch/oracle/numpy_ref.py:234 _polish). Here the refinement
computes its KKT residuals with compensated double-float arithmetic
(ops/df.py) and carries the (x, nu) iterates as hi + lo pairs, so
corrections below float32 resolution are not lost.

The correction operator lives in the condensed space: eliminating the
states through the dynamics (x = F u + w) leaves a condensed Hessian
H = R + F^T Q F (cond ~6e2) and an active-row Schur complement that a
float32 Cholesky plus a tiny ridge can factor. One defect-correction
step, for the pinned problem min 0.5 x^T P x + q^T x s.t. A_act x = b_act:

  residuals (compensated):  r_d = -(P x + q + A^T nu)
                            r_p = act * (b - A x)
  state elimination:        w   = Aeq_X^{-1} r_p,eq        (forward scan)
  condensed residuals:      rtd = r_d,U + F^T (r_d,X - Q w)
                            rtp = act_i * (r_p,i - Ai_X w)
  Schur solve (float32):    dnu_i = (S + reg)^{-1} (Aa H^{-1} rtd - rtp)
                            dU    = H^{-1} (rtd - At^T dnu_i)
  back substitution:        dX = F dU + w
                            dnu_eq = Aeq_X^{-T} (r_d,X - Q dX - Ai_X^T
                                     dnu_i)                 (backward scan)
  update (double-float):    x += (dX, dU);  nu += (dnu_eq, dnu_i)

Like OSQP, the polished solution is accepted only if it violates no
constraint row by more than `polish_accept_tol` (the oracle's gate,
intent_mpc_torch/oracle/numpy_ref.py:264-267); otherwise the input
iterate passes through unchanged.

Every reduction that the JAX version makes over one QP (and vmaps) is
made here over the last axis only, so each problem of a batch is
detected, converged and accepted on its own. The dense linear algebra
(the Schur matrix, its Cholesky and inverse) is torch.matmul and
torch.linalg, in float32 with TF32 off (utils/device.py), as the JAX
version computes it outside any Pallas kernel; `cholesky_ex` keeps the
host out of the loop (a matrix that is not positive definite gives a
non-finite polish, which the gate rejects).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from intent_mpc_torch.ops import df
from intent_mpc_torch.ops import qp as qplib
from intent_mpc_torch.ops.qp import NU, NX, ConVec, QPData
from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig


class PolishResult(NamedTuple):
    x: torch.Tensor           # (..., n) polished (or original) primal
    accepted: torch.Tensor    # (...) bool: polish passed the feasibility gate
    kkt_res: torch.Tensor     # (...) final compensated KKT inf-norm


class ActiveSet(NamedTuple):
    act: ConVec               # 1.0 where the row is pinned
    b: ConVec                 # pinned value (l or u per side; 0 inactive)


def detect_active_set(qp: QPData, z: ConVec, y: ConVec,
                      tol: float) -> ActiveSet:
    """OSQP's active-constraint rule (polish.c): a row is lower-active
    when the dual pushes down harder than the slack (z - l < -y) and
    upper-active when u - z < y; `tol` breaks ties for marginal rows.
    Equality rows (l == u) are always active."""
    def one(zi, yi, li, ui):
        fin_l = torch.isfinite(li)
        fin_u = torch.isfinite(ui)
        lc = torch.clamp(li, -1e10, 1e10)
        uc = torch.clamp(ui, -1e10, 1e10)
        low = fin_l & ((zi - lc) < torch.maximum(-yi, tol * (1 + torch.abs(lc))))
        upp = fin_u & ((uc - zi) < torch.maximum(yi, tol * (1 + torch.abs(uc))))
        eq = fin_l & fin_u & (li == ui)
        act = low | upp | eq
        b = torch.where(upp & ~eq, uc,
                        torch.where(act, lc, torch.zeros_like(lc)))
        return act.to(zi.dtype), b
    pairs = [one(zi, yi, li, ui) for zi, yi, li, ui in zip(z, y, qp.l, qp.u)]
    return ActiveSet(act=ConVec(*(p[0] for p in pairs)),
                     b=ConVec(*(p[1] for p in pairs)))


@functools.lru_cache(maxsize=8)
def _condensed_static(cfg: PlannerConfig
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Problem-data-independent polish operators, computed on the host in
    float64 and rounded once to float32: the condensation F = -Aeq_X^{-1}
    Aeq_U (x = F u + w), the condensed Hessian inverse Hinv =
    (R + F^T Q F)^{-1}, and the dynamics matrix A for the scans (the JAX
    package's numpy code, copied)."""
    H, W = cfg.horizon, cfg.mpc_window
    ts = cfg.ts
    Amat = np.zeros((NX, NX))
    Amat[0:3, 0:3] = np.eye(3)
    Amat[0:3, 3:6] = np.eye(3) * ts
    Amat[3:6, 3:6] = np.eye(3)
    Bmat = np.zeros((NX, NU))
    Bmat[0:3, 0:3] = np.eye(3) * 0.5 * ts * ts
    Bmat[3:6, 0:3] = np.eye(3) * ts
    Bmat[6:8, 3:5] = np.eye(2)

    # F row-block i gives x_i in terms of U: x_0 = 0, x_{i+1} = A x_i + B u_i
    F = np.zeros((H, NX, W * NU))
    for i in range(W):
        F[i + 1] = Amat @ F[i]
        F[i + 1, :, NU * i: NU * (i + 1)] += Bmat
    F = F.reshape(H * NX, W * NU)

    Qd = np.array([cfg.position_weight] * 3 + [cfg.velocity_weight] * 3
                  + list(cfg.dummy_state_weights))
    Rd = np.array([cfg.acceleration_weight] * 3
                  + list(cfg.slack_control_weights))
    Qfull = np.tile(Qd, H)
    Rfull = np.tile(Rd, W)
    Ht = np.diag(Rfull) + F.T @ (Qfull[:, None] * F)
    Hinv = np.linalg.inv(Ht)      # cond(Ht) ~6e2: benign in float32
    return (F.astype(np.float32), Hinv.astype(np.float32),
            Amat.astype(np.float32))


@functools.lru_cache(maxsize=8)
def _static_on(cfg: PlannerConfig, device: torch.device):
    """_condensed_static's operators on one device, copied there once."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _condensed_static(cfg))


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M @ v over leading axes (M (..., a, b) or (a, b), v (..., b))."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _fwd_scan(Amat: torch.Tensor, rp_eq: torch.Tensor) -> torch.Tensor:
    """Solve Aeq_X w = rp_eq (block lower-bidiagonal: -I diagonal, A below)
    for rp_eq (..., H, NX)."""
    w = -rp_eq[..., 0, :]
    ws = [w]
    for i in range(1, rp_eq.shape[-2]):
        w = _mv(Amat, w) - rp_eq[..., i, :]
        ws.append(w)
    return torch.stack(ws, dim=-2)


def _bwd_scan(Amat: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Solve Aeq_X^T nu = s (block upper-bidiagonal) for s (..., H, NX)."""
    v = -s[..., -1, :]
    vs = [v]
    At = Amat.mT
    for i in range(s.shape[-2] - 2, -1, -1):
        v = _mv(At, v) - s[..., i, :]
        vs.append(v)
    return torch.stack(vs[::-1], dim=-2)


def polish(cfg: PlannerConfig, qp: QPData, x: torch.Tensor, y: ConVec,
           scfg: Optional[SolverConfig] = None) -> PolishResult:
    """Polish a batch of QP solutions (leading axes of `qp`) to the exact
    KKT point of their active sets: one dense A per problem, and per round
    one masked (m_i, m_i) Schur Cholesky and scfg.polish_iters
    compensated correction steps. The planner calls it for the chosen
    candidate of each scenario."""
    scfg = scfg or cfg.solver
    neq = NX * cfg.horizon
    Fc, Hinv, Amat = _static_on(cfg, x.device)
    K = qp.G.shape[-2]

    A = qplib.dense_a_matrix(cfg, qp)                    # (..., m, n)
    At = A.mT.contiguous()
    lf = qplib.con_to_flat(qp.l)
    uf = qplib.con_to_flat(qp.u)
    Ai = A[..., neq:, :]
    Ai_x = Ai[..., :neq]

    x_cur = x
    y_cur = y
    x_pol = x
    nu_flat = torch.zeros(A.shape[:-1], dtype=x.dtype, device=x.device)
    kkt = torch.full(x.shape[:-1], float("inf"), dtype=x.dtype,
                     device=x.device)

    # primal-dual active-set rounds: each pins the set implied by the
    # current (z, y), converges the pinned KKT exactly, and hands its
    # point and exact duals to the next round's detection
    for _ in range(scfg.polish_rounds):
        x_pol, nu_flat, kkt = _polish_round(
            cfg, qp, scfg, A, At, Ai, Ai_x, Fc, Hinv, Amat,
            x_cur, y_cur, nu_flat)
        x_cur = x_pol
        y_cur = qplib.flat_to_con(nu_flat, cfg, K)

    # acceptance: the polished point must not violate any row
    # (the oracle's gate, oracle/numpy_ref.py:264-267), per problem
    z_pol = _mv(A, x_pol)
    ok = torch.all(z_pol >= lf - scfg.polish_accept_tol, dim=-1) \
        & torch.all(z_pol <= uf + scfg.polish_accept_tol, dim=-1)
    return PolishResult(x=torch.where(ok[..., None], x_pol, x),
                        accepted=ok, kkt_res=kkt)


def _polish_round(cfg: PlannerConfig, qp: QPData, scfg: SolverConfig,
                  A, At, Ai, Ai_x, Fc, Hinv, Amat, x, y, nu_warm):
    """One detect -> converge pass; returns (x_pol, nu_flat, kkt)."""
    H = cfg.horizon
    neq = NX * H
    hdiag = qplib.hessian_diag(cfg, x.device)
    Qfull = hdiag[:neq]
    qv = qp.q

    z = qplib.a_matvec(cfg, qp, x)
    aset = detect_active_set(qp, z, y, scfg.polish_tol)
    actf = qplib.con_to_flat(aset.act)
    bf = qplib.con_to_flat(aset.b)
    act_i = actf[..., neq:]

    # condensed active rows + Jacobi-scaled ridged Schur factor (float32)
    At_u = torch.matmul(Ai_x, Fc) + Ai[..., neq:]      # (..., m_i, nu_dim)
    Aa_u = At_u * act_i[..., None]
    T = torch.matmul(Aa_u, Hinv)
    S = torch.matmul(T, Aa_u.mT)                       # (..., m_i, m_i)
    dS = torch.rsqrt(torch.diagonal(S, dim1=-2, dim2=-1) + (1.0 - act_i))
    mi = S.shape[-1]
    eye = torch.eye(mi, dtype=S.dtype, device=S.device)
    Ss = (dS[..., :, None] * S * dS[..., None, :]) \
        * (act_i[..., :, None] * act_i[..., None, :])
    Ss = Ss + torch.diag_embed(1.0 - act_i) + scfg.polish_reg * eye
    del S, T
    Ls, _ = torch.linalg.cholesky_ex(Ss)
    del Ss
    Lsi = torch.linalg.solve_triangular(Ls, eye.expand_as(Ls), upper=False)
    del Ls
    Sinv = torch.matmul(Lsi.mT, Lsi)
    del Lsi

    # df iterates: x (..., n) and nu (..., m) as hi+lo pairs. Dual warm
    # start: the previous round's exact multipliers where a problem has
    # any, else the caller's ADMM duals
    xh, xl = x, torch.zeros_like(x)
    have_warm = torch.any(nu_warm != 0.0, dim=-1, keepdim=True)
    nh = actf * torch.where(have_warm, nu_warm, qplib.con_to_flat(y))
    nl = torch.zeros_like(nh)
    zeros_q = torch.zeros_like(qv)
    res = None
    for _ in range(scfg.polish_iters):
        # r_d = -(P x + q + A^T nu), compensated
        px_h, px_l = df.two_prod(hdiag, xh)
        px_l = px_l + hdiag * xl
        atn_h, atn_l = df.df_matvec(At, nh, nl)
        sh_, sl_ = df.df_add(px_h, px_l, atn_h, atn_l)
        sh_, sl_ = df.df_add(sh_, sl_, qv, zeros_q)
        rd = -(sh_ + sl_)
        # r_p = act * (b - A x), compensated
        ax_h, ax_l = df.df_matvec(A, xh, xl)
        rp = actf * ((bf - ax_h) - ax_l)

        rd_x, rd_u = rd[..., :neq], rd[..., neq:]
        lead = rd.shape[:-1]
        w = _fwd_scan(Amat, rp[..., :neq].reshape(lead + (H, NX))
                      ).reshape(lead + (neq,))
        rtd = rd_u + torch.matmul((rd_x - Qfull * w).unsqueeze(-2),
                                  Fc).squeeze(-2)
        rtp = act_i * (rp[..., neq:] - _mv(Ai_x, w))
        t = _mv(Aa_u, _mv(Hinv, rtd)) - rtp
        dnu_i = act_i * dS * _mv(Sinv, dS * t)
        dU = _mv(Hinv, rtd - _mv(At_u.mT, dnu_i))
        dX = _mv(Fc, dU) + w
        s = rd_x - Qfull * dX - _mv(Ai_x.mT, dnu_i)
        dnu_eq = _bwd_scan(Amat, s.reshape(lead + (H, NX))
                           ).reshape(lead + (neq,))

        dx = torch.cat([dX, dU], dim=-1)
        dnu = torch.cat([dnu_eq, dnu_i], dim=-1)
        xh, xl = df.df_add(xh, xl, dx, torch.zeros_like(dx))
        nh, nl = df.df_add(nh, nl, dnu, torch.zeros_like(dnu))
        res = torch.maximum(torch.amax(torch.abs(rd), dim=-1),
                            torch.amax(torch.abs(rp), dim=-1))
    return xh + xl, nh + nl, res
