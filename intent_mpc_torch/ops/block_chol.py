"""Block-tridiagonal Cholesky for the MPC x-update normal matrix (port of
intent_mpc_tpu/ops/block_chol.py).

Ordering the decision variables per step as v_i = [x_i (8), u_i (5)],
M = P + sigma I + A^T rho A is block-tridiagonal with 13x13 blocks. The
explicit inverse is built in four batched passes:

  1. the (H, 13, 13) diagonal and sub-diagonal blocks from the closed-form
     per-step contributions,
  2. the block-Cholesky recursion S_{i+1} = D_{i+1} - G_i G_i^T,
     G_i = E_i L_i^{-T}, as a loop over the horizon,
  3. the row-blocks of L^{-1}: Y_i = J_i (I_i - G_{i-1} Y_{i-1}),
  4. Minv = Y^T Y with one batched matmul.

`block_apply` multiplies by M through the same blocks (the refinement
operator of SolverConfig.block_refine).

Every tensor carries leading batch axes (...).
"""

from __future__ import annotations

from typing import Tuple

import torch

from intent_mpc_torch.ops.qp import ConVec, QPData, NX, NU, dynamics_matrices
from intent_mpc_torch.utils.config import PlannerConfig

BS = NX + NU  # 13: per-step block size [x_i, u_i]


def chol_inv_small(S: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., m, m) SPD -> (L, J = L^{-1}).

    `cholesky_ex` does not read its info flag back to the host, so the
    factorization never synchronizes the stream; a matrix that is not
    positive definite yields non-finite entries, as the reference's
    unrolled rsqrt recursion does."""
    L, _ = torch.linalg.cholesky_ex(S)
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    J = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return L, J


def build_blocks(cfg: PlannerConfig, qp: QPData, hdiag_s: torch.Tensor,
                 sigma: float, rho: ConVec, col_scale
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step blocks of the scaled normal matrix.

    Returns (Dblk (..., H, 13, 13), Eblk (..., H, 13, 13)) with Eblk[i] =
    M[v_{i+1}, v_i] (last entry zero), the same contributions as
    qp.assemble_normal_matrix, block-local."""
    ts = cfg.ts
    H, W = cfg.horizon, cfg.mpc_window
    dt, dev = hdiag_s.dtype, hdiag_s.device
    A, B = dynamics_matrices(ts, dt, dev)
    lead = torch.broadcast_shapes(hdiag_s.shape[:-1], qp.q.shape[:-1])

    r = rho.eq[..., 1:, :]                                     # (..., W, 8)
    AtrA = torch.einsum("ja,...wj,jb->...wab", A, r, A)
    AtrB = torch.einsum("ja,...wj,jb->...wab", A, r, B)
    BtrB = torch.einsum("ja,...wj,jb->...wab", B, r, B)

    ro = rho.obs * qp.obs_active                               # (..., W, K)
    G = qp.G
    PP = torch.einsum("...wk,...wka,...wkb->...wab", ro, G, G)  # (..., W, 3, 3)
    rs = ro * qp.obs_slack
    sd = torch.sum(rs * qp.obs_dyn, dim=-1)                    # (..., W)
    ss = torch.sum(rs * (1.0 - qp.obs_dyn), dim=-1)
    cd = -torch.einsum("...wk,...wka->...wa", rs * qp.obs_dyn, G)
    cs = -torch.einsum("...wk,...wka->...wa", rs * (1.0 - qp.obs_dyn), G)

    # ---- diagonal blocks ----
    Dblk = torch.zeros(lead + (H, BS, BS), dtype=dt, device=dev)
    Dw = Dblk[..., :W, :, :]                                   # view
    Dw[..., :NX, :NX] += AtrA
    Dw[..., 0:3, 0:3] += PP
    Dw[..., :NX, NX:] += AtrB
    Dw[..., NX:, :NX] += AtrB.transpose(-1, -2)
    Dw[..., NX:, NX:] += BtrB
    Dw[..., NX + 3, NX + 3] += sd
    Dw[..., NX + 4, NX + 4] += ss
    Dw[..., 0:3, NX + 3] += cd
    Dw[..., NX + 3, 0:3] += cd
    Dw[..., 0:3, NX + 4] += cs
    Dw[..., NX + 4, 0:3] += cs

    ax8 = torch.arange(NX, device=dev)
    ax5 = torch.arange(NU, device=dev)
    Dblk[..., ax8, ax8] += rho.sb                               # (..., H, 8)
    Dw[..., NX + ax5, NX + ax5] += rho.cb                       # (..., W, 5)
    Dblk[..., 0, ax8, ax8] += rho.eq[..., 0, :]
    Dblk[..., 1:, ax8, ax8] += r

    # ---- sub-diagonal blocks: M[v_{i+1}, v_i] = [-r A | -r B] on x rows ----
    Eblk = torch.zeros(lead + (H, BS, BS), dtype=dt, device=dev)
    Eblk[..., :W, :NX, :NX] = -r[..., :, :, None] * A
    Eblk[..., :W, :NX, NX:] = -r[..., :, :, None] * B

    # ---- Ruiz column scaling (rows and columns of the A^T rho A part) ----
    if col_scale is not None:
        Dx = col_scale[..., : NX * H].reshape(col_scale.shape[:-1] + (H, NX))
        Du = col_scale[..., NX * H:].reshape(col_scale.shape[:-1] + (W, NU))
        pad = torch.ones(Du.shape[:-2] + (1, NU), dtype=dt, device=dev)
        dvec = torch.cat([Dx, torch.cat([Du, pad], dim=-2)], dim=-1)  # (..., H, 13)
        Dblk = dvec[..., :, :, None] * Dblk * dvec[..., :, None, :]
        Eblk = torch.cat([Eblk[..., :W, :, :]
                          * (dvec[..., 1:, :, None] * dvec[..., :W, None, :]),
                          Eblk[..., W:, :, :]], dim=-3)

    # ---- cost diagonal + sigma (already-scaled hdiag) + identity pads ----
    hx = hdiag_s[..., : NX * H].reshape(hdiag_s.shape[:-1] + (H, NX))
    hu = hdiag_s[..., NX * H:].reshape(hdiag_s.shape[:-1] + (W, NU))
    Dblk[..., ax8, ax8] += hx + sigma
    Dblk[..., :W, NX + ax5, NX + ax5] += hu + sigma
    # last block's u slots are padding: unit diagonal, no coupling (a
    # device scalar: a Python one would be copied from the host, which
    # synchronizes the stream)
    Dblk[..., W, NX + ax5, NX + ax5] = torch.ones((), dtype=dt, device=dev)
    return Dblk, Eblk


def flat_to_block_perm(cfg: PlannerConfig, device="cpu") -> torch.Tensor:
    """Index map: flat layout [X (H*8), U (W*5)] -> padded block layout
    [v_0 ... v_{H-1}] with v_i 13-wide (last block x-only + pad)."""
    H, W = cfg.horizon, cfg.mpc_window
    # built on the device: a copy from the host would synchronize
    x = BS * torch.arange(H, device=device)[:, None] \
        + torch.arange(NX, device=device)
    u = BS * torch.arange(W, device=device)[:, None] + NX \
        + torch.arange(NU, device=device)
    return torch.cat([x.reshape(-1), u.reshape(-1)])


def block_apply(Dblk: torch.Tensor, Eblk: torch.Tensor, perm: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """M x through the block-tridiagonal blocks, flat layout in and out
    (JAX block_chol.py:176-197): y_i = D_i x_i + E_{i-1} x_{i-1} +
    E_i^T x_{i+1}, as broadcast products summed over the 13-wide block
    (the JAX version's order, not a matmul's). Dblk/Eblk (..., H, 13, 13)
    and x (..., n) broadcast over their leading axes."""
    H = Dblk.shape[-3]
    lead = torch.broadcast_shapes(Dblk.shape[:-3], x.shape[:-1])
    xb = x.new_zeros(lead + (H * BS,))
    xb[..., perm] = x.expand(lead + x.shape[-1:])
    xb = xb.unflatten(-1, (H, BS))
    y = torch.sum(Dblk * xb[..., :, None, :], dim=-1)
    lo = torch.sum(Eblk[..., :-1, :, :] * xb[..., :-1, None, :], dim=-1)
    up = torch.sum(Eblk[..., :-1, :, :] * xb[..., 1:, :, None], dim=-2)
    zrow = torch.zeros_like(y[..., :1, :])
    y = y + torch.cat([zrow, lo], dim=-2)
    y = y + torch.cat([up, zrow], dim=-2)
    return y.flatten(-2)[..., perm]


def structured_minv(cfg: PlannerConfig, qp: QPData, hdiag_s: torch.Tensor,
                    sigma: float, rho: ConVec, col_scale) -> torch.Tensor:
    """Explicit M^{-1} (..., n, n) in the flat layout, via the
    block-tridiagonal Cholesky."""
    H = cfg.horizon
    N = BS * H
    Dblk, Eblk = build_blocks(cfg, qp, hdiag_s, sigma, rho, col_scale)
    lead = Dblk.shape[:-3]

    # block-Cholesky recursion: J_i = L_i^{-1}; G_i = E_i J_i^T;
    # S_{i+1} = D_{i+1} - G_i G_i^T
    Js, Gs = [], []
    S = Dblk[..., 0, :, :]
    for i in range(H):
        _, J_i = chol_inv_small(S)
        G_i = torch.matmul(Eblk[..., i, :, :], J_i.transpose(-1, -2))
        Js.append(J_i)
        Gs.append(G_i)
        if i + 1 < H:
            S = Dblk[..., i + 1, :, :] - torch.matmul(G_i, G_i.transpose(-1, -2))

    # L^{-1} row-blocks: Y_i = J_i (I_i - G_{i-1} Y_{i-1}); Y_{i-1} has no
    # columns >= 13 i, so columns [13 i, 13 i + 13) of Y_i are exactly J_i
    Linv = torch.zeros(lead + (N, N), dtype=Dblk.dtype, device=Dblk.device)
    Y_prev = None
    for i in range(H):
        rows = slice(BS * i, BS * (i + 1))
        if Y_prev is None:
            Y_i = torch.zeros(lead + (BS, N), dtype=Dblk.dtype,
                              device=Dblk.device)
        else:
            T = -torch.matmul(Gs[i - 1], Y_prev)
            Y_i = torch.matmul(Js[i], T)
        Y_i[..., :, rows] = Js[i]
        Linv[..., rows, :] = Y_i
        Y_prev = Y_i

    Minv_blk = torch.matmul(Linv.transpose(-1, -2), Linv)
    perm = flat_to_block_perm(cfg, Dblk.device)
    return Minv_blk.index_select(-2, perm).index_select(-1, perm)
