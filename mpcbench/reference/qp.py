"""The candidate QPs as dense matrices, their Ruiz scaling and the
scaled normal matrix of the ADMM x-update.

Decision vector z = (X (H, 8) states, U (W, 5) controls), W = H - 1,
with x = (p, v, d1, d2), u = (a, slack_dyn, slack_static); rows in the
order [dynamics equalities (H, 8) | state bounds (H, 8) | control
bounds (W, 5) | obstacle rows (W, K)] (mpcPlanner.cpp:891-1146):

    eq[0] = -x_0 = -x_init ;  eq[i] = A x_{i-1} + B u_{i-1} - x_i = 0
    obs[w, k] = g_wk . p_w - slack_w  >=  1 - f(c_w) + g_wk . c_w

with g, f the gradient and value of the obstacle's ellipsoid at the
linearization point c_w. An obstacle row of slack mix d (1: the dynamic
slack u[3], 0: the static u[4]) takes its slack from u[3] with weight d
and from u[4] with weight 1 - d: in the normal matrix it is two rows of
weights d and 1 - d, each with slack coefficient -1 on its own column;
in a row norm its slack entry is d D[u3] + (1 - d) D[u4]. A candidate's
rows have d in {0, 1}; the candidate-mean QP that the shared factor
stands for has fractional d where the candidates differ.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NX, NU = 8, 5


class QP(NamedTuple):
    """Batched QP data with leading axes (...)."""
    q: torch.Tensor        # (..., n)
    l: torch.Tensor        # (..., m)
    u: torch.Tensor        # (..., m)
    G: torch.Tensor        # (..., W, K, 3) gradients (0 on inactive rows)
    dyn: torch.Tensor      # (..., W, K) slack mix
    active: torch.Tensor   # (..., W, K) 1 on live obstacle rows


def dims(pl: dict, K: int):
    H = pl["horizon"]
    W = H - 1
    n = NX * H + NU * W
    m_lin = 2 * NX * H + NU * W
    return H, W, n, m_lin, m_lin + W * K


def dynamics(ts: float, dtype, device):
    A = torch.zeros((NX, NX), dtype=dtype, device=device)
    B = torch.zeros((NX, NU), dtype=dtype, device=device)
    e = torch.eye(3, dtype=dtype, device=device)
    A[0:3, 0:3] = e
    A[0:3, 3:6] = ts * e
    A[3:6, 3:6] = e
    B[0:3, 0:3] = 0.5 * ts * ts * e
    B[3:6, 0:3] = ts * e
    B[6:8, 3:5] = torch.eye(2, dtype=dtype, device=device)
    return A, B


def hessian(pl: dict, dtype, device):
    H = pl["horizon"]
    qd = [pl["position_weight"]] * 3 + [pl["velocity_weight"]] * 3 \
        + list(pl["dummy_state_weights"])
    rd = [pl["acceleration_weight"]] * 3 + list(pl["slack_control_weights"])
    return torch.tensor(qd * H + rd * (H - 1), dtype=dtype, device=device)


def linear_rows(pl: dict, dtype, device):
    """The dense (m_lin, n) dynamics and bound rows, shared by every QP."""
    H, W, n, m_lin, _ = dims(pl, 0)
    A, B = dynamics(pl["ts"], dtype, device)
    M = torch.zeros((m_lin, n), dtype=dtype, device=device)
    for j in range(NX):
        M[j, j] = -1.0
    for i in range(1, H):
        r = NX * i
        M[r:r + NX, NX * (i - 1):NX * i] = A
        M[r:r + NX, NX * H + NU * (i - 1):NX * H + NU * i] = B
        M[r:r + NX, r:r + NX] -= torch.eye(NX, dtype=dtype, device=device)
    o = NX * H
    M[o:o + NX * H, 0:NX * H] = torch.eye(NX * H, dtype=dtype, device=device)
    o += NX * H
    M[o:o + NU * W, NX * H:] = torch.eye(NU * W, dtype=dtype, device=device)
    return M


def build(pl: dict, x0, xref, opos, osize, dyn, active, lin, yaw=None):
    """QPs of the candidates: x0 (..., 6), xref (..., H, 3), opos/osize
    (..., W, K, 3) ellipsoid centres and semi-axes, dyn/active
    (..., W, K), lin (..., W, 3) linearization points; yaw (..., W, K)
    each ellipsoid's turn about z (None: 0)."""
    H, W, n, m_lin, _ = dims(pl, opos.shape[-2])
    dt, dev = opos.dtype, opos.device
    lead = active.shape[:-2]
    inf = math.inf
    Q = torch.tensor([pl["position_weight"]] * 3 + [pl["velocity_weight"]] * 3
                     + list(pl["dummy_state_weights"]), dtype=dt, device=dev)
    xr = torch.cat([xref, torch.zeros(xref.shape[:-1] + (NX - 3,), dtype=dt,
                                      device=dev)], dim=-1)
    q = torch.cat([(-Q * xr).flatten(-2).expand(lead + (NX * H,)),
                   torch.zeros(lead + (NU * W,), dtype=dt, device=dev)], -1)
    # ellipsoid f(p) = sum ((R^T (p - o)) / s)^2 linearized at c, R the
    # turn by yaw about z
    dlt = lin[..., :, None, :] - opos
    if yaw is None:
        G = 2.0 * dlt / osize ** 2
        f = torch.sum((dlt / osize) ** 2, dim=-1)
    else:
        cy, sy = torch.cos(yaw), torch.sin(yaw)
        b = torch.stack([cy * dlt[..., 0] + sy * dlt[..., 1],
                         cy * dlt[..., 1] - sy * dlt[..., 0], dlt[..., 2]], -1)
        gb = 2.0 * b / osize ** 2
        G = torch.stack([cy * gb[..., 0] - sy * gb[..., 1],
                         sy * gb[..., 0] + cy * gb[..., 1], gb[..., 2]], -1)
        f = torch.sum((b / osize) ** 2, dim=-1)
    lo = 1.0 - f + torch.sum(G * lin[..., :, None, :], dim=-1)
    G = G * active[..., None]
    lo = torch.where(active > 0, lo, torch.full_like(lo, -inf))
    vmax, amax = pl["max_vel"], pl["max_acc"]
    y0, y1 = pl["y_range"]
    z0, z1 = pl["z_range"]
    skd = 1.0 - (1.0 - pl["dynamic_slack"]) ** 2
    sks = 1.0 - (1.0 - pl["static_slack"]) ** 2
    xmin = [-inf, y0, z0, -vmax, -vmax, -vmax, -inf, -inf]
    xmax = [inf, y1, z1, vmax, vmax, vmax, inf, inf]
    umin = [-amax] * 3 + [0.0, 0.0]
    umax = [amax] * 3 + [skd, sks]
    eq = torch.zeros(lead + (NX * H,), dtype=dt, device=dev)
    eq[..., 0:6] = -x0
    t = lambda v, r: torch.tensor(v * r, dtype=dt, device=dev).expand(lead + (len(v) * r,))
    lvec = torch.cat([eq, t(xmin, H), t(umin, W), lo.flatten(-2)], dim=-1)
    uvec = torch.cat([eq, t(xmax, H), t(umax, W),
                      torch.full(lead + (W * lo.shape[-1],), inf, dtype=dt,
                                 device=dev)], dim=-1)
    return QP(q=q, l=lvec, u=uvec, G=G, dyn=dyn * active, active=active)


def mean_qp(qp: QP) -> QP:
    """The QP one shared factor stands for: the mean over the candidate
    axis (-... axis 1 of (S, 6, ...)) with the union of the activity."""
    return QP(q=qp.q.mean(1), l=qp.l.mean(1), u=qp.u.mean(1), G=qp.G.mean(1),
              dyn=qp.dyn.mean(1), active=qp.active.amax(1))


def obstacle_rows(pl: dict, qp: QP, weight: str = "one"):
    """Dense obstacle rows (..., W K, n): G at p_w and the slack entries.
    weight "one": the row as it is (-d at u3, -(1 - d) at u4, the
    candidates'); "u3" / "u4": the unit-slack halves of the split rows."""
    H, W, n, _, _ = dims(pl, qp.G.shape[-2])
    K = qp.G.shape[-2]
    lead = qp.G.shape[:-3]
    R = torch.zeros(lead + (W, K, n), dtype=qp.G.dtype, device=qp.G.device)
    for w in range(W):
        R[..., w, :, NX * w:NX * w + 3] = qp.G[..., w, :, :]
        c = NX * H + NU * w
        if weight == "one":
            R[..., w, :, c + 3] = -qp.dyn[..., w, :]
            R[..., w, :, c + 4] = -(qp.active[..., w, :] - qp.dyn[..., w, :])
        elif weight == "u3":
            R[..., w, :, c + 3] = -qp.active[..., w, :]
        else:
            R[..., w, :, c + 4] = -qp.active[..., w, :]
    return R.flatten(-3, -2)


def dense_a(pl: dict, qp: QP, lin_rows):
    """The candidates' full dense constraint matrices (..., m, n)."""
    lead = qp.G.shape[:-3]
    L = lin_rows.expand(lead + lin_rows.shape)
    return torch.cat([L, obstacle_rows(pl, qp)], dim=-2)


def rho_rows(pl: dict, sv: dict, qp: QP, rho):
    """Per-row ADMM penalty (OSQP's compute_rho_vec): 1e3 rho on the
    equalities, 1e-6 on rows with no finite bound, rho elsewhere; an
    obstacle row is live by its activity. rho (...) per QP."""
    _, _, _, m_lin, _ = dims(pl, qp.G.shape[-2])
    r = rho[..., None]
    ll, ul = qp.l[..., :m_lin], qp.u[..., :m_lin]
    lin = torch.where(torch.isinf(ll) & torch.isinf(ul),
                      torch.full_like(ll, 1e-6), r.expand_as(ll))
    lin = torch.where(ll == ul, (sv["rho_eq_scale"] * r).expand_as(ll), lin)
    act = qp.active.flatten(-2)
    obs = torch.where(act > 0, r.expand_as(act), torch.full_like(act, 1e-6))
    return torch.cat([lin, obs], dim=-1)


def ruiz(pl: dict, sv: dict, qp: QP, lin_rows, hdiag):
    """Ruiz equilibration of [P A^T; A 0] with OSQP's cost scaling:
    (D (..., n), E (..., m), c (...))."""
    H, W, n, m_lin, _ = dims(pl, qp.G.shape[-2])
    K = qp.G.shape[-2]
    lead = qp.q.shape[:-1]
    dt, dev = qp.q.dtype, qp.q.device
    D = torch.ones(lead + (n,), dtype=dt, device=dev)
    E = torch.ones(lead + (m_lin + W * K,), dtype=dt, device=dev)
    c = torch.ones(lead, dtype=dt, device=dev)
    habs = hdiag.abs()
    Labs = lin_rows.abs()
    Gabs = qp.G.abs()
    u3 = NX * H + NU * torch.arange(W, device=dev) + 3
    pcols = NX * torch.arange(W, device=dev)[:, None] + torch.arange(3, device=dev)

    def inv_sqrt(v):
        return torch.where(v > 1e-12, 1.0 / torch.sqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(sv["scaling_iters"]):
        # column norms of the scaled [P; A]
        El, Eo = E[..., :m_lin], E[..., m_lin:].unflatten(-1, (W, K))
        col = torch.amax(Labs * El[..., :, None], dim=-2)
        eo = Eo * qp.active
        gcol = torch.amax(Gabs * eo[..., None], dim=-2)                 # (..., W, 3)
        col = col.clone()
        col[..., pcols] = torch.maximum(col[..., pcols], gcol)
        col[..., u3] = torch.maximum(col[..., u3], torch.amax(eo * qp.dyn, -1))
        col[..., u3 + 1] = torch.maximum(
            col[..., u3 + 1], torch.amax(eo * (qp.active - qp.dyn), -1))
        cn = torch.maximum(c[..., None] * D * D * habs, col * D)
        D = D * inv_sqrt(cn)
        # row norms of the column-scaled A
        rl = torch.amax(Labs * D[..., None, :], dim=-1)
        gmax = torch.amax(Gabs * D[..., pcols][..., :, None, :], dim=-1)  # (..., W, K)
        sl = qp.dyn * D[..., u3][..., :, None] \
            + (qp.active - qp.dyn) * D[..., u3 + 1][..., :, None]
        ro = torch.maximum(gmax, sl) * qp.active
        E = E * inv_sqrt(torch.cat([rl, ro.flatten(-2)], dim=-1) * E)
        # cost scaling
        pc = c[..., None] * D * D * habs
        qs = c[..., None] * D * qp.q.abs()
        den = torch.maximum(pc.mean(-1), qs.amax(-1))
        c = c * torch.where(den > 1e-12, 1.0 / den, torch.ones_like(den))
    return D, E, c


def normal_matrix(pl: dict, sv: dict, qp: QP, lin_rows, hdiag, D, E, c, rho):
    """The scaled x-update matrix diag(c D^2 h + sigma) + D A^T diag(rho
    E^2) A D, with every obstacle row split into its two slack halves
    of weights d and 1 - d."""
    H, W, n, m_lin, _ = dims(pl, qp.G.shape[-2])
    r = rho_rows(pl, sv, qp, rho) * E * E
    Al = lin_rows * D[..., None, :]
    M = torch.matmul(Al.mT * r[..., None, :m_lin], Al)
    ro = r[..., m_lin:]
    for half, wgt in (("u3", qp.dyn), ("u4", qp.active - qp.dyn)):
        Ao = obstacle_rows(pl, qp, half) * D[..., None, :]
        M = M + torch.matmul(Ao.mT * (ro * wgt.flatten(-2))[..., None, :], Ao)
    h_s = c[..., None] * D * D * hdiag
    return M + torch.diag_embed(h_s + sv["sigma"])
