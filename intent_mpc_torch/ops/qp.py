"""Structured MPC-QP assembly (port of intent_mpc_tpu/ops/qp.py).

The reference casts the MPC to a sparse OSQP problem with Eigen triplet
inserts (trajectory_planner/mpcPlanner.cpp:891-1146). Here the QP stays
structured: the decision vector is (X: (H,8) states, U: (W,5) controls)
and the constraint space is a tuple of fixed-shape groups:

    eq  (H,8):  -x_0 ;  A x_{i-1} + B u_{i-1} - x_i        (dynamics equality)
    sb  (H,8):  x_i                                         (state bounds)
    cb  (W,5):  u_i                                         (control bounds)
    obs (W,K):  g_{ik}.p_i - s_{ik}                         (linearized ellipsoids)

Matvecs with A and A^T are closed-form shifts and small contractions.
Every tensor carries any number of leading batch axes (scenarios,
candidates) before its per-problem trailing dims: x (..., n), groups
(..., H, 8) etc. Inactive obstacle slots carry zero gradients and
(-inf, +inf) bounds.

State/control model (mpcPlanner.cpp:891-921):
  x = (px,py,pz, vx,vy,vz, d1,d2), u = (ax,ay,az, sk_d, sk_s)
  A = [[I, ts I, 0],[0, I, 0],[0,0,0]],  B = [[ts^2/2 I, 0],[ts I, 0],[0, I2]]
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from intent_mpc_torch.utils.config import PlannerConfig
from intent_mpc_torch.utils.device import constant

INF = math.inf
NX = 8
NU = 5


class ConVec(NamedTuple):
    """A vector in constraint space, stored per group."""

    eq: torch.Tensor   # (..., H, 8)
    sb: torch.Tensor   # (..., H, 8)
    cb: torch.Tensor   # (..., W, 5)
    obs: torch.Tensor  # (..., W, K)

    def __add__(self, o):
        return ConVec(*(a + b for a, b in zip(self, o)))

    def __sub__(self, o):
        return ConVec(*(a - b for a, b in zip(self, o)))

    def scale(self, s):
        return ConVec(*(a * b for a, b in zip(self, s)))

    def map(self, f, *others):
        return ConVec(*(f(a, *bs) for a, *bs in zip(self, *others)))

    def inf_norm(self):
        """Max |.| over each problem's rows: (...)."""
        return torch.stack([torch.amax(torch.abs(g), dim=(-2, -1))
                            for g in self], dim=0).amax(dim=0)


class QPData(NamedTuple):
    """Per-candidate QP data, fixed shapes with leading batch axes."""

    q: torch.Tensor          # (..., n) linear cost
    l: ConVec                # lower bounds
    u: ConVec                # upper bounds
    G: torch.Tensor          # (..., W, K, 3) obstacle constraint gradients
    obs_dyn: torch.Tensor    # (..., W, K) 1.0 if row uses dynamic slack u[3], else u[4]
    obs_active: torch.Tensor  # (..., W, K) 1.0 for live obstacle rows
    obs_slack: torch.Tensor  # (..., W, K) 1.0 if the row has a slack column


def dynamics_matrices(ts: float, dtype=torch.float32, device="cpu"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (8,8), B (8,5) per setDynamicsMatrices (mpcPlanner.cpp:891-901),
    rounded in `dtype` in the reference's order. Cached per device; do not
    modify in place."""
    A = torch.zeros((NX, NX), dtype=dtype)
    eye3 = torch.eye(3, dtype=dtype)
    A[0:3, 0:3] = eye3
    A[0:3, 3:6] = eye3 * ts
    A[3:6, 3:6] = eye3
    B = torch.zeros((NX, NU), dtype=dtype)
    B[0:3, 0:3] = eye3 * 0.5 * ts * ts
    B[3:6, 0:3] = eye3 * ts
    B[6:8, 3:5] = torch.eye(2, dtype=dtype)
    return (constant(tuple(map(tuple, A.tolist())), device, dtype),
            constant(tuple(map(tuple, B.tolist())), device, dtype))


def cost_diagonals(cfg: PlannerConfig, device="cpu"):
    """Q (8,), R (5,) diagonals per setWeightMatrices (mpcPlanner.cpp:925-931)."""
    Q = constant(tuple([cfg.position_weight] * 3 + [cfg.velocity_weight] * 3
                       + list(cfg.dummy_state_weights)), device)
    R = constant(tuple([cfg.acceleration_weight] * 3
                       + list(cfg.slack_control_weights)), device)
    return Q, R


def hessian_diag(cfg: PlannerConfig, device="cpu") -> torch.Tensor:
    """Block-diagonal Hessian is fully diagonal (castMPCToQPHessian)."""
    Q = (cfg.position_weight,) * 3 + (cfg.velocity_weight,) * 3 \
        + tuple(cfg.dummy_state_weights)
    R = (cfg.acceleration_weight,) * 3 + tuple(cfg.slack_control_weights)
    return constant(Q * cfg.horizon + R * cfg.mpc_window, device)


def state_control_bounds(cfg: PlannerConfig, device="cpu"):
    """Per setInequalityConstraints (mpcPlanner.cpp:904-921)."""
    x_min = constant((-INF, cfg.y_range[0], cfg.z_range[0],
                      -cfg.max_vel, -cfg.max_vel, -cfg.max_vel, -INF, -INF),
                     device)
    x_max = constant((INF, cfg.y_range[1], cfg.z_range[1],
                      cfg.max_vel, cfg.max_vel, cfg.max_vel, INF, INF), device)
    skd = 1.0 - (1.0 - cfg.dynamic_slack) ** 2
    sks = 1.0 - (1.0 - cfg.static_slack) ** 2
    u_min = constant((-cfg.max_acc,) * 3 + (0.0, 0.0), device)
    u_max = constant((cfg.max_acc,) * 3 + (skd, sks), device)
    return x_min, x_max, u_min, u_max


def split_z(z: torch.Tensor, cfg: PlannerConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    H, W = cfg.horizon, cfg.mpc_window
    lead = z.shape[:-1]
    X = z[..., : NX * H].reshape(lead + (H, NX))
    U = z[..., NX * H:].reshape(lead + (W, NU))
    return X, U


def merge_z(X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    return torch.cat([X.flatten(-2), U.flatten(-2)], dim=-1)


def _wd(G: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """sum_d G[..., w, k, d] p[..., w, d] -> (..., W, K)."""
    return torch.matmul(G, p[..., :, :, None])[..., 0]


def _dw(w: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """sum_k w[..., w, k] G[..., w, k, d] -> (..., W, 3)."""
    return torch.matmul(w[..., :, None, :], G)[..., 0, :]


def linearize_obstacles(oxyz, osize, yaw, c):
    """Linearized rotated-ellipsoid keep-out constraints.

    f(p) = ((dx cy + dy sy)/sx)^2 + ((-dx sy + dy cy)/sy_ax)^2 + (dz/sz)^2 >= 1
    linearized at c (castMPCToQPConstraintMatrix / -Vectors,
    mpcPlanner.cpp:1040-1071, 1119-1139).

    oxyz/osize (..., W, K, 3), yaw (..., W, K), c (..., W, 3).
    Returns G (..., W, K, 3) gradients, lo (..., W, K) = 1 - f(c) + G.c
    """
    d = c[..., :, None, :] - oxyz
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    e1 = (d[..., 0] * cy + d[..., 1] * sy) / osize[..., 0] ** 2
    e2 = (-d[..., 0] * sy + d[..., 1] * cy) / osize[..., 1] ** 2
    gx = 2.0 * (e1 * cy - e2 * sy)
    gy = 2.0 * (e1 * sy + e2 * cy)
    gz = 2.0 * d[..., 2] / osize[..., 2] ** 2
    G = torch.stack([gx, gy, gz], dim=-1)
    f = (e1 * (d[..., 0] * cy + d[..., 1] * sy)
         + e2 * (-d[..., 0] * sy + d[..., 1] * cy)
         + (d[..., 2] / osize[..., 2]) ** 2)
    lo = 1.0 - f + _wd(G, c)
    return G, lo


def build_qp(cfg: PlannerConfig, x0, xref, oxyz, osize, yaw, obs_dyn,
             obs_active, lin_states, fov_rows=None) -> QPData:
    """Assemble the QP of one candidate per batch entry.

      x0 (..., 6) current [pos, vel]; xref (..., H, 3) reference positions
      (getXRef, mpcPlanner.cpp:968-981); oxyz/osize (..., W, K, 3)
      obstacle centers and semi-axes; yaw, obs_dyn, obs_active (..., W, K);
      lin_states (..., W, 3) linearization positions.
      fov_rows: optional (half_max, half_min), each (..., 3) as (a, b, c),
      the camera wedge of updateFovParam (mpcPlanner.cpp:274-295): the
      last two obstacle slots become a1 x + b1 y <= c1 and
      a2 x + b2 y >= c2 on every step, live, with no slack column. The
      caller sizes K with these two spare slots.
    Leading axes of the inputs must broadcast to one batch shape.
    """
    H, W, K = cfg.horizon, cfg.mpc_window, oxyz.shape[-2]
    dev, dt = oxyz.device, oxyz.dtype
    lead = torch.broadcast_shapes(x0.shape[:-1], xref.shape[:-2],
                                  oxyz.shape[:-3], obs_active.shape[:-2],
                                  lin_states.shape[:-2])
    Q, _ = cost_diagonals(cfg, dev)

    # gradient: q_state[i] = -Q * xref8[i]; controls part zero (mpcPlanner.cpp:952-966)
    xref8 = torch.cat([xref, torch.zeros(xref.shape[:-1] + (NX - 3,),
                                         dtype=dt, device=dev)], dim=-1)
    qx = (-(Q * xref8)).expand(lead + (H, NX)).flatten(-2)
    q = torch.cat([qx, torch.zeros(lead + (W * NU,), dtype=dt, device=dev)],
                  dim=-1)

    # equality rows: l = u = [-x0_full, 0, ...] (castMPCToQPConstraintVectors:1082-1086)
    beq = torch.zeros(lead + (H, NX), dtype=dt, device=dev)
    beq[..., 0, 0:6] = -x0

    x_min, x_max, u_min, u_max = state_control_bounds(cfg, dev)
    G, lo = linearize_obstacles(oxyz, osize, yaw, lin_states)
    # inactive slots: zero gradient, (-inf, inf) bounds -> loose rows
    G = (G * obs_active[..., None]).expand(lead + (W, K, 3)).contiguous()
    lo = torch.where(obs_active > 0, lo, -INF).expand(lead + (W, K)).contiguous()
    hi = torch.full(lead + (W, K), INF, dtype=dt, device=dev)
    slack_mask = torch.ones(lead + (W, K), dtype=dt, device=dev)
    active = obs_active.expand(lead + (W, K)).contiguous()
    if fov_rows is not None:
        half_max, half_min = fov_rows
        G[..., K - 2, 0] = half_max[..., 0:1]
        G[..., K - 2, 1] = half_max[..., 1:2]
        G[..., K - 1, 0] = half_min[..., 0:1]
        G[..., K - 1, 1] = half_min[..., 1:2]
        lo[..., K - 2] = -INF
        lo[..., K - 1] = half_min[..., 2:3]
        hi[..., K - 2] = half_max[..., 2:3]
        active[..., K - 2:] = 1.0
        slack_mask[..., K - 2:] = 0.0

    l = ConVec(eq=beq, sb=x_min.expand(lead + (H, NX)).contiguous(),
               cb=u_min.expand(lead + (W, NU)).contiguous(), obs=lo)
    u = ConVec(eq=beq.clone(), sb=x_max.expand(lead + (H, NX)).contiguous(),
               cb=u_max.expand(lead + (W, NU)).contiguous(), obs=hi)
    return QPData(q=q, l=l, u=u, G=G,
                  obs_dyn=(obs_dyn * active).contiguous(),
                  obs_active=active, obs_slack=slack_mask)


# ---------------------------------------------------------------------------
# Structured matvecs
# ---------------------------------------------------------------------------

def _eq_rows(cfg: PlannerConfig, X: torch.Tensor, U: torch.Tensor
             ) -> torch.Tensor:
    """The dynamics rows of A z: eq[0] = -x_0 ; eq[i] = A x_{i-1} + B u_{i-1} - x_i."""
    ts = cfg.ts
    p, v, d = X[..., 0:3], X[..., 3:6], X[..., 6:8]
    a, s = U[..., 0:3], U[..., 3:5]
    nxt_p = p[..., :-1, :] + ts * v[..., :-1, :] + 0.5 * ts * ts * a \
        - p[..., 1:, :]
    nxt_v = v[..., :-1, :] + ts * a - v[..., 1:, :]
    nxt_d = s - d[..., 1:, :]
    return torch.cat([-X[..., 0:1, :],
                      torch.cat([nxt_p, nxt_v, nxt_d], dim=-1)], dim=-2)


def a_matvec(cfg: PlannerConfig, qp: QPData, z: torch.Tensor) -> ConVec:
    """A @ z in constraint-group space (closed-form, no sparse matrix)."""
    X, U = split_z(z, cfg)
    slack = qp.obs_dyn * U[..., 3:4] + (1.0 - qp.obs_dyn) * U[..., 4:5]
    slack = slack * qp.obs_slack
    # obs row (i,k): G . p_i - s_i  (state index i, 0..W-1; mpcPlanner.cpp:1061-1069)
    obs = _wd(qp.G, X[..., :-1, 0:3]) - slack * qp.obs_active
    return ConVec(eq=_eq_rows(cfg, X, U), sb=X, cb=U, obs=obs)


def at_matvec(cfg: PlannerConfig, qp: QPData, w: ConVec) -> torch.Tensor:
    """A^T @ w back to decision space."""
    ts = cfg.ts
    weq = w.eq
    wn = weq[..., 1:, :]                                   # (..., W, 8)
    zeros2 = torch.zeros_like(wn[..., 0:2])
    # A^T contribution to x_{i-1} from row i (i>=1)
    atw = torch.cat([wn[..., 0:3], ts * wn[..., 0:3] + wn[..., 3:6], zeros2],
                    dim=-1)
    # x rows: -weq[0] on x_0; atw on x_0..x_{W-1}; -wn on x_1..x_W
    first = -weq[..., 0:1, :]
    Xg = torch.cat([first + atw[..., 0:1, :],
                    atw[..., 1:, :] - wn[..., :-1, :],
                    -wn[..., -1:, :]], dim=-2)
    btw = torch.cat([0.5 * ts * ts * wn[..., 0:3] + ts * wn[..., 3:6],
                     wn[..., 6:8]], dim=-1)
    Ug = btw

    # bound rows (identity)
    Xg = Xg + w.sb
    Ug = Ug + w.cb

    # obstacle rows
    wobs = w.obs * qp.obs_active                           # (..., W, K)
    gp = _dw(wobs, qp.G)                                   # (..., W, 3)
    Xg = torch.cat([torch.cat([Xg[..., :-1, 0:3] + gp, Xg[..., :-1, 3:]],
                              dim=-1),
                    Xg[..., -1:, :]], dim=-2)
    ws = wobs * qp.obs_slack
    s3 = torch.sum(ws * qp.obs_dyn, dim=-1)
    s4 = torch.sum(ws * (1.0 - qp.obs_dyn), dim=-1)
    Ug = torch.cat([Ug[..., 0:3], (Ug[..., 3] - s3)[..., None],
                    (Ug[..., 4] - s4)[..., None]], dim=-1)
    return merge_z(Xg, Ug)


def rho_vec(cfg: PlannerConfig, qp: QPData, rho, rho_eq_scale: float,
            rho_min: float = 1e-6) -> ConVec:
    """Per-row ADMM penalty, mirroring OSQP's compute_rho_vec: equality
    rows (l==u) get rho*1e3; loose rows (both bounds infinite) get
    rho_min; the rest get rho. `rho` is a float or a tensor that
    broadcasts against the QP's batch shape."""
    H, W = cfg.horizon, cfg.mpc_window
    lead = qp.q.shape[:-1]
    K = qp.G.shape[-2]
    dev, dt = qp.q.device, qp.q.dtype
    rho_t = rho if torch.is_tensor(rho) else torch.full((), rho, dtype=dt,
                                                         device=dev)
    if rho_t.dim() > 0:
        rho_t = rho_t[..., None, None]
    one = torch.ones((), dtype=dt, device=dev)
    eq = (rho_t * rho_eq_scale) * torch.ones(lead + (H, NX), dtype=dt, device=dev)
    loose_sb = torch.isinf(qp.l.sb) & torch.isinf(qp.u.sb)
    sb = torch.where(loose_sb, rho_min * one, rho_t * one)
    cb = rho_t * torch.ones(lead + (W, NU), dtype=dt, device=dev)
    obs = torch.where(qp.obs_active > 0, rho_t * one, rho_min * one)
    return ConVec(eq=eq, sb=sb.expand(lead + (H, NX)).contiguous(), cb=cb,
                  obs=obs.expand(lead + (W, K)).contiguous())


# ---------------------------------------------------------------------------
# Structured row/column abs-max norms (for OSQP-style Ruiz equilibration)
# ---------------------------------------------------------------------------

def a_rowmax(cfg: PlannerConfig, qp: QPData, D: torch.Tensor) -> ConVec:
    """Per-row max_j |A_ij| * D_j of the column-scaled constraint matrix."""
    A, B = dynamics_matrices(cfg.ts, D.dtype, D.device)
    Dx, Du = split_z(D, cfg)
    r0 = Dx[..., 0:1, :]                                   # eq row 0: -1 on x_0
    # eq rows i>=1: -1 on x_i, A on x_{i-1}, B on u_{i-1}
    mA = torch.amax(torch.abs(A) * Dx[..., :-1, None, :], dim=-1)   # (..., W, 8)
    mB = torch.amax(torch.abs(B) * Du[..., :, None, :], dim=-1)     # (..., W, 8)
    ri = torch.maximum(Dx[..., 1:, :], torch.maximum(mA, mB))
    eq = torch.cat([r0, ri], dim=-2)
    gmax = torch.amax(torch.abs(qp.G) * Dx[..., :-1, None, 0:3], dim=-1)
    du_slack = (qp.obs_dyn * Du[..., 3:4]
                + (1.0 - qp.obs_dyn) * Du[..., 4:5]) * qp.obs_slack
    obs = torch.maximum(gmax, du_slack) * qp.obs_active
    return ConVec(eq=eq, sb=Dx, cb=Du, obs=obs)


def a_colmax(cfg: PlannerConfig, qp: QPData, E: ConVec) -> torch.Tensor:
    """Per-column max_i E_i |A_ij| of the row-scaled constraint matrix."""
    A, B = dynamics_matrices(cfg.ts, E.eq.dtype, E.eq.device)
    cx = E.eq                                                       # -1 entries
    viaA = torch.amax(torch.abs(A) * E.eq[..., 1:, :, None], dim=-2)  # (..., W, 8)
    cx = torch.cat([torch.maximum(cx[..., :-1, :], viaA), cx[..., -1:, :]],
                   dim=-2)
    cx = torch.maximum(cx, E.sb)
    eobs = E.obs * qp.obs_active                                    # (..., W, K)
    gcol = torch.amax(torch.abs(qp.G) * eobs[..., None], dim=-2)    # (..., W, 3)
    cx = torch.cat([torch.cat([torch.maximum(cx[..., :-1, 0:3], gcol),
                               cx[..., :-1, 3:]], dim=-1),
                    cx[..., -1:, :]], dim=-2)
    cu = torch.amax(torch.abs(B) * E.eq[..., 1:, :, None], dim=-2)  # (..., W, 5)
    cu = torch.maximum(cu, E.cb)
    es = eobs * qp.obs_slack
    c3 = torch.maximum(cu[..., 3], torch.amax(es * qp.obs_dyn, dim=-1))
    c4 = torch.maximum(cu[..., 4], torch.amax(es * (1.0 - qp.obs_dyn), dim=-1))
    cu = torch.cat([cu[..., 0:3], c3[..., None], c4[..., None]], dim=-1)
    return merge_z(cx, cu)


# ---------------------------------------------------------------------------
# Dense normal-matrix assembly (the dense factor and the dense-A path,
# ops/admm.py): M = diag(h) + sigma I + A^T diag(rho) A
# ---------------------------------------------------------------------------

def assemble_normal_matrix(cfg: PlannerConfig, qp: QPData, hdiag, sigma: float,
                           rho: ConVec, col_scale=None) -> torch.Tensor:
    """Build M (..., n, n) from closed-form block contributions.

    With `col_scale` D given, returns diag(hdiag + sigma) + D (A^T rho A) D."""
    ts = cfg.ts
    H, W = cfg.horizon, cfg.mpc_window
    n = cfg.num_vars
    dev, dt = qp.q.device, qp.q.dtype
    lead = qp.q.shape[:-1]
    A, B = dynamics_matrices(ts, dt, dev)
    M = torch.zeros(lead + (n, n), dtype=dt, device=dev)
    idx = torch.arange(n, device=dev)

    diag_add = torch.cat([rho.sb.flatten(-2), rho.cb.flatten(-2)], dim=-1)
    M[..., idx, idx] += diag_add
    ax8 = torch.arange(NX, device=dev)
    M[..., ax8, ax8] += rho.eq[..., 0, :]

    r = rho.eq[..., 1:, :]                                  # (..., W, 8)
    AtrA = torch.einsum("ja,...wj,jb->...wab", A, r, A)
    AtrB = torch.einsum("ja,...wj,jb->...wab", A, r, B)
    BtrB = torch.einsum("ja,...wj,jb->...wab", B, r, B)
    AtrI = torch.einsum("ja,...wj->...waj", A, r)
    BtrI = torch.einsum("ja,...wj->...waj", B, r)

    wi = torch.arange(W, device=dev)
    xi = NX * wi
    xo = NX * (wi + 1)
    ui = NX * H + NU * wi

    def scat(rows0, cols0, blocks, nr, nc):
        rr = rows0[:, None, None] + torch.arange(nr, device=dev)[None, :, None]
        cc = cols0[:, None, None] + torch.arange(nc, device=dev)[None, None, :]
        M[..., rr, cc] += blocks

    scat(xi, xi, AtrA, NX, NX)
    scat(xi, ui, AtrB, NX, NU)
    scat(ui, xi, AtrB.transpose(-1, -2), NU, NX)
    scat(ui, ui, BtrB, NU, NU)
    scat(xi, xo, -AtrI, NX, NX)
    scat(xo, xi, -AtrI.transpose(-1, -2), NX, NX)
    scat(ui, xo, -BtrI, NU, NX)
    scat(xo, ui, -BtrI.transpose(-1, -2), NX, NU)
    rr = xo[:, None] + ax8[None, :]
    M[..., rr, rr] += r

    ro = rho.obs * qp.obs_active
    Gw = qp.G
    PP = torch.einsum("...wk,...wka,...wkb->...wab", ro, Gw, Gw)
    scat(xi, xi, PP, 3, 3)
    rs = ro * qp.obs_slack
    sd = torch.sum(rs * qp.obs_dyn, dim=-1)
    ss = torch.sum(rs * (1.0 - qp.obs_dyn), dim=-1)
    M[..., ui + 3, ui + 3] += sd
    M[..., ui + 4, ui + 4] += ss
    cd = -torch.einsum("...wk,...wka->...wa", rs * qp.obs_dyn, Gw)
    cs = -torch.einsum("...wk,...wka->...wa", rs * (1.0 - qp.obs_dyn), Gw)
    rr3 = xi[:, None] + torch.arange(3, device=dev)[None, :]
    M[..., rr3, (ui + 3)[:, None]] += cd
    M[..., (ui + 3)[:, None], rr3] += cd
    M[..., rr3, (ui + 4)[:, None]] += cs
    M[..., (ui + 4)[:, None], rr3] += cs

    if col_scale is not None:
        M = col_scale[..., :, None] * M * col_scale[..., None, :]
    return M + torch.diag_embed(hdiag + sigma)


# ---------------------------------------------------------------------------
# Dense A and the flat constraint order [eq | sb | cb | obs]
# ---------------------------------------------------------------------------

def _linear_rows(cfg: PlannerConfig, dev, dt) -> torch.Tensor:
    """The eq, sb and cb rows of A (16H + 5W, n): a_matvec's closed form
    on the identity. They do not depend on the QP."""
    X, U = split_z(torch.eye(cfg.num_vars, dtype=dt, device=dev), cfg)
    return torch.cat([_eq_rows(cfg, X, U).flatten(-2), X.flatten(-2),
                      U.flatten(-2)], dim=-1).t()


def dense_a_nnz_max(cfg: PlannerConfig, K: int) -> int:
    """The most nonzeros dense_a_matrix can have for K obstacle slots: the
    linear rows' own (fixed by the config) plus 5 per obstacle row (its 3
    gradient entries on the step's position and its 2 slack columns),
    whatever the QP's values and activity."""
    lin = int((_linear_rows(cfg, "cpu", torch.float32) != 0).sum())
    return lin + 5 * cfg.mpc_window * K


def dense_a_matrix(cfg: PlannerConfig, qp: QPData) -> torch.Tensor:
    """Materialize the dense constraint matrix A (..., m, n), rows in
    con_to_flat order.

    The JAX version applies a_matvec to every unit vector. Here the
    eq/sb/cb rows come from a_matvec's closed form on the identity, and
    the obstacle rows (the only ones that depend on the QP) get their
    nonzeros scattered in place: G on the step's position columns and
    the negated slack mix on its two slack controls. That gives the same
    entries without the (..., n, W, K) intermediate."""
    H, W = cfg.horizon, cfg.mpc_window
    K = qp.G.shape[-2]
    n = cfg.num_vars
    lead = qp.q.shape[:-1]
    dev, dt = qp.q.device, qp.q.dtype
    top = _linear_rows(cfg, dev, dt)                        # (16H + 5W, n)
    m_lin = top.shape[0]
    m = m_lin + W * K
    A = torch.zeros(lead + (m, n), dtype=dt, device=dev)
    A[..., :m_lin, :] = top
    flat = A.view(lead + (m * n,))
    w = torch.arange(W, device=dev)[:, None]
    row = (m_lin + w * K + torch.arange(K, device=dev)[None, :]) * n  # (W, K)
    for d in range(3):
        flat[..., (row + NX * w + d).flatten()] = qp.G[..., d].flatten(-2)
    u3 = -(qp.obs_dyn * qp.obs_slack * qp.obs_active)
    u4 = -((1.0 - qp.obs_dyn) * qp.obs_slack * qp.obs_active)
    ucol = row + NX * H + NU * w
    flat[..., (ucol + 3).flatten()] = u3.flatten(-2)
    flat[..., (ucol + 4).flatten()] = u4.flatten(-2)
    return A


def con_to_flat(w: ConVec) -> torch.Tensor:
    """(..., m) in the order eq, sb, cb, obs, each group row-major."""
    return torch.cat([g.flatten(-2) for g in w], dim=-1)


def flat_to_con(v: torch.Tensor, cfg: PlannerConfig, K: int) -> ConVec:
    H, W = cfg.horizon, cfg.mpc_window
    lead = v.shape[:-1]
    s0, s1, s2 = NX * H, 2 * NX * H, 2 * NX * H + NU * W
    return ConVec(eq=v[..., :s0].reshape(lead + (H, NX)),
                  sb=v[..., s0:s1].reshape(lead + (H, NX)),
                  cb=v[..., s1:s2].reshape(lead + (W, NU)),
                  obs=v[..., s2:].reshape(lead + (W, K)))
