"""Float64 CPU oracle: literal reimplementation of the reference QP cast
(the port's own copy of the JAX package's oracle/numpy_ref.py, operation
for operation, so that both give bit-equal results).

This module deliberately mirrors the reference's sparse-insert construction
(trajectory_planner/mpcPlanner.cpp:891-1146) with plain numpy loops in
double precision, and solves the result with a dense ADMM + active-set
polish. It shares NO code with the port's structured path (ops/qp.py,
ops/admm.py), so it serves as an independent parity check (BASELINE
north-star: control parity within 1e-3). It imports numpy and scipy only."""

from __future__ import annotations

import numpy as np

NX = 8
NU = 5
INF = np.inf


def dynamics_matrices(ts: float):
    A = np.zeros((NX, NX))
    A[0:3, 0:3] = np.eye(3)
    A[0:3, 3:6] = np.eye(3) * ts
    A[3:6, 3:6] = np.eye(3)
    B = np.zeros((NX, NU))
    B[0:3, 0:3] = np.eye(3) * 0.5 * ts ** 2
    B[3:6, 0:3] = np.eye(3) * ts
    B[6:8, 3:5] = np.eye(2)
    return A, B


def build_reference_qp(cfg, x0, xref, oxyz, osize, yaw, is_dynamic, lin_states):
    """Construct (P, q, A, l, u) exactly as mpcPlanner::solveTraj does.

    Row order: equality block (H*8), state bounds (H*8), control bounds
    (W*5), obstacle rows (W*K with k fastest? reference uses row i*numObs+j
    -> step-major). cfg is a PlannerConfig.

    Args are numpy arrays: x0 (6,), xref (H,3), oxyz/osize (W,K,3), yaw (W,K),
    is_dynamic (W,K) bool, lin_states (W,3).
    """
    H = cfg.horizon
    W = H - 1
    K = oxyz.shape[1]
    n = NX * H + NU * W
    m = 2 * NX * H + NU * W + K * W

    Amat, Bmat = dynamics_matrices(cfg.ts)

    Qd = np.array([cfg.position_weight] * 3 + [cfg.velocity_weight] * 3
                  + list(cfg.dummy_state_weights))
    Rd = np.array([cfg.acceleration_weight] * 3 + list(cfg.slack_control_weights))
    P = np.zeros((n, n))
    for i in range(n):
        if i < NX * H:
            P[i, i] = Qd[i % NX]
        else:
            P[i, i] = Rd[(i - NX * H) % NU]

    q = np.zeros(n)
    for i in range(H):
        ref = np.zeros(NX)
        ref[0:3] = xref[i]
        q[i * NX:(i + 1) * NX] = -(Qd * ref)

    A = np.zeros((m, n))
    # equality rows (castMPCToQPConstraintMatrix:994-1020)
    for i in range(NX * H):
        A[i, i] = -1.0
    for i in range(W):
        A[NX * (i + 1):NX * (i + 2), NX * i:NX * (i + 1)] += Amat
        A[NX * (i + 1):NX * (i + 2), NX * H + NU * i:NX * H + NU * (i + 1)] += Bmat
    # bound rows (":1022-1026")
    for i in range(NX * H + NU * W):
        A[i + NX * H, i] = 1.0
    # obstacle rows (":1040-1071")
    base = 2 * NX * H + NU * W
    for i in range(W):
        cx, cy, cz = lin_states[i]
        for j in range(K):
            ox, oy, oz = oxyz[i, j]
            sx, sy, sz = osize[i, j]
            yw = yaw[i, j]
            e1 = ((cx - ox) * np.cos(yw) + (cy - oy) * np.sin(yw)) / sx ** 2
            e2 = (-(cx - ox) * np.sin(yw) + (cy - oy) * np.cos(yw)) / sy ** 2
            fxx = 2 * e1 * np.cos(yw) + 2 * e2 * (-np.sin(yw))
            fyy = 2 * e1 * np.sin(yw) + 2 * e2 * np.cos(yw)
            fzz = 2 * (cz - oz) / sz ** 2
            r = base + i * K + j
            A[r, NX * i + 0] = fxx
            A[r, NX * i + 1] = fyy
            A[r, NX * i + 2] = fzz
            if is_dynamic[i, j]:
                A[r, NX * H + NU * i + 3] = -1.0
            else:
                A[r, NX * H + NU * i + 4] = -1.0

    # bounds (castMPCToQPConstraintVectors)
    l = np.zeros(m)
    u = np.zeros(m)
    x0_full = np.zeros(NX)
    x0_full[0:6] = x0
    l[0:NX] = -x0_full
    u[0:NX] = -x0_full

    x_min = np.array([-INF, cfg.y_range[0], cfg.z_range[0],
                      -cfg.max_vel, -cfg.max_vel, -cfg.max_vel, -INF, -INF])
    x_max = np.array([INF, cfg.y_range[1], cfg.z_range[1],
                      cfg.max_vel, cfg.max_vel, cfg.max_vel, INF, INF])
    skd = 1.0 - (1.0 - cfg.dynamic_slack) ** 2
    sks = 1.0 - (1.0 - cfg.static_slack) ** 2
    u_min = np.array([-cfg.max_acc] * 3 + [0.0, 0.0])
    u_max = np.array([cfg.max_acc] * 3 + [skd, sks])
    for i in range(H):
        l[NX * H + NX * i:NX * H + NX * (i + 1)] = x_min
        u[NX * H + NX * i:NX * H + NX * (i + 1)] = x_max
    cb0 = 2 * NX * H
    for i in range(W):
        l[cb0 + NU * i:cb0 + NU * (i + 1)] = u_min
        u[cb0 + NU * i:cb0 + NU * (i + 1)] = u_max
    for i in range(W):
        cx, cy, cz = lin_states[i]
        for j in range(K):
            ox, oy, oz = oxyz[i, j]
            sx, sy, sz = osize[i, j]
            yw = yaw[i, j]
            t1 = (cx - ox) * np.cos(yw) + (cy - oy) * np.sin(yw)
            t2 = -(cx - ox) * np.sin(yw) + (cy - oy) * np.cos(yw)
            fxyz = t1 ** 2 / sx ** 2 + t2 ** 2 / sy ** 2 + (cz - oz) ** 2 / sz ** 2
            fxx = 2 * t1 / sx ** 2 * np.cos(yw) + 2 * t2 / sy ** 2 * (-np.sin(yw))
            fyy = 2 * t1 / sx ** 2 * np.sin(yw) + 2 * t2 / sy ** 2 * np.cos(yw)
            fzz = 2 * (cz - oz) / sz ** 2
            r = base + i * K + j
            l[r] = 1.0 - fxyz + fxx * cx + fyy * cy + fzz * cz
            u[r] = INF
    return P, q, A, l, u


def solve_qp_dense(P, q, A, l, u, rho=0.1, sigma=1e-6, alpha=1.6,
                   max_iter=4000, eps=1e-9, polish=True, scaling=10,
                   adapt_interval=25):
    """Dense f64 OSQP-style solver: Ruiz equilibration, per-row rho with
    adaptation, over-relaxed ADMM, active-set polish."""
    n = P.shape[0]
    m = A.shape[0]

    # ---- Ruiz equilibration + cost scaling (OSQP scaling.c) ----
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    Ph, qh, Ah = P.copy(), q.copy(), A.copy()
    for _ in range(scaling):
        cn = np.maximum(np.abs(Ph).max(axis=0), np.abs(Ah).max(axis=0)
                        if m else 0.0)
        dd = 1.0 / np.sqrt(np.where(cn > 1e-12, cn, 1.0))
        Ph = dd[:, None] * Ph * dd[None, :]
        qh = dd * qh
        Ah = Ah * dd[None, :]
        D *= dd
        rn = np.abs(Ah).max(axis=1)
        de = 1.0 / np.sqrt(np.where(rn > 1e-12, rn, 1.0))
        Ah = de[:, None] * Ah
        E *= de
        pcol = np.abs(Ph).max(axis=0).mean()
        qinf = np.abs(qh).max()
        g = 1.0 / max(pcol, qinf) if max(pcol, qinf) > 1e-12 else 1.0
        Ph *= g
        qh *= g
        c *= g
    lh, uh = E * l, E * u

    eqr = np.isclose(lh, uh)
    loose = np.isneginf(lh) & np.isposinf(uh)

    def mk_rho(r):
        rv = np.full(m, r)
        rv[eqr] = np.clip(r * 1e3, 1e-6, 1e6)
        rv[loose] = 1e-6
        return rv

    import scipy.linalg as sla

    def refac(rv):
        M = Ph + sigma * np.eye(n) + Ah.T @ (rv[:, None] * Ah)
        return np.linalg.cholesky(M)

    r = rho
    rho_v = mk_rho(r)
    Mf = refac(rho_v)

    def msolve(b, Mf):
        w = sla.solve_triangular(Mf, b, lower=True)
        return sla.solve_triangular(Mf.T, w, lower=False)

    x = np.zeros(n)
    z = Ah @ x
    y = np.zeros(m)
    for it in range(max_iter):
        rhs = sigma * x - qh + Ah.T @ (rho_v * z - y)
        x_t = msolve(rhs, Mf)
        z_t = Ah @ x_t
        x = alpha * x_t + (1 - alpha) * x
        z_relax = alpha * z_t + (1 - alpha) * z
        z_new = np.clip(z_relax + y / rho_v, lh, uh)
        y = y + rho_v * (z_relax - z_new)
        z = z_new
        if (it + 1) % adapt_interval == 0:
            ax = Ah @ x
            prim = np.max(np.abs(ax - z)) if m else 0.0
            dual = np.max(np.abs(Ph @ x + qh + Ah.T @ y))
            if prim < eps and dual < eps:
                break
            prs = prim / max(np.abs(ax).max(), np.abs(z).max(), 1e-10)
            drs = dual / max(np.abs(Ph @ x).max(), np.abs(Ah.T @ y).max(),
                             np.abs(qh).max(), 1e-10)
            ratio = np.sqrt(prs / max(drs, 1e-12))
            if ratio > 5.0 or ratio < 0.2:
                r = np.clip(r * ratio, 1e-6, 1e6)
                rho_v = mk_rho(r)
                Mf = refac(rho_v)

    # unscale
    x = D * x
    y = (E * y) / c

    if polish:
        xp = _polish(P, q, A, l, u, x, y, np.full(m, r))
        if xp is not None:
            x = xp
    return x, y


def _polish(P, q, A, l, u, x, y, rho_vec, tol=1e-7):
    """OSQP-style polish: solve the KKT system restricted to active rows."""
    z = A @ x
    low_active = (y < -tol) | (np.abs(z - l) < tol * (1 + np.abs(l.clip(-1e10, 1e10))))
    upp_active = (y > tol) | (np.abs(z - u) < tol * (1 + np.abs(u.clip(-1e10, 1e10))))
    low_active &= np.isfinite(l)
    upp_active &= np.isfinite(u)
    eq = np.isclose(l, u)
    act = low_active | upp_active | eq
    Aa = A[act]
    ba = np.where(upp_active & ~eq, u, l)[act]
    na, n = Aa.shape[0], P.shape[0]
    if na == 0:
        try:
            return np.linalg.solve(P + 1e-12 * np.eye(n), -q)
        except np.linalg.LinAlgError:
            return None
    KKT = np.block([[P, Aa.T], [Aa, np.zeros((na, na))]])
    rhs = np.concatenate([-q, ba])
    # regularized solve + iterative refinement (OSQP polish approach)
    reg = 1e-9
    KKTr = KKT + reg * np.diag(np.concatenate([np.ones(n), -np.ones(na)]))
    try:
        sol = np.linalg.solve(KKTr, rhs)
        for _ in range(3):
            r = rhs - KKT @ sol
            sol = sol + np.linalg.solve(KKTr, r)
    except np.linalg.LinAlgError:
        return None
    xp = sol[:n]
    # accept polish only if it does not violate inactive constraints
    zp = A @ xp
    if np.all(zp >= l - 1e-6) and np.all(zp <= u + 1e-6):
        return xp
    return None
