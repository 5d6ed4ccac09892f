"""One closed-loop cycle of S scenarios (mpcCB and its ten trajExeCB
ticks), stage by stage.

Every function takes the configuration file's dict and plain tensors of
the state it is handed (keys as `STATE_KEYS` names them) in the
precision's dtype, and returns plain tensors.

    detector_cycle  the world at the cycle start and at the history
                    ticks, the detector's finite differences and pushes
    query           the ground-truth detector's obstacle input of a cycle
    plan            predictor, the six candidate QPs of each scenario on
                    the cycle's obstacle input (a perception stage's:
                    histories, sizes and visibility, and any extra
                    rows), the shared factor, the solves, the scoring and
                    the chosen candidate
    factor          the shared factor of a cycle's candidate-mean QP
    ticks           the controller and the plant over the cycle's ticks,
                    with the collision monitor
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import predictor as predlib
from . import qp as qplib
from .solve import Precision, admm, inverse
from .world import cycle_time, f32, obstacle_state, tick_end

FORWARD, LEFT, RIGHT, STOP = 0, 1, 2, 3
COMBO_FIRST = (STOP, LEFT, RIGHT, FORWARD, LEFT, RIGHT)
COMBO_SECOND = (-1, -1, -1, -1, FORWARD, FORWARD)


def _rows(t, idx):
    S = t.shape[0]
    ar = torch.arange(S, device=t.device).reshape((S,) + (1,) * (idx.dim() - 1))
    return t[ar, idx]


# ---------------------------------------------------------------- detector

def fd_update(dc: dict, det: dict, pos_now, t) -> dict:
    """Finite-difference velocity and acceleration once fd_period has
    passed since the last update (the clock's float32 values)."""
    dT = np.float64(t) - det["last_fd_time"]
    due = dT >= float(f32(dc["fd_period"] - 1e-9))
    safe = torch.clamp(dT, min=1e-9)[:, None, None]
    vel = (pos_now - det["last_pos"]) / safe
    acc = (vel - det["vel"]) / safe
    d = due[:, None, None]
    out = dict(det)
    out.update(vel=torch.where(d, vel, det["vel"]), acc=torch.where(d, acc, det["acc"]),
               last_pos=torch.where(d, pos_now, det["last_pos"]),
               last_fd_time=torch.where(due, torch.full_like(dT, float(t)),
                                        det["last_fd_time"]))
    return out


def hist_push(det: dict, pos_now) -> dict:
    def push(h, row):
        return torch.cat([row[..., None, :], h[..., :-1, :]], dim=-2)
    out = dict(det)
    Hh = det["pos_hist"].shape[-2]
    out.update(pos_hist=push(det["pos_hist"], pos_now),
               vel_hist=push(det["vel_hist"], det["vel"]),
               acc_hist=push(det["acc_hist"], det["acc"]),
               hist_len=torch.clamp(det["hist_len"] + 1, max=Hh))
    return out


def detector_start(cfg: dict, sc: dict, det: dict, cycle: int) -> dict:
    """The cycle-start update: finite differences, then the push."""
    t0 = cycle_time(cfg, cycle)
    obs = obstacle_state(sc, float(t0))
    return hist_push(fd_update(cfg["detector"], det, obs, t0), obs)


def detector_cycle(cfg: dict, sc: dict, det: dict, cycle: int) -> dict:
    """The detector state after the whole cycle."""
    e = cfg["engine"]
    t0 = cycle_time(cfg, cycle)
    d = detector_start(cfg, sc, det, cycle)
    for k in range(e["ticks_per_cycle"]):
        if k in e["hist_ticks"] and k != 0:
            t = tick_end(cfg, t0, k)
            obs = obstacle_state(sc, float(t))
            d = hist_push(fd_update(cfg["detector"], d, obs, t), obs)
    return d


def query(dc: dict, det: dict, bbox, robot_pos):
    """Histories, robot-inflated sizes and the range gate."""
    robot = torch.tensor(dc["robot_size"], dtype=bbox.dtype, device=bbox.device)
    shape = det["pos_hist"].shape
    size = (bbox[..., None, :] + robot).expand(shape)
    vel = det["vel_hist"].clone()
    vel[..., 2] = 0.0
    d2 = torch.linalg.vector_norm(det["pos_hist"][..., 0, 0:2]
                                  - robot_pos[:, None, 0:2], dim=-1)
    visible = (d2 <= dc["sensor_range"]) & (det["hist_len"] > 0)[:, None]
    hl = det["hist_len"][:, None].expand(shape[:2])
    return det["pos_hist"], vel, size, hl, visible


# ---------------------------------------------------------------- planner

def reference_window(pl: dict, ref, pos, last_start):
    """getReferenceTraj: the nearest reference point within
    max_ref_forward_time ahead of the last start, then H points."""
    L = ref.shape[0]
    fwd = int(round(pl["max_ref_forward_time"] / pl["ts"]))
    idx = last_start.long()[:, None] + torch.arange(fwd, device=ref.device)
    pts = ref[torch.clamp(idx, 0, L - 1)]
    d = torch.linalg.vector_norm(pts - pos[:, None, :], dim=-1)
    d = torch.where(idx < L, d, torch.full_like(d, math.inf))
    start = last_start.long() + torch.argmin(d, dim=-1)
    ri = torch.clamp(start[:, None] + torch.arange(pl["horizon"], device=ref.device),
                     0, L - 1)
    return ref[ri], start


def candidates(pl: dict, ppos, psize, prob, visible, closest):
    """The six intent combinations' obstacle series: slot j < O holds
    obstacle j (the closest with the combination's first intent, the
    others with their most likely intent), slot O the closest's second
    intent (combinations 4 and 5). Returns pos/size (S, 6, H, O+1, 3)
    and activity (S, 6, O+1)."""
    S, O = ppos.shape[:2]
    H = pl["horizon"]
    dev = ppos.device
    am = torch.argmax(prob, dim=-1)
    base_p = torch.gather(ppos, 2, am[:, :, None, None, None].expand(
        S, O, 1, ppos.shape[3], 3))[:, :, 0, :H]
    base_s = torch.gather(psize, 2, am[:, :, None, None, None].expand(
        S, O, 1, psize.shape[3], 3))[:, :, 0, :H]
    cl_p = _rows(ppos, closest)[:, :, :H]                        # (S, 4, H, 3)
    cl_s = _rows(psize, closest)[:, :, :H]
    first = torch.tensor(COMBO_FIRST, device=dev)
    second = torch.tensor([max(c, 0) for c in COMBO_SECOND], device=dev)
    has2 = torch.tensor([c >= 0 for c in COMBO_SECOND], device=dev)
    is_cl = (torch.arange(O, device=dev)[None, :] == closest[:, None])[:, None, :, None, None]
    pos = torch.where(is_cl, cl_p[:, first][:, :, None], base_p[:, None])
    size = torch.where(is_cl, cl_s[:, first][:, :, None], base_s[:, None])
    pos = torch.cat([pos, cl_p[:, second][:, :, None]], dim=2)
    size = torch.cat([size, cl_s[:, second][:, :, None]], dim=2)
    act = torch.cat([visible[:, None, :].expand(S, 6, O),
                     (has2[None, :] & _rows(visible, closest)[:, None])[..., None]],
                    dim=-1)
    return pos.transpose(2, 3), size.transpose(2, 3), act.to(ppos.dtype)


def scores(pl: dict, X, prev, have_prev, xref, opos, osize, oact):
    """Consistency, detour and safety of each candidate (getTrajectoryScore)."""
    p = X[..., 0:3]
    nc = min(pl["consistency_steps"], pl["horizon"])
    cons = torch.clamp(torch.linalg.vector_norm(
        p[:, :, :nc] - prev[:, None, :nc, 0:3], dim=-1).mean(-1), min=0.1)
    cons = torch.where(have_prev[:, None], cons, torch.zeros_like(cons))
    det = torch.clamp(torch.linalg.vector_norm(p - xref[:, None], dim=-1).mean(-1),
                      min=0.1)
    pz = p.clone()
    pz[..., 2] = 0.0
    op = opos.clone()
    op[..., 2] = 0.0
    d = torch.linalg.vector_norm(pz[:, :, :, None, :] - op, dim=-1)
    ms = torch.sqrt(osize[..., 0] ** 2 + osize[..., 1] ** 2)
    w = (1.0 - torch.tanh(0.5493061443340549 / (pl["dynamic_safety_dist"] + ms) * d)) \
        * oact[:, :, None, :]
    safety = ((d * w).sum(-1) / torch.clamp(w.sum(-1), min=1e-12)).mean(-1)
    return cons, det, safety


def choose(cons, det, safety, weights, ok):
    """evaluateTraj: scores normalized by the accepted candidates'
    averages, weighted, the best accepted one."""
    okf = ok.to(cons.dtype)
    n = torch.clamp(okf.sum(-1), min=1.0)

    def avg(v):
        return ((v * okf).sum(-1) / n)[:, None]
    c = torch.where(cons > 0, avg(cons) / torch.clamp(cons, min=1e-12),
                    torch.zeros_like(cons))
    s = weights * (c + avg(det) / torch.clamp(det, min=1e-12)
                   + safety / torch.clamp(avg(safety), min=1e-12))
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    return torch.argmax(s, dim=-1)


def assemble(cfg: dict, ref, st: dict, obs: dict):
    """The cycle's predictions and six candidate QPs of each scenario
    from its obstacle input `obs`: pos_hist, vel_hist, size_hist (S, O,
    Hh, 3), hist_len and visible (S, O), and "extra", None or rows the
    same in every candidate (pos and size (S, C, 3) boxes, yaw (S, C),
    active (S, C) bool) with the static safety distance and the static
    slack, which count for the first-cycle test and stay out of the
    scoring. Returns a dict of the pieces the solve and the scoring
    read."""
    pl = cfg["planner"]
    H, W = pl["horizon"], pl["horizon"] - 1
    ph, vh, size_h = obs["pos_hist"], obs["vel_hist"], obs["size_hist"]
    hl, vis, extra = obs["hist_len"], obs["visible"], obs.get("extra")
    ppos, psize, prob = predlib.predict(cfg["predictor"], ph, vh, size_h, hl)
    S, O = ppos.shape[:2]
    pos = st["pos"]
    if O > pl["max_obstacles"]:
        d2 = torch.linalg.vector_norm(ppos[:, :, FORWARD, 0, 0:2] - pos[:, None, 0:2], dim=-1)
        score = torch.where(vis, -d2, torch.full_like(d2, -math.inf))
        order = torch.sort(score, dim=-1, descending=True, stable=True)[1]
        keep = order[:, :pl["max_obstacles"]]
        ppos, psize, prob, vis = (_rows(ppos, keep), _rows(psize, keep),
                                  _rows(prob, keep), _rows(vis, keep))
    xref, start = reference_window(pl, ref, pos, st["last_ref_start"])
    nominal = ppos[:, :, FORWARD, 0]
    X0 = st["states_sol"]
    use_d = (st["first_time"] | ~st["has_solution"])[:, None]
    dd = torch.linalg.vector_norm(pos[:, None, :] - nominal, dim=-1)
    p0, p1 = X0[:, 0, 0:3], X0[:, 1, 0:3]
    tdir = torch.atan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])
    odir = torch.atan2(nominal[..., 1] - p0[:, None, 1], nominal[..., 0] - p0[:, None, 0])
    dsol = torch.linalg.vector_norm(p0[:, None, :] - nominal, dim=-1)
    sc_d = torch.where(use_d, dd, dsol * (pl["direction_weight_a"]
                                          - torch.cos(tdir[:, None] - odir)))
    closest = torch.argmin(torch.where(vis, sc_d, torch.full_like(sc_d, math.inf)), -1)
    cpos, csize, cact = candidates(pl, ppos, psize, prob, vis, closest)
    pc = _rows(prob, closest)
    w6 = torch.stack([pc[:, STOP], pc[:, LEFT], pc[:, RIGHT], pc[:, FORWARD],
                      torch.maximum(pc[:, LEFT], pc[:, FORWARD]),
                      torch.maximum(pc[:, RIGHT], pc[:, FORWARD])], dim=-1)
    order = torch.argsort(w6, dim=-1, stable=True).flip(-1)
    cpos, csize, cact = _rows(cpos, order), _rows(csize, order), _rows(cact, order)
    use_obs = (~st["first_time"]) & torch.any(vis, dim=-1)
    if extra is not None:
        use_obs = use_obs | ((~st["first_time"]) & torch.any(extra["active"], -1))
    cact = cact * use_obs.to(cact.dtype)[:, None, None]
    qsize = csize[:, :, :W] / 2.0 + pl["dynamic_safety_dist"]
    qpos = cpos[:, :, :W]
    act = cact[:, :, None, :].expand(qpos.shape[:-1])
    dyn, yaw = torch.ones_like(act), None
    if extra is not None:
        shape = (S, 6, W, extra["pos"].shape[1])
        xact = extra["active"].to(act.dtype) * use_obs.to(act.dtype)[:, None]
        qpos = torch.cat([qpos, extra["pos"][:, None, None].expand(shape + (3,))], 3)
        qsize = torch.cat([qsize, (extra["size"] / 2.0 + pl["static_safety_dist"])
                           [:, None, None].expand(shape + (3,))], 3)
        yaw = torch.cat([torch.zeros_like(act), extra["yaw"][:, None, None].expand(shape)], 3)
        dyn = torch.cat([dyn, torch.zeros(shape, dtype=act.dtype, device=act.device)], 3)
        act = torch.cat([act, xact[:, None, None].expand(shape)], 3)
    lin = torch.where(st["has_solution"][:, None, None], X0[:, :W, 0:3],
                      pos[:, None, :].expand(S, W, 3))
    x0 = torch.cat([pos, st["vel"]], dim=-1)
    qps = qplib.build(pl, x0[:, None], xref[:, None], qpos, qsize, dyn, act,
                      lin[:, None], yaw)
    return dict(qps=qps, xref=xref, start=start, w6=w6, cpos=cpos, csize=csize,
                cact=cact)


def factor(cfg: dict, qps: qplib.QP, rho, prec: Precision):
    """The shared factor of each scenario's candidate-mean QP: (D, E, c,
    Minv)."""
    pl, sv = cfg["planner"], cfg["planner"]["solver"]
    dt, dev = qps.q.dtype, qps.q.device
    lin = qplib.linear_rows(pl, dt, dev)
    h = qplib.hessian(pl, dt, dev)
    mq = qplib.mean_qp(qps)
    D, E, c = qplib.ruiz(pl, sv, mq, lin, h)
    M = qplib.normal_matrix(pl, sv, mq, lin, h, D, E, c, rho)
    return D, E, c, inverse(prec, M)


def solve(cfg: dict, qps: qplib.QP, fac, warm, rho, prec: Precision):
    """The candidates' solves with the scenario's shared factor: (x
    (S, 6, n), primal residual (S, 6))."""
    pl, sv = cfg["planner"], cfg["planner"]["solver"]
    dt, dev = qps.q.dtype, qps.q.device
    D, E, c, Minv = fac
    lin = qplib.linear_rows(pl, dt, dev)
    h = qplib.hessian(pl, dt, dev)
    A = qplib.dense_a(pl, qps, lin)                               # (S, 6, m, n)
    Dc, Ec, cc = D[:, None], E[:, None], c[:, None]
    As = Ec[..., :, None] * A * Dc[..., None, :]
    r = qplib.rho_rows(pl, sv, qps, rho[:, None].expand(qps.q.shape[:2]))
    Mc = prec.mm(As.mT * r[..., None, :], As) \
        + torch.diag_embed(cc[..., None] * Dc * Dc * h + sv["sigma"])
    fused = sv["fused_solve"]
    mode = "stationary" if fused else sv["shared_refine_mode"]
    xs, zs, _ = admm(prec, As, Mc, Minv, cc[..., None] * Dc * qps.q,
                     Ec * qps.l, Ec * qps.u, r, warm / Dc, sv["max_iter"],
                     sv["shared_refine_iters"], mode, sv["sigma"], sv["alpha"])
    x = Dc * xs
    ax = prec.mv(A, x)
    if fused:
        z = torch.minimum(torch.maximum(ax, qps.l), qps.u)
    else:
        z = zs / Ec
    prim = (ax - z).abs().amax(-1)
    return x, prim


def plan(cfg: dict, ref, st: dict, obs: dict, fac, prec: Precision) -> dict:
    """The planner's cycle from state `st` on the obstacle input `obs`
    (as `assemble` takes it); `fac` the shared factor in force (None:
    factor this cycle's candidate-mean QP). Returns the chosen states
    and controls, the bookkeeping and the factor used."""
    pl = cfg["planner"]
    H, W = pl["horizon"], pl["horizon"] - 1
    a = assemble(cfg, ref, st, obs)
    qps = a["qps"]
    S = qps.q.shape[0]
    n = 8 * H + 5 * W
    if fac is None:
        fac = factor(cfg, qps, st["rho"], prec)
    warm = torch.where(st["has_solution"][:, None],
                       torch.cat([st["states_sol"].flatten(1),
                                  st["controls_sol"].flatten(1)], -1),
                       torch.zeros((S, n), dtype=qps.q.dtype, device=qps.q.device))
    x, prim = solve(cfg, qps, fac, warm[:, None].expand(S, 6, n), st["rho"], prec)
    ok = torch.isfinite(prim) & (prim < 1e3) & torch.isfinite(x).all(-1)
    X = x[..., :8 * H].unflatten(-1, (H, 8))
    U = x[..., 8 * H:].unflatten(-1, (W, 5))
    cons, det, safety = scores(pl, X, st["states_sol"],
                               st["has_solution"] & ~st["first_time"], a["xref"],
                               a["cpos"], a["csize"], a["cact"])
    best = choose(cons, det, safety, a["w6"], ok)
    valid = ok.any(-1)
    v3 = valid[:, None, None]
    return dict(states_sol=torch.where(v3, _rows(X, best), st["states_sol"]),
                controls_sol=torch.where(v3, _rows(U, best), st["controls_sol"]),
                xref=torch.where(v3, a["xref"], st["xref"]),
                last_ref_start=a["start"], valid=valid, best=best,
                first_time=st["first_time"] & ~valid,
                has_solution=st["has_solution"] | valid, factor=fac,
                candidate_states=X, prim_res=prim)


# ---------------------------------------------------------------- plant

def _interp(rows, ts: float, t):
    n = rows.shape[1]
    idx = torch.clamp(torch.floor(t / ts).long(), 0, n - 1)
    nxt = torch.clamp(idx + 1, max=n - 1)
    frac = (t - idx.to(rows.dtype) * ts) / ts
    return _rows(rows, idx) + (_rows(rows, nxt) - _rows(rows, idx)) * frac[:, None]


def bookkeeping(cfg: dict, st: dict, valid, cycle: int) -> dict:
    """The cycle's run/valid flags, counters and goal-stop logic."""
    e = cfg["engine"]
    t0 = cycle_time(cfg, cycle)
    active = ~st["done"]
    run = active & ~st["stopping"]
    valid = valid & run
    goal = torch.tensor(cfg["goal"], dtype=st["pos"].dtype, device=st["pos"].device)
    near = (torch.linalg.vector_norm(st["pos"] - goal, dim=-1) <= e["goal_stop_threshold"]) \
        & ((np.float64(t0) - st["tracking_start"]) >= 3.0)
    return dict(run=run, valid=valid,
                traj_ready=st["traj_ready"] | valid,
                traj_age=torch.where(valid, torch.zeros_like(st["traj_age"]),
                                     st["traj_age"] + 1),
                stopping=st["stopping"] | (near & active),
                stop_pos=torch.where(st["stopping"][:, None], st["stop_pos"], st["pos"]))


def ticks(cfg: dict, sc: dict, st: dict, step: dict, cycle: int) -> dict:
    """The cycle's control ticks from state `st` along the committed plan
    `step` (states_sol, controls_sol, traj_age, traj_ready, stopping,
    stop_pos): the PID controller (acceleration mode), the double
    integrator, the collision monitor and the goal criterion."""
    e, pl, cc = cfg["engine"], cfg["planner"], cfg["control"]
    dt = e["control_dt"]
    cycle_dt = dt * e["ticks_per_cycle"]
    t0 = cycle_time(cfg, cycle)
    H, ts = pl["horizon"], pl["ts"]
    pos, vel = st["pos"], st["vel"]
    ctrl = {k: st[k] for k in ("pos_err_int", "vel_err_int", "prev_pos_err",
                                "prev_vel_err", "ctrl_first")}
    done, active = st["done"], ~st["done"]
    collision = torch.zeros_like(done)
    min_d = torch.full(done.shape, math.inf, dtype=pos.dtype, device=pos.device)
    goal = torch.tensor(cfg["goal"], dtype=pos.dtype, device=pos.device)
    gain = {k: torch.tensor(cc[k], dtype=pos.dtype, device=pos.device)
            for k in ("position_p", "position_i", "position_d", "velocity_p",
                      "velocity_i", "velocity_d")}
    hold = step["stopping"] | ~step["traj_ready"]
    age = step["traj_age"].cpu().numpy().astype(np.float32)
    for k in range(e["ticks_per_cycle"]):
        t_traj = torch.as_tensor(age * f32(cycle_dt) + f32(k * dt),
                                 device=pos.device).to(pos.dtype)
        tp = _interp(step["states_sol"][..., 0:3], ts, t_traj)
        tv = _interp(step["states_sol"][..., 3:6], ts, t_traj)
        ta = _interp(step["controls_sol"][..., 0:3], ts, t_traj)
        past = (t_traj >= float(f32(H * ts)))[:, None]
        tv = torch.where(past, torch.zeros_like(tv), tv)
        ta = torch.where(past, torch.zeros_like(ta), ta)
        hp = torch.where(step["stopping"][:, None], step["stop_pos"], pos)
        tp = torch.where(hold[:, None], hp, tp)
        tv = torch.where(hold[:, None], torch.zeros_like(tv), tv)
        ta = torch.where(hold[:, None], torch.zeros_like(ta), ta)
        pe, ve = tp - pos, tv - vel
        pi_, vi_ = ctrl["pos_err_int"] + dt * pe, ctrl["vel_err_int"] + dt * ve
        first = ctrl["ctrl_first"][:, None]
        dp = torch.where(first, torch.zeros_like(pe), (pe - ctrl["prev_pos_err"]) / dt)
        dv = torch.where(first, torch.zeros_like(ve), (ve - ctrl["prev_vel_err"]) / dt)
        acc = ta + gain["position_p"] * pe + gain["position_i"] * pi_ \
            + gain["position_d"] * dp + gain["velocity_p"] * ve \
            + gain["velocity_i"] * vi_ + gain["velocity_d"] * dv
        a1 = active[:, None]
        new = dict(pos_err_int=pi_, vel_err_int=vi_, prev_pos_err=pe, prev_vel_err=ve)
        for key, val in new.items():
            ctrl[key] = torch.where(a1, val, ctrl[key])
        ctrl["ctrl_first"] = torch.where(active, torch.zeros_like(active),
                                         ctrl["ctrl_first"])
        npos = pos + vel * dt + 0.5 * acc * dt ** 2
        nvel = vel + acc * dt
        pos = torch.where(a1, npos, pos)
        vel = torch.where(a1, nvel, vel)
        obs = obstacle_state(sc, float(tick_end(cfg, t0, k)))
        gap = torch.clamp((pos[:, None, :] - obs).abs() - sc["bbox"] / 2.0, min=0.0)
        dist = torch.linalg.vector_norm(gap, dim=-1)
        hit = (dist <= 0.0).any(-1)
        collision = collision | (hit & active)
        min_d = torch.where(active, torch.minimum(min_d, dist.amin(-1)), min_d)
        reached = (torch.linalg.vector_norm(pos - goal, dim=-1) < e["goal_dist_threshold"]) \
            & (torch.linalg.vector_norm(vel, dim=-1) < e["goal_vel_threshold"]) & active
        done = done | reached
        active = ~done
    out = dict(pos=pos, vel=vel, done=done, collision=collision, min_dist=min_d)
    out.update(ctrl)
    return out
