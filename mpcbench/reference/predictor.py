"""Intent predictor: Markov-chain intent probabilities and the four
hypothesis rollouts, from explicit sample trajectories on the empty map
(dynamicPredictor.cpp: genTransitionMatrix, intentProb, modelForward,
modelTurning, modelStop, genTraj). Every sample of the configuration's
fixed grids is rolled out step by step; each hypothesis is the per-step
sample mean with the biased variance inflating the size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FORWARD, LEFT, RIGHT, STOP = 0, 1, 2, 3


def derived(p: dict) -> dict:
    """The predictor's derived parameters (dynamicPredictor.cpp:66-106)."""
    fa = p["front_angle_deg"] * math.pi / 180.0
    pl = (1.0 - p["max_front_prob"]) / (3.0 * p["max_front_prob"] - 1.0)
    pf = math.sqrt(fa * fa / (-2.0 * math.log(pl * (1.0 + math.sin(fa)) - pl)))
    ps = math.atanh(0.5) / p["stop_vel"]
    lo = (math.pi / 2.0) / p["max_turning_time"]
    hi = (math.pi / 2.0) / p["min_turning_time"]
    return dict(
        front=fa, param_l=pl, param_r=pl, param_f=pf, param_s=ps,
        n_fwd_angle=int(math.ceil(2.0 * fa / p["forward_angle_step"] - 1e-12)),
        n_angvel=int(math.ceil((hi - lo) / p["turning_angvel_step"] - 1e-12)),
        n_end=int(math.ceil((math.pi - 2.0 * fa) / p["turning_end_step"]
                            - 1e-12)))


def _transition(p, d, theta, r):
    """(..., 4 rows, 4 cols): column i is the transition vector with
    intent i's probability scaled by pscale."""
    pf_b = torch.exp(-0.5 * (theta / d["param_f"]) ** 2) + d["param_l"]
    pl_b = d["param_l"] * (1.0 + torch.sin(theta))
    pr_b = d["param_r"] * (1.0 - torch.sin(theta))
    cols = []
    for i in range(4):
        s = [1.0] * 4
        s[i] = p["pscale"]
        # the stop coefficient param_s / scale is a float32 quotient in the
        # configuration's definition
        coef = float(np.float32(d["param_s"]) / np.float32(s[3]))
        ps = 1.0 - torch.tanh(coef * r)
        f, l, rr = s[0] * pf_b, s[1] * pl_b, s[2] * pr_b
        k = (1.0 - ps) / (f + l + rr)
        cols.append(torch.stack([f * k, l * k, rr * k, ps], dim=-1))
    return torch.stack(cols, dim=-1)


def intent_prob(p, d, pos_hist, vel_hist, hist_len):
    """pos_hist, vel_hist (..., Hh, 3) newest first; hist_len (...) ->
    (..., 4). Transition k uses the triplet (k, k+1, k+2) and the speed
    at k; transitions reaching past the valid history are skipped."""
    Hh = pos_hist.shape[-2]
    seg = pos_hist[..., :-1, :] - pos_hist[..., 1:, :]
    ang = torch.atan2(seg[..., 1], seg[..., 0])
    th = ang[..., :-1] - ang[..., 1:]
    th = th - 2.0 * math.pi * torch.floor((th + math.pi) / (2.0 * math.pi))
    r = torch.linalg.vector_norm(vel_hist[..., :Hh - 2, 0:2], dim=-1)
    T = _transition(p, d, th, r)
    P = torch.full(pos_hist.shape[:-2] + (4,), 0.25, dtype=pos_hist.dtype,
                   device=pos_hist.device)
    hl = hist_len[..., None]
    for k in range(Hh - 3, -1, -1):
        ok = ((k + 2 < hl) & (k <= hl - 4))[..., 0]
        nxt = torch.einsum("...ij,...j->...i", T[..., k, :, :], P)
        P = torch.where(ok[..., None], nxt, P)
    return P


def _moments(traj, valid):
    """traj (..., N, P+1, 2) samples, valid (..., N): per-step mean and
    biased variance over the valid samples."""
    w = valid.to(traj.dtype)[..., None, None]
    n = torch.clamp(w.sum(dim=-3), min=1.0)
    mean = (traj * w).sum(dim=-3) / n
    var = (((traj - mean[..., None, :, :]) ** 2) * w).sum(dim=-3) / n
    return mean, var


def _forward(p, d, pos0, vel0):
    P, dt = p["num_pred"], p["dt"]
    dev, dty = pos0.device, pos0.dtype
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    a0 = torch.atan2(vel0[..., 1], vel0[..., 0])
    ia = torch.arange(d["n_fwd_angle"], dtype=dty, device=dev)
    js = torch.arange(p["max_forward_speed_samples"], dtype=dty, device=dev)
    ang = a0[..., None] - d["front"] + p["forward_angle_step"] * ia  # (..., A)
    sp = p["forward_speed_step"] * js                                # (J,)
    ok = sp < 2.0 * speed[..., None]                                 # (..., J)
    vx = sp[None, :] * torch.cos(ang)[..., :, None]                  # (..., A, J)
    vy = sp[None, :] * torch.sin(ang)[..., :, None]
    t = dt * torch.arange(P + 1, dtype=dty, device=dev)
    tx = pos0[..., None, None, None, 0] + t * vx[..., None]          # (..., A, J, P+1)
    ty = pos0[..., None, None, None, 1] + t * vy[..., None]
    traj = torch.stack([tx, ty], dim=-1).flatten(-4, -3)
    valid = ok[..., None, :].expand(ok.shape[:-1] + ang.shape[-1:]
                                    + ok.shape[-1:]).flatten(-2)
    return _moments(traj, valid)


def _turning(p, d, intent, pos0, vel0):
    P, dt = p["num_pred"], p["dt"]
    dev, dty = pos0.device, pos0.dtype
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    a0 = torch.atan2(vel0[..., 1], vel0[..., 0])
    sp = p["turning_speed_step"] * torch.arange(
        p["max_turning_speed_samples"], dtype=dty, device=dev)       # (J,)
    ok = sp < 2.0 * speed[..., None]
    iw = torch.arange(d["n_angvel"], dtype=dty, device=dev)
    ie = torch.arange(d["n_end"], dtype=dty, device=dev)
    if intent == LEFT:
        w = (math.pi / 2) / p["max_turning_time"] + p["turning_angvel_step"] * iw
        end = d["front"] + a0[..., None] + p["turning_end_step"] * ie
    else:
        w = (-math.pi / 2) / p["min_turning_time"] + p["turning_angvel_step"] * iw
        end = -(math.pi - d["front"]) + a0[..., None] + p["turning_end_step"] * ie
    steps = torch.arange(P, dtype=dty, device=dev)
    # heading of each move: the initial heading advanced by w dt per step,
    # held at the end angle
    raw = a0[..., None, None, None] + steps * (w * dt)[:, None, None]  # (..., W, 1, P)
    e = end[..., None, :, None]                                        # (..., 1, E, 1)
    head = torch.minimum(raw, e) if intent == LEFT else torch.maximum(raw, e)
    moves = torch.stack([torch.cos(head), torch.sin(head)], dim=-1) * dt
    path = torch.cat([torch.zeros_like(moves[..., :1, :]),
                      torch.cumsum(moves, dim=-2)], dim=-2)            # (..., W, E, P+1, 2)
    path = path.flatten(-4, -3)                                        # (..., W E, P+1, 2)
    traj = pos0[..., None, None, None, 0:2] \
        + sp[:, None, None, None] * path[..., None, :, :, :]           # (..., J, WE, P+1, 2)
    traj = traj.flatten(-4, -3)
    valid = ok[..., :, None].expand(ok.shape + (path.shape[-3],)).flatten(-2)
    return _moments(traj, valid)


def predict(p: dict, pos_hist, vel_hist, size_hist, hist_len):
    """Predictions of every obstacle: (pos (..., 4, P+1, 3), size (..., 4,
    P+1, 3), intent probabilities (..., 4)) from the newest history
    entry; obstacles at or below the stop speed take the stop model for
    every intent."""
    d = derived(p)
    P, dt, z = p["num_pred"], p["dt"], p["z_score"]
    prob = intent_prob(p, d, pos_hist, vel_hist, hist_len)
    pos0, vel0, size0 = pos_hist[..., 0, :], vel_hist[..., 0, :], size_hist[..., 0, :]
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    t = torch.arange(P + 1, dtype=pos0.dtype, device=pos0.device)
    stop_pos = pos0[..., None, :].expand(pos0.shape[:-1] + (P + 1, 3))
    grow = 2.0 * torch.clamp(speed, max=p["stop_vel"]) * dt
    stop_size = torch.cat([size0[..., None, 0:2] + (t * grow[..., None])[..., None],
                           size0[..., None, 2:3].expand(size0.shape[:-1] + (P + 1, 1))],
                          dim=-1)
    out_p, out_s = [], []
    for mean_var in (_forward(p, d, pos0, vel0), _turning(p, d, LEFT, pos0, vel0),
                     _turning(p, d, RIGHT, pos0, vel0)):
        mean, var = mean_var
        pos = torch.cat([mean, pos0[..., None, 2:3].expand(mean.shape[:-1] + (1,))],
                        dim=-1)
        size = torch.cat([size0[..., None, 0:2] + 2.0 * z * torch.sqrt(var),
                          size0[..., None, 2:3].expand(mean.shape[:-1] + (1,))],
                         dim=-1)
        stopped = (speed <= p["stop_vel"])[..., None, None]
        out_p.append(torch.where(stopped, stop_pos, pos))
        out_s.append(torch.where(stopped, stop_size, size))
    out_p.append(stop_pos)
    out_s.append(stop_size)
    return torch.stack(out_p, dim=-3), torch.stack(out_s, dim=-3), prob
