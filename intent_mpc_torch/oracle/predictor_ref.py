"""Float64 numpy oracle: literal transcription of the reference predictor
(the port's own copy of the JAX package's oracle/predictor_ref.py; bit-equal).

Mirrors dynamic_predictor/include/dynamic_predictor/dynamicPredictor.cpp
loop-for-loop (including float-accumulation sample grids) for parity tests
against the port's vectorized models/predictor.py. The one intentional
deviation: the intentProb history loop stops one iteration early to skip
the reference's out-of-bounds read (dynamicPredictor.cpp:207 with
j = numHist-1 -> posHist index -1). cfg is a PredictorConfig.

Occupancy is a callable p -> bool (default: always free, matching the empty
benchmark map)."""

from __future__ import annotations

import math

import numpy as np

FORWARD, LEFT, RIGHT, STOP = 0, 1, 2, 3


def _free(_p):
    return False


def gen_transition_vector(cfg, theta, r, scale):
    pf = scale[0] * (math.exp(-0.5 * (theta / cfg.param_f) ** 2) + cfg.param_l)
    pl = scale[1] * (cfg.param_l * (1.0 + math.sin(theta)))
    pr = scale[2] * (cfg.param_r * (1.0 - math.sin(theta)))
    ps = 1.0 - math.tanh(cfg.param_s / scale[3] * r)
    s = pr + pl + pf
    pr = (1 - ps) * pr / s
    pl = (1 - ps) * pl / s
    pf = (1 - ps) * pf / s
    out = np.zeros(4)
    out[FORWARD] = pf
    out[LEFT] = pl
    out[RIGHT] = pr
    out[STOP] = ps
    return out


def gen_transition_matrix(cfg, prev_angle, curr_angle, curr_vel):
    theta = curr_angle - prev_angle
    if theta > math.pi:
        theta -= 2 * math.pi
    elif theta <= -math.pi:
        theta += 2 * math.pi
    r = math.hypot(curr_vel[0], curr_vel[1])
    T = np.zeros((4, 4))
    for i in range(4):
        scale = np.ones(4)
        scale[i] = cfg.pscale
        T[:, i] = gen_transition_vector(cfg, theta, r, scale)
    return T


def intent_prob(cfg, pos_hist, vel_hist):
    """dynamicPredictor.cpp:197-226. pos_hist: list of (Hh,3), newest first."""
    out = []
    for ph, vh in zip(pos_hist, vel_hist):
        nh = len(ph)
        P = np.full(4, 0.25)
        for j in range(2, nh - 1):   # j = nh-1 skipped (OOB in reference)
            prev_pos = ph[nh - j - 1]
            curr_pos = ph[nh - j - 2]
            curr_vel = vh[nh - j - 2]
            prev_angle = math.atan2(prev_pos[1] - ph[nh - j][1],
                                    prev_pos[0] - ph[nh - j][0])
            curr_angle = math.atan2(curr_pos[1] - prev_pos[1],
                                    curr_pos[0] - prev_pos[0])
            T = gen_transition_matrix(cfg, prev_angle, curr_angle, curr_vel)
            P = T @ P
        out.append(P)
    return np.array(out)


def model_forward(cfg, pos0, vel0, occupied=_free):
    """dynamicPredictor.cpp:351-402."""
    pred_points = []
    vel = math.hypot(vel0[0], vel0[1])
    ai = math.atan2(vel0[1], vel0[0])
    i = ai - cfg.front_angle
    while i < ai + cfg.front_angle:
        j = 0.0
        while j < 2 * vel:
            traj = [np.array(pos0)]
            state = np.array([pos0[0], pos0[1], j * math.cos(i), j * math.sin(i)])
            ok = True
            for _ in range(cfg.num_pred):
                state = state + np.array([state[2] * cfg.dt, state[3] * cfg.dt, 0, 0])
                p = np.array([state[0], state[1], pos0[2]])
                if occupied(p):
                    ok = False
                    break
                traj.append(p)
            if ok:
                pred_points.append(traj)
                j += cfg.forward_speed_step
            else:
                break   # reference breaks the speed loop on collision
        i += cfg.forward_angle_step
    return pred_points


def model_turning(cfg, intent, pos0, vel0, occupied=_free):
    """dynamicPredictor.cpp:404-486."""
    pred_points = []
    vel = math.hypot(vel0[0], vel0[1])
    ai = math.atan2(vel0[1], vel0[0])
    if intent == LEFT:
        end_min, end_max = cfg.front_angle + ai, (math.pi - cfg.front_angle) + ai
        w_min = (math.pi / 2) / cfg.max_turning_time
        w_max = (math.pi / 2) / cfg.min_turning_time
    else:
        end_min, end_max = -(math.pi - cfg.front_angle) + ai, -cfg.front_angle + ai
        w_min = (-math.pi / 2) / cfg.min_turning_time
        w_max = (-math.pi / 2) / cfg.max_turning_time
    i = 0.0
    while i < 2 * vel:
        j = w_min
        while j < w_max:
            end = end_min
            while end < end_max:
                traj = [np.array(pos0)]
                angle = ai
                state = np.array([pos0[0], pos0[1],
                                  i * math.cos(angle), i * math.sin(angle)])
                ok = True
                for _ in range(cfg.num_pred):
                    state = state + np.array([state[2] * cfg.dt, state[3] * cfg.dt, 0, 0])
                    p = np.array([state[0], state[1], pos0[2]])
                    if occupied(p):
                        ok = False
                        break
                    traj.append(p)
                    angle += j * cfg.dt
                    angle = min(angle, end) if intent == LEFT else max(angle, end)
                    v = math.hypot(state[2], state[3])
                    state[2] = v * math.cos(angle)
                    state[3] = v * math.sin(angle)
                if ok:
                    pred_points.append(traj)
                end += cfg.turning_end_step
            j += cfg.turning_angvel_step
        i += cfg.turning_speed_step
    return pred_points


def model_stop(cfg, pos0, vel0, size0):
    """dynamicPredictor.cpp:488-501."""
    vel = math.hypot(vel0[0], vel0[1])
    traj = [np.array(pos0)] * (cfg.num_pred + 1)
    sizes = []
    size = np.array(size0, float)
    for _ in range(cfg.num_pred + 1):
        sizes.append(size.copy())
        size[0] += 2 * min(vel, cfg.stop_vel) * cfg.dt
        size[1] += 2 * min(vel, cfg.stop_vel) * cfg.dt
    return [traj], sizes


def gen_traj(cfg, pred_points, size0, occupied=_free):
    """genTraj + positionCorrection (dynamicPredictor.cpp:503-567)."""
    mean = []
    sizes = [np.array(size0, float) for _ in range(cfg.num_pred + 1)]
    for i in range(cfg.num_pred + 1):
        pts = [t[i] for t in pred_points if i < len(t)]
        if not pts:
            break
        mx = float(np.mean([p[0] for p in pts]))
        my = float(np.mean([p[1] for p in pts]))
        vx = float(np.sum([(p[0] - mx) ** 2 for p in pts])) / len(pts)
        vy = float(np.sum([(p[1] - my) ** 2 for p in pts])) / len(pts)
        mean.append(np.array([mx, my, pred_points[0][0][2]]))
        sizes[i][0] += 2 * math.sqrt(vx) * cfg.z_score
        sizes[i][1] += 2 * math.sqrt(vy) * cfg.z_score
    if any(occupied(m) for m in mean):
        best, best_s = None, math.inf
        for traj in pred_points:
            s = sum(math.hypot(traj[j][0] - mean[j][0], traj[j][1] - mean[j][1])
                    for j in range(len(mean)))
            if s < best_s:
                best, best_s = traj, s
        mean = [np.array(p) for p in best]
    return np.array(mean), np.array(sizes)


def predict_obstacle(cfg, pos0, vel0, size0, occupied=_free):
    """predTraj for one obstacle (dynamicPredictor.cpp:283-329)."""
    vel = math.hypot(vel0[0], vel0[1])
    pos_out = np.zeros((4, cfg.num_pred + 1, 3))
    size_out = np.zeros((4, cfg.num_pred + 1, 3))
    for intent in (FORWARD, LEFT, RIGHT, STOP):
        if vel <= cfg.stop_vel or intent == STOP:
            pts, sizes = model_stop(cfg, pos0, vel0, size0)
            pos_out[intent] = np.array(pts[0])
            size_out[intent] = np.array(sizes)
            continue
        if intent == FORWARD:
            pts = model_forward(cfg, pos0, vel0, occupied)
        else:
            pts = model_turning(cfg, intent, pos0, vel0, occupied)
        if pts:
            mean, sizes = gen_traj(cfg, pts, size0, occupied)
            pos_out[intent] = mean
            size_out[intent] = sizes
        else:  # fallback (:312-326)
            trajs, sizes = model_stop(cfg, pos0, vel0, size0)
            pos_out[intent] = np.array(trajs[0])
            size_out[intent] = np.array(sizes)
    return pos_out, size_out
