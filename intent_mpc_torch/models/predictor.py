"""Intent predictor: Markov-chain intent probabilities + multi-hypothesis
trajectory rollouts (port of intent_mpc_tpu/models/predictor.py).

Reference: dynamic_predictor/include/dynamic_predictor/dynamicPredictor.cpp.
Intent order matches the reference enum (dynamic_predictor/utils.h:15-20):
FORWARD=0, LEFT=1, RIGHT=2, STOP=3.

Two paths, chosen by the map as in JAX:
  * an empty occupancy map (the DYNUS GT benchmark): every rollout sample
    is valid and sample positions factorize, so genTraj's per-step mean
    and (biased) variance over the sample grid reduce to products of 1-D
    moments; no (samples x steps) arrays are materialized;
  * a real grid (the prebuilt static map of the real-perception loop):
    the reference's data-dependent sample loops with occupancy-rejection
    `break`s (:365-397, :438-482) become fixed sample grids with validity
    masks, masked per-step means and variances, and positionCorrection's
    nearest-sample substitute. A per-scenario grid needs the scenario
    axis leading.

Every function takes leading batch axes (..., O) before its per-obstacle
trailing dims.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from intent_mpc_torch.models.occupancy import (OccupancyGrid, is_empty,
                                               is_occupied)
from intent_mpc_torch.utils.config import PredictorConfig

FORWARD, LEFT, RIGHT, STOP = 0, 1, 2, 3


class Prediction(NamedTuple):
    pos: torch.Tensor          # (..., O, 4, P+1, 3) predicted mean positions
    size: torch.Tensor         # (..., O, 4, P+1, 3) predicted sizes (var-inflated)
    intent_prob: torch.Tensor  # (..., O, 4)


def _wrap_angle(t):
    return t - 2.0 * math.pi * torch.floor((t + math.pi) / (2.0 * math.pi))


def _arange(n, ref: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=ref.dtype, device=ref.device)


def transition_matrix(cfg: PredictorConfig, theta, r):
    """4x4 transition matrix; column i is genTransitionVector with intent i
    scaled by pscale (dynamicPredictor.cpp:229-281). theta/r (...).
    Returns (..., 4 rows, 4 cols)."""
    pf_b = torch.exp(-0.5 * (theta / cfg.param_f) ** 2) + cfg.param_l
    pl_b = cfg.param_l * (1.0 + torch.sin(theta))
    pr_b = cfg.param_r * (1.0 - torch.sin(theta))

    def column(scale_idx):
        s = [1.0] * 4
        s[scale_idx] = cfg.pscale
        pf = s[0] * pf_b
        pl = s[1] * pl_b
        pr = s[2] * pr_b
        # param_s / s[3] rounds in float32, as the reference's f32 math does
        coef = float(np.float32(cfg.param_s) / np.float32(s[3]))
        ps = 1.0 - torch.tanh(coef * r)
        tot = pf + pl + pr
        k = (1.0 - ps) / tot
        return torch.stack([pf * k, pl * k, pr * k, ps], dim=-1)

    return torch.stack([column(i) for i in range(4)], dim=-1)


def intent_probabilities(cfg: PredictorConfig, pos_hist, vel_hist, hist_len):
    """P = prod_k T(theta_k, r_k) * uniform, folded oldest-to-newest.

    pos_hist/vel_hist (..., O, Hh, 3), newest at index 0; hist_len (..., O)
    valid entries per obstacle. Returns (..., O, 4).

    Transition k (the newest point of its triplet) uses theta =
    wrap(angle(pos[k]-pos[k+1]) - angle(pos[k+1]-pos[k+2])) and
    r = |vel[k][:2]| (dynamicPredictor.cpp:207-222); transitions with any
    index >= hist_len are the identity.
    """
    Hh = pos_hist.shape[-2]
    seg = pos_hist[..., :-1, :] - pos_hist[..., 1:, :]      # newer - older
    ang = torch.atan2(seg[..., 1], seg[..., 0])            # (..., O, Hh-1)
    theta = _wrap_angle(ang[..., :-1] - ang[..., 1:])      # (..., O, Hh-2)
    r = torch.linalg.vector_norm(vel_hist[..., : Hh - 2, 0:2], dim=-1)

    ks = torch.arange(Hh - 2, device=pos_hist.device)
    hl = hist_len[..., None]
    valid = (ks + 2 < hl) & (ks <= hl - 4)

    T = transition_matrix(cfg, theta, r)                   # (..., O, Hh-2, 4, 4)
    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    T = torch.where(valid[..., None, None], T, eye)

    P = torch.full(pos_hist.shape[:-2] + (4,), 0.25, dtype=T.dtype,
                   device=T.device)
    for k in range(Hh - 3, -1, -1):          # oldest transition first
        P = torch.matmul(T[..., k, :, :], P[..., None])[..., 0]
    return P


def _speed_moments(speeds, mask):
    cnt = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    es = torch.sum(speeds * mask, dim=-1) / cnt
    es2 = torch.sum(speeds ** 2 * mask, dim=-1) / cnt
    return es, es2


def _inflate(cfg: PredictorConfig, size0, var_xy):
    """size (..., P+1, 3): size0 with 2 z sqrt(var) added on x, y."""
    add = 2.0 * torch.sqrt(var_xy) * cfg.z_score
    xy = size0[..., None, 0:2] + add
    z = size0[..., None, 2:3].expand(xy.shape[:-1] + (1,))
    return torch.cat([xy, z], dim=-1)


def _with_z(mean_xy, pos0):
    z = pos0[..., None, 2:3].expand(mean_xy.shape[:-1] + (1,))
    return torch.cat([mean_xy, z], dim=-1)


def _forward_moments(cfg: PredictorConfig, pos0, vel0, size0):
    P = cfg.num_pred
    na, ns = cfg.num_forward_angle_samples, cfg.max_forward_speed_samples
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    ang0 = torch.atan2(vel0[..., 1], vel0[..., 0])
    angles = (ang0[..., None] - cfg.front_angle) \
        + cfg.forward_angle_step * _arange(na, pos0)
    speeds = cfg.forward_speed_step * _arange(ns, pos0)
    m = (speeds < 2.0 * speed[..., None]).to(pos0.dtype)
    es, es2 = _speed_moments(speeds, m)
    d = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)  # (...,na,2)
    ed = torch.mean(d, dim=-2)
    ed2 = torch.mean(d ** 2, dim=-2)
    t = (_arange(P + 1, pos0) * cfg.dt)[:, None]                     # (P+1,1)
    es_b, es2_b = es[..., None, None], es2[..., None, None]
    ed_b, ed2_b = ed[..., None, :], ed2[..., None, :]
    mean_xy = pos0[..., None, 0:2] + t * es_b * ed_b
    var_xy = t ** 2 * (es2_b * ed2_b - (es_b * ed_b) ** 2)
    var_xy = torch.clamp(var_xy, min=0.0)
    return _with_z(mean_xy, pos0), _inflate(cfg, size0, var_xy)


def _turning_moments(cfg: PredictorConfig, intent, pos0, vel0, size0):
    P = cfg.num_pred
    ns = cfg.max_turning_speed_samples
    nw = cfg.num_turning_angvel_samples
    ne = cfg.num_turning_end_samples
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    ang0 = torch.atan2(vel0[..., 1], vel0[..., 0])
    speeds = cfg.turning_speed_step * _arange(ns, pos0)
    m = (speeds < 2.0 * speed[..., None]).to(pos0.dtype)
    es, es2 = _speed_moments(speeds, m)

    if intent == LEFT:
        end = (cfg.front_angle + ang0[..., None]) \
            + cfg.turning_end_step * _arange(ne, pos0)
        angvel = (math.pi / 2) / cfg.max_turning_time \
            + cfg.turning_angvel_step * _arange(nw, pos0)
    else:
        end = (-(math.pi - cfg.front_angle) + ang0[..., None]) \
            + cfg.turning_end_step * _arange(ne, pos0)
        angvel = (-math.pi / 2) / cfg.min_turning_time \
            + cfg.turning_angvel_step * _arange(nw, pos0)

    t = _arange(P, pos0)
    raw = ang0[..., None, None, None] \
        + t[None, None, :] * angvel[:, None, None] * cfg.dt      # (...,nw,1,P)
    endb = end[..., None, :, None]                                # (...,1,ne,1)
    ang_t = torch.minimum(raw, endb) if intent == LEFT \
        else torch.maximum(raw, endb)
    dirs = torch.stack([torch.cos(ang_t), torch.sin(ang_t)], dim=-1)
    D = torch.cumsum(dirs, dim=-2) * cfg.dt                       # (...,nw,ne,P,2)
    D = torch.cat([torch.zeros_like(D[..., :1, :]), D], dim=-2)   # t=0
    ED = torch.mean(D, dim=(-4, -3))                              # (...,P+1,2)
    ED2 = torch.mean(D ** 2, dim=(-4, -3))
    es_b, es2_b = es[..., None, None], es2[..., None, None]
    mean_xy = pos0[..., None, 0:2] + es_b * ED
    var_xy = torch.clamp(es2_b * ED2 - (es_b * ED) ** 2, min=0.0)
    return _with_z(mean_xy, pos0), _inflate(cfg, size0, var_xy)


def _stop_prediction(cfg: PredictorConfig, pos0, vel0, size0):
    """modelStop (dynamicPredictor.cpp:488-501): constant position, size
    growing by 2*min(v, stopVel)*dt per step."""
    P = cfg.num_pred
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    grow = 2.0 * torch.clamp(speed, max=cfg.stop_vel) * cfg.dt
    t = _arange(P + 1, pos0)
    pos = pos0[..., None, :].expand(pos0.shape[:-1] + (P + 1, 3))
    xy = size0[..., None, 0:2] + (t * grow[..., None])[..., None]
    z = size0[..., None, 2:3].expand(xy.shape[:-1] + (1,))
    return pos, torch.cat([xy, z], dim=-1)


def predict_single_fast(cfg: PredictorConfig, pos0, vel0, acc0, size0):
    """Moment-based predictor for the empty map; (..., 3) inputs ->
    (pos (..., 4, P+1, 3), size (..., 4, P+1, 3))."""
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    stopped = (speed <= cfg.stop_vel)[..., None, None]
    stop_pos, stop_size = _stop_prediction(cfg, pos0, vel0, size0)
    f_pos, f_size = _forward_moments(cfg, pos0, vel0, size0)
    l_pos, l_size = _turning_moments(cfg, LEFT, pos0, vel0, size0)
    r_pos, r_size = _turning_moments(cfg, RIGHT, pos0, vel0, size0)

    def pick(pos, size):
        return (torch.where(stopped, stop_pos, pos),
                torch.where(stopped, stop_size, size))

    fw, lf, rt = pick(f_pos, f_size), pick(l_pos, l_size), pick(r_pos, r_size)
    pos = torch.stack([fw[0], lf[0], rt[0], stop_pos], dim=-3)
    size = torch.stack([fw[1], lf[1], rt[1], stop_size], dim=-3)
    return pos, size


# ---------------------------------------------------------------------------
# Rollout sample grids (a real occupancy map)
# ---------------------------------------------------------------------------

def _masked_mean_var(points_xy, valid):
    """Masked per-step mean and variance over the sample axis: points_xy
    (..., N, P+1, 2), valid (..., N) float. Mirrors genTraj
    (dynamicPredictor.cpp:503-538): the variance divides by the valid
    count."""
    w = valid[..., None, None]
    cnt = torch.clamp(torch.sum(valid, dim=-1), min=1.0)[..., None, None]
    mean = torch.sum(points_xy * w, dim=-3) / cnt
    var = torch.sum(((points_xy - mean[..., None, :, :]) ** 2) * w,
                    dim=-3) / cnt
    return mean, var


def _with_pos_z(xy, pos0):
    """Append pos0's z to sample positions xy (..., N.., P+1, 2)."""
    z = pos0[..., 2].reshape(pos0.shape[:-1] + (1,) * (xy.dim() - pos0.dim()))
    return torch.cat([xy, z[..., None].expand(xy.shape[:-1] + (1,))], dim=-1)


def _forward_samples(cfg: PredictorConfig, pos0, vel0, occ: OccupancyGrid):
    """modelForward (dynamicPredictor.cpp:351-402): const-velocity rollouts
    over an (angle, speed) grid. Returns (..., N, P+1, 3) positions and
    (..., N) valid, N = angles x speeds."""
    P = cfg.num_pred
    na, ns = cfg.num_forward_angle_samples, cfg.max_forward_speed_samples
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    ang0 = torch.atan2(vel0[..., 1], vel0[..., 0])
    angles = (ang0[..., None] - cfg.front_angle) \
        + cfg.forward_angle_step * _arange(na, pos0)             # (...,na)
    speeds = cfg.forward_speed_step * _arange(ns, pos0)
    sp_valid = speeds < 2.0 * speed[..., None]                   # loop bound j < 2v

    t = _arange(P + 1, pos0) * cfg.dt
    dirs = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)
    xy = pos0[..., None, None, None, 0:2] \
        + dirs[..., :, None, None, :] * speeds[:, None, None] * t[:, None]
    pts = _with_pos_z(xy, pos0)                                  # (...,na,ns,P+1,3)
    free = ~is_occupied(occ, pts[..., 1:, :])
    clear = torch.all(free, dim=-1)                              # (...,na,ns)
    # the reference `break`s out of the speed loop on the first collision,
    # discarding every higher speed of that angle (:389-395)
    clear = torch.cumprod(clear.to(torch.int32), dim=-1).to(torch.bool)
    valid = clear & sp_valid[..., None, :]
    lead = pts.shape[:-4]
    return (pts.reshape(lead + (na * ns, P + 1, 3)),
            valid.reshape(lead + (na * ns,)))


def _turning_samples(cfg: PredictorConfig, intent, pos0, vel0,
                     occ: OccupancyGrid):
    """modelTurning (dynamicPredictor.cpp:404-486): rotate-velocity
    rollouts over (speed, ang-vel, end-angle); intent LEFT or RIGHT."""
    P = cfg.num_pred
    ns = cfg.max_turning_speed_samples
    nw = cfg.num_turning_angvel_samples
    ne = cfg.num_turning_end_samples
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    ang0 = torch.atan2(vel0[..., 1], vel0[..., 0])
    speeds = cfg.turning_speed_step * _arange(ns, pos0)
    sp_valid = speeds < 2.0 * speed[..., None]                   # (...,ns)

    if intent == LEFT:
        end = (cfg.front_angle + ang0[..., None]) \
            + cfg.turning_end_step * _arange(ne, pos0)
        angvel = (math.pi / 2) / cfg.max_turning_time \
            + cfg.turning_angvel_step * _arange(nw, pos0)
    else:
        end = (-(math.pi - cfg.front_angle) + ang0[..., None]) \
            + cfg.turning_end_step * _arange(ne, pos0)
        angvel = (-math.pi / 2) / cfg.min_turning_time \
            + cfg.turning_angvel_step * _arange(nw, pos0)

    t = _arange(P, pos0)
    raw = ang0[..., None, None, None] \
        + t[None, None, :] * angvel[:, None, None] * cfg.dt      # (...,nw,1,P)
    endb = end[..., None, :, None]                               # (...,1,ne,1)
    ang_t = torch.minimum(raw, endb) if intent == LEFT \
        else torch.maximum(raw, endb)
    dirs = torch.stack([torch.cos(ang_t), torch.sin(ang_t)], dim=-1)
    disp = torch.cumsum(dirs, dim=-2) * cfg.dt                   # (...,nw,ne,P,2)
    xy = pos0[..., None, None, None, None, 0:2] \
        + speeds[:, None, None, None, None] * disp[..., None, :, :, :, :]
    xy = torch.cat([pos0[..., None, None, None, None, 0:2].expand(
        xy.shape[:-2] + (1, 2)), xy], dim=-2)                    # (...,ns,nw,ne,P+1,2)
    pts = _with_pos_z(xy, pos0)
    free = ~is_occupied(occ, pts[..., 1:, :])
    clear = torch.all(free, dim=-1)                              # (...,ns,nw,ne)
    valid = clear & sp_valid[..., :, None, None]
    lead = pts.shape[:-5]
    N = ns * nw * ne
    return pts.reshape(lead + (N, P + 1, 3)), valid.reshape(lead + (N,))


def _aggregate(cfg: PredictorConfig, pts, valid, size0, occ: OccupancyGrid):
    """genTraj + positionCorrection: masked mean/variance and z-score size
    inflation; where the mean path collides, the nearest valid sample
    (the lowest index on ties) replaces it."""
    any_valid = torch.any(valid, dim=-1)
    mean_xy, var_xy = _masked_mean_var(pts[..., 0:2], valid.to(pts.dtype))
    mean = _with_pos_z(mean_xy, pts[..., 0, 0, :])               # (...,P+1,3)
    size = _inflate(cfg, size0, var_xy)

    # positionCorrection (dynamicPredictor.cpp:540-567)
    collide = torch.any(is_occupied(occ, mean), dim=-1)
    d = torch.linalg.vector_norm(pts[..., 0:2] - mean[..., None, :, 0:2],
                                 dim=-1)                         # (...,N,P+1)
    score = torch.sum(d, dim=-1) + torch.where(
        valid, torch.zeros_like(d[..., 0]), torch.full_like(d[..., 0],
                                                            float("inf")))
    nearest = torch.argmin(score, dim=-1)                        # (...)
    near = torch.gather(pts, -3, nearest[..., None, None, None].expand(
        nearest.shape + (1,) + pts.shape[-2:]))[..., 0, :, :]
    mean = torch.where(collide[..., None, None], near, mean)
    return mean, size, any_valid


def predict_single(cfg: PredictorConfig, pos0, vel0, acc0, size0,
                   occ: OccupancyGrid):
    """All 4 intent hypotheses from the sample grids on a real map:
    (..., 3) inputs -> (pos (..., 4, P+1, 3), size (..., 4, P+1, 3)).
    genPoints semantics (dynamicPredictor.cpp:331-349): speed <= stopVel
    -> every intent uses the stop model; an intent with no valid sample
    falls back to it too (:312-326)."""
    speed = torch.linalg.vector_norm(vel0[..., 0:2], dim=-1)
    stopped = speed <= cfg.stop_vel
    stop_pos, stop_size = _stop_prediction(cfg, pos0, vel0, size0)

    def hypothesis(samples):
        pos, size, ok = _aggregate(cfg, *samples, size0, occ)
        use_stop = (stopped | ~ok)[..., None, None]
        return (torch.where(use_stop, stop_pos, pos),
                torch.where(use_stop, stop_size, size))

    fw = hypothesis(_forward_samples(cfg, pos0, vel0, occ))
    lf = hypothesis(_turning_samples(cfg, LEFT, pos0, vel0, occ))
    rt = hypothesis(_turning_samples(cfg, RIGHT, pos0, vel0, occ))
    pos = torch.stack([fw[0], lf[0], rt[0], stop_pos], dim=-3)
    size = torch.stack([fw[1], lf[1], rt[1], stop_size], dim=-3)
    return pos, size


def predict(cfg: PredictorConfig, pos_hist, vel_hist, acc_hist, size_hist,
            hist_len, occ: Optional[OccupancyGrid] = None) -> Prediction:
    """Full predictor over all obstacles (vectorized predictor::predict).

    Histories are (..., O, Hh, 3), newest at index 0; hist_len (..., O).
    occ None or the 1-voxel empty grid selects the closed-form moment
    path, a real grid the sampled path (a per-scenario grid with the
    scenario axis leading)."""
    probs = intent_probabilities(cfg, pos_hist, vel_hist, hist_len)
    args = (pos_hist[..., 0, :], vel_hist[..., 0, :], acc_hist[..., 0, :],
            size_hist[..., 0, :])
    if occ is None or is_empty(occ):
        pos, size = predict_single_fast(cfg, *args)
    else:
        pos, size = predict_single(cfg, *args, occ)
    return Prediction(pos=pos, size=size, intent_prob=probs)
