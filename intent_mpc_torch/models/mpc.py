"""MPC planner: intent-weighted multi-hypothesis candidate solve and
selection (port of intent_mpc_tpu/models/mpc.py): the predictor path
`make_plan_with_pred`, with the camera-FOV rows, the goal-relax
safety distance and the clustered static rows, and the constant-obstacle
`make_plan`.

Rebuild of trajPlanner::mpcPlanner (trajectory_planner/mpcPlanner.cpp).
The reference solves <=6 candidate QPs sequentially under a 0.15 s
budget (makePlanWithPred, :571-661); here the 6 candidates of every
scenario are one (S, 6) batch solved together.

Reference quirks reproduced deliberately (as in the JAX package):
  * candidates sort intent combos by descending probability, but
    evaluateTraj indexes the weight vector with the sorted position.
  * findClosestObstacle's 10-step loop reads statesSol[0]/[1] only.
  * the first solve of an episode runs with no obstacle constraints.

Every function takes a leading scenario axis S.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from intent_mpc_torch.models.predictor import (FORWARD, LEFT, RIGHT, STOP,
                                               Prediction)
from intent_mpc_torch.ops import qp as qplib
from intent_mpc_torch.ops.admm import (Factor, admm_factor, admm_solve,
                                       candidate_mean)
from intent_mpc_torch.ops.fleet import fleet_admm
from intent_mpc_torch.ops.polish import polish
from intent_mpc_torch.utils.config import PlannerConfig
from intent_mpc_torch.utils.device import constant


class PlannerState(NamedTuple):
    """Warm-start / bookkeeping carry (mpcPlanner member state), (S, ...)."""

    states_sol: torch.Tensor     # (S, H, 8) previous solution states
    controls_sol: torch.Tensor   # (S, W, 5)
    first_time: torch.Tensor     # (S,) bool (mpcPlanner::firstTime_)
    has_solution: torch.Tensor   # (S,) bool
    last_ref_start: torch.Tensor  # (S,) int32 (lastRefStartIdx_)
    xref: torch.Tensor           # (S, H, 3) last reference window
    rho: torch.Tensor            # (S,) ADMM base penalty
    # carried shared factor (solver.factor_reuse_cycles > 1 only), refreshed
    # every k-th cycle
    fac_d: Optional[torch.Tensor] = None       # (S, n)
    fac_e: Optional[qplib.ConVec] = None       # constraint-space scaling
    fac_c: Optional[torch.Tensor] = None       # (S,)
    fac_minv: Optional[torch.Tensor] = None    # (S, n, n)
    # active obstacle gradients at the last factor refresh (S, W, K+1, 3)
    # (SolverConfig.factor_drift_refresh > 0 only)
    fac_gref: Optional[torch.Tensor] = None


class PlanOutput(NamedTuple):
    state: PlannerState
    valid: torch.Tensor          # (S,) bool: this cycle produced a usable traj
    best_idx: torch.Tensor       # (S,) int64 chosen candidate (sorted order)
    candidate_states: torch.Tensor  # (S, 6, H, 8)
    solved: torch.Tensor         # (S, 6) bool
    prim_res: torch.Tensor       # (S, 6)
    # (S,) bool: the scenario's shared factor was refreshed this cycle
    # (the shared-factor path only; None elsewhere)
    refreshed: Optional[torch.Tensor] = None


def init_planner_state(cfg: PlannerConfig, batch: int,
                       device="cpu") -> PlannerState:
    H, W = cfg.horizon, cfg.mpc_window
    S = batch
    kw = dict(dtype=torch.float32, device=device)
    fac = {}
    if cfg.solver.factor_reuse_cycles > 1:
        # identity-preconditioner placeholder until the first refresh;
        # obs scaling sized for K slots + 1 second-series slot, where
        # static clustering appends cluster_slots rows to every QP
        n = cfg.num_vars
        K = cfg.max_obstacles + (cfg.cluster_slots if cfg.static_clustering
                                 else 0)
        fac = dict(
            fac_d=torch.ones((S, n), **kw),
            fac_e=qplib.ConVec(eq=torch.ones((S, H, 8), **kw),
                               sb=torch.ones((S, H, 8), **kw),
                               cb=torch.ones((S, W, 5), **kw),
                               obs=torch.ones((S, W, K + 1), **kw)),
            fac_c=torch.ones((S,), **kw),
            # admm_factor's dtype: bf16 with SolverConfig.minv_dtype "bf16"
            fac_minv=torch.eye(n, **kw).expand(S, n, n).to(
                torch.bfloat16 if cfg.solver.minv_dtype == "bf16"
                else torch.float32).clone())
        if cfg.solver.factor_drift_refresh > 0:
            # zeros force a refresh on the first drift check (the relative
            # drift against an empty snapshot is large)
            fac["fac_gref"] = torch.zeros((S, W, K + 1, 3), **kw)
    return PlannerState(
        states_sol=torch.zeros((S, H, 8), **kw),
        controls_sol=torch.zeros((S, W, 5), **kw),
        first_time=torch.ones((S,), dtype=torch.bool, device=device),
        has_solution=torch.zeros((S,), dtype=torch.bool, device=device),
        last_ref_start=torch.zeros((S,), dtype=torch.int32, device=device),
        xref=torch.zeros((S, H, 3), **kw),
        rho=torch.full((S,), cfg.solver.rho, **kw),
        **fac,
    )


def reference_window(cfg: PlannerConfig, input_traj: torch.Tensor,
                     traj_len, curr_pos: torch.Tensor,
                     last_start: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """getReferenceTraj (mpcPlanner.cpp:1199-1231): windowed nearest-point
    search <= 3 s ahead of the monotone last start index; pads with the
    last waypoint. input_traj (L, 3) shared by the batch with traj_len a
    Python int, or (S, L, 3) one per scenario (goal mode) with traj_len
    (S,) on the device; curr_pos (S, 3); last_start (S,). Returns
    (xref (S, H, 3), new_start (S,))."""
    L = input_traj.shape[-2]
    dev = curr_pos.device
    max_fwd = int(round(cfg.max_ref_forward_time / cfg.ts))
    idxs = last_start.to(torch.int64)[:, None] + torch.arange(max_fwd, device=dev)
    shared = input_traj.dim() == 2
    if not shared:
        traj_len = traj_len.to(torch.int64)[:, None]

    def take(i):
        i = torch.clamp(i, 0, L - 1)
        if shared:
            return input_traj[i]
        return torch.gather(input_traj, 1, i[..., None].expand(i.shape + (3,)))

    in_range = idxs < traj_len
    pts = take(idxs)                                             # (S, F, 3)
    d = torch.linalg.vector_norm(pts - curr_pos[:, None, :], dim=-1)
    d = torch.where(in_range, d, torch.full_like(d, float("inf")))
    start = last_start.to(torch.int64) + torch.argmin(d, dim=-1)
    ref_idx = start[:, None] + torch.arange(cfg.horizon, device=dev)
    if shared:
        ref_idx = torch.clamp(ref_idx, 0, traj_len - 1)
    else:
        ref_idx = torch.minimum(torch.clamp(ref_idx, min=0), traj_len - 1)
    xref = take(ref_idx)
    return xref, start.to(torch.int32)


def find_closest_obstacle(cfg: PlannerConfig, state: PlannerState,
                          curr_pos: torch.Tensor, nominal_pos: torch.Tensor,
                          visible: torch.Tensor) -> torch.Tensor:
    """findClosestObstacle (mpcPlanner.cpp:663-708). nominal_pos (S, O, 3)
    is predPos[i][FORWARD][0]. Returns (S,) int64."""
    d = torch.linalg.vector_norm(curr_pos[:, None, :] - nominal_pos, dim=-1)
    p0 = state.states_sol[:, 0, 0:3]
    p1 = state.states_sol[:, 1, 0:3]
    traj_dir = torch.atan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])
    obs_dir = torch.atan2(nominal_pos[..., 1] - p0[:, None, 1],
                          nominal_pos[..., 0] - p0[:, None, 0])
    d_sol = torch.linalg.vector_norm(p0[:, None, :] - nominal_pos, dim=-1)
    a = cfg.direction_weight_a
    directional = d_sol * (a - torch.cos(traj_dir[:, None] - obs_dir))
    use_d = (state.first_time | ~state.has_solution)[:, None]
    score = torch.where(use_d, d, directional)
    score = torch.where(visible, score, torch.full_like(score, float("inf")))
    return torch.argmin(score, dim=-1)


def intent_comb_weights(prob: torch.Tensor) -> torch.Tensor:
    """Per-combo weights of the closest obstacle (getIntentComb :722-727 /
    evaluateTraj :868-873): [STOP, LEFT, RIGHT, FORWARD, max(L,F), max(R,F)].
    prob (S, 4) -> (S, 6)."""
    return torch.stack([
        prob[:, STOP], prob[:, LEFT], prob[:, RIGHT], prob[:, FORWARD],
        torch.maximum(prob[:, LEFT], prob[:, FORWARD]),
        torch.maximum(prob[:, RIGHT], prob[:, FORWARD]),
    ], dim=-1)


# combo -> (first series intent, second series intent or -1)
_COMBO_FIRST = (STOP, LEFT, RIGHT, FORWARD, LEFT, RIGHT)
_COMBO_SECOND = (-1, -1, -1, -1, FORWARD, FORWARD)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[s, idx[s, ...]] for a per-scenario index tensor."""
    S = t.shape[0]
    ar = torch.arange(S, device=t.device).reshape((S,) + (1,) * (idx.dim() - 1))
    return t[ar, idx]


def build_candidates(cfg: PlannerConfig, pred: Prediction,
                     visible: torch.Tensor, closest: torch.Tensor):
    """Per-candidate obstacle series (getIntentComb :710-769).

    Slot layout (K = O + 1): slot j<O holds obstacle j (the closest one
    carries the combo's first intent series, the others their argmax
    intent); slot O holds the combo's second series of the closest
    obstacle (combos 4/5 only).

    Returns pos (S, 6, H, K, 3), size (S, 6, H, K, 3), active (S, 6, K).
    """
    S, O = pred.pos.shape[0], pred.pos.shape[1]
    H = cfg.horizon
    dev = pred.pos.device
    am = torch.argmax(pred.intent_prob, dim=-1)                   # (S, O)
    idx = am[:, :, None, None, None].expand(-1, -1, 1, pred.pos.shape[3], 3)
    base_pos = torch.gather(pred.pos, 2, idx)[:, :, 0, :H]        # (S,O,H,3)
    base_size = torch.gather(pred.size, 2, idx)[:, :, 0, :H]

    cl_pos = _rows(pred.pos, closest)[:, :, :H]                   # (S,4,H,3)
    cl_size = _rows(pred.size, closest)[:, :, :H]

    first = constant(_COMBO_FIRST, dev, torch.int64)
    second = constant(tuple(max(c, 0) for c in _COMBO_SECOND), dev,
                      torch.int64)
    has_second = constant(tuple(c >= 0 for c in _COMBO_SECOND), dev,
                          torch.bool)
    first_pos, first_size = cl_pos[:, first], cl_size[:, first]   # (S,6,H,3)
    second_pos, second_size = cl_pos[:, second], cl_size[:, second]

    is_cl = (torch.arange(O, device=dev)[None, :] == closest[:, None])
    is_cl = is_cl[:, None, :, None, None]                         # (S,1,O,1,1)
    pos = torch.where(is_cl, first_pos[:, :, None], base_pos[:, None])
    size = torch.where(is_cl, first_size[:, :, None], base_size[:, None])
    pos = torch.cat([pos, second_pos[:, :, None]], dim=2)         # (S,6,O+1,H,3)
    size = torch.cat([size, second_size[:, :, None]], dim=2)

    vis_cl = _rows(visible, closest)                              # (S,)
    active = visible[:, None, :].expand(S, 6, O)
    active = torch.cat(
        [active, (has_second[None, :] & vis_cl[:, None])[..., None]], dim=-1)
    return (pos.transpose(2, 3), size.transpose(2, 3),
            active.to(pos.dtype))


def _scores(cfg: PlannerConfig, cand_states, prev_states, have_prev, xref,
            obs_pos, obs_size, obs_active):
    """getTrajectoryScore components (mpcPlanner.cpp:771-848).

    cand_states (S,6,H,8); prev_states (S,H,8); have_prev (S,);
    xref (S,H,3); obs_pos/size (S,6,H,K,3); obs_active (S,6,K)."""
    H = cfg.horizon
    p = cand_states[..., 0:3]                                     # (S,6,H,3)

    ncs = min(cfg.consistency_steps, H)
    dc = torch.linalg.vector_norm(
        p[:, :, :ncs] - prev_states[:, None, :ncs, 0:3], dim=-1)
    consistency = torch.clamp(torch.mean(dc, dim=-1), min=0.1)
    consistency = torch.where(have_prev[:, None], consistency,
                              torch.zeros_like(consistency))

    dd = torch.linalg.vector_norm(p - xref[:, None], dim=-1)
    detour = torch.clamp(torch.mean(dd, dim=-1), min=0.1)

    pz0 = torch.cat([p[..., 0:2], torch.zeros_like(p[..., 2:3])], dim=-1)
    op = torch.cat([obs_pos[..., 0:2], torch.zeros_like(obs_pos[..., 2:3])],
                   dim=-1)
    d = torch.linalg.vector_norm(pz0[:, :, :, None, :] - op, dim=-1)  # (S,6,H,K)
    max_size = torch.sqrt(obs_size[..., 0] ** 2 + obs_size[..., 1] ** 2)
    w = 1.0 - torch.tanh(
        0.5493061443340549 / (cfg.dynamic_safety_dist + max_size) * d)
    w = w * obs_active[:, :, None, :]
    tw = torch.sum(w, dim=-1)
    step_score = torch.sum(d * w, dim=-1) / torch.clamp(tw, min=1e-12)
    safety = torch.mean(step_score, dim=-1)
    return consistency, detour, safety


def evaluate_candidates(cfg: PlannerConfig, consistency, detour, safety,
                        weights_sorted, solved):
    """evaluateTraj (mpcPlanner.cpp:850-887): batch-average-normalized
    scores, weighted by the position-permuted intent weights; masked
    argmax over successful candidates. All (S, 6); returns (S,)."""
    ok = solved.to(consistency.dtype)
    n_ok = torch.clamp(torch.sum(ok, dim=-1), min=1.0)

    def avg(v):
        return (torch.sum(v * ok, dim=-1) / n_ok)[:, None]

    cons = torch.where(consistency > 0,
                       avg(consistency) / torch.clamp(consistency, min=1e-12),
                       torch.zeros_like(consistency))
    det = avg(detour) / torch.clamp(detour, min=1e-12)
    saf = safety / torch.clamp(avg(safety), min=1e-12)
    weighted = weights_sorted * (cons + det + saf)
    weighted = torch.where(solved, weighted,
                           torch.full_like(weighted, float("-inf")))
    return torch.argmax(weighted, dim=-1)


def _pick(qps: qplib.QPData, idx: torch.Tensor) -> qplib.QPData:
    """The QP of candidate idx[s] of each scenario from an (S, 6) batch."""
    return qplib.QPData(*(v.map(lambda g: _rows(g, idx))
                          if isinstance(v, qplib.ConVec) else _rows(v, idx)
                          for v in qps))


def _where_s(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with a (S,) condition against (S, ...) tensors."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def fov_halfspaces(curr_pos: torch.Tensor, curr_yaw: torch.Tensor,
                   fov_deg: float = 87.0):
    """updateFovParam (mpcPlanner.cpp:274-295): the two half-planes that
    bound the camera wedge. curr_pos (S, 3), curr_yaw (S,); returns
    (half_max, half_min), each (S, 3) as (a, b, c)."""
    half = fov_deg / 2.0 * math.pi / 180.0
    max_a = curr_yaw - half
    min_a = curr_yaw + half
    a1, b1 = torch.sin(max_a), -torch.cos(max_a)
    c1 = a1 * curr_pos[:, 0] + b1 * curr_pos[:, 1]
    a2, b2 = torch.sin(min_a), -torch.cos(min_a)
    c2 = a2 * curr_pos[:, 0] + b2 * curr_pos[:, 1]
    return (torch.stack([a1, b1, c1], dim=-1),
            torch.stack([a2, b2, c2], dim=-1))


def _pad_slots(a: torch.Tensor, fill: float, dim: int) -> torch.Tensor:
    """Two more obstacle slots of `fill` on axis `dim` (the FOV rows')."""
    shape = list(a.shape)
    shape[dim] = 2
    return torch.cat([a, torch.full(shape, fill, dtype=a.dtype,
                                    device=a.device)], dim=dim)


def _append_static(cfg: PlannerConfig, static_obs, use_obs, qpos, qsize,
                   qyaw, qdyn, qact):
    """The static boxes' C slots after the dynamic ones, the same in every
    candidate: qpos/qsize (S, 6, W, K, 3), qyaw/qdyn (S, 6, W, K), qact
    (S, 6, K) -> K + C slots."""
    sc, ss, sy, sa = static_obs
    S, C = sc.shape[:2]
    cand, W = qpos.shape[1], qpos.shape[2]
    shape = (S, cand, W, C)
    spos = sc[:, None, None].expand(shape + (3,))
    ssize = (ss / 2.0 + cfg.static_safety_dist)[:, None, None].expand(
        shape + (3,))
    sact = sa.to(qact.dtype) * use_obs.to(qact.dtype)[:, None]
    return (torch.cat([qpos, spos], dim=3), torch.cat([qsize, ssize], dim=3),
            torch.cat([qyaw, sy[:, None, None].expand(shape)], dim=3),
            torch.cat([qdyn, torch.zeros(shape, dtype=qdyn.dtype,
                                         device=qdyn.device)], dim=3),
            torch.cat([qact, sact[:, None].expand(S, cand, C)], dim=2))


def make_plan_with_pred(cfg: PlannerConfig, state: PlannerState,
                        curr_pos: torch.Tensor, curr_vel: torch.Tensor,
                        input_traj: torch.Tensor, traj_len,
                        pred: Prediction, visible: torch.Tensor,
                        max_iter: Optional[int] = None,
                        cycle_idx: Optional[int] = None,
                        curr_yaw: Optional[torch.Tensor] = None,
                        dyn_safety: Optional[torch.Tensor] = None,
                        static_obs=None, solve_override=None) -> PlanOutput:
    """One replanning cycle (mpcCB body + makePlanWithPred) for a batch
    of S scenarios; the 6 intent-combination QPs of each are one batch.

    curr_pos/curr_vel (S, 3); input_traj and traj_len as
    reference_window takes them; pred over (S, O);
    visible (S, O) bool; cycle_idx is the Python cycle counter that
    drives the shared-factor refresh.
    curr_yaw (S,): adds the two FOV half-space rows in two more slots
    (the reference's 3-argument updateCurrStates; the DYNUS benchmark
    uses the 2-argument form) and refreshes the shared factor every cycle.
    dyn_safety (S,): the per-scenario dynamic safety distance of the QP's
    obstacle rows (the engine's goal-approach relaxation); scoring keeps
    cfg.dynamic_safety_dist.
    static_obs: (centroid (S, C, 3), size (S, C, 3), yaw (S, C), active
    (S, C)) rotated static boxes from obstacle clustering, appended as the
    same C rows to every candidate QP with the static safety distance, the
    static slack column (u[4], obs_dyn 0) and the box's yaw
    (updateObstacleParam :1186-1195); they count for the first-cycle
    test like visible obstacles and stay out of the scoring.
    solve_override: `(qps, warm6) -> ADMMResult` over (S, 6, ...) in place
    of the batched ADMM, everything else unchanged (the f64 oracle of
    benchmark/oracle_loop.py flies the closed loop through it)."""
    W = cfg.mpc_window
    S, O = pred.pos.shape[0], pred.pos.shape[1]
    dev = curr_pos.device

    # Cap the QP's obstacle slots at cfg.max_obstacles: keep the nearest
    # visible obstacles. A stable descending sort breaks ties (the
    # invisible ones all score -inf) by lower index first, as top_k does.
    if O > cfg.max_obstacles:
        d2 = torch.linalg.vector_norm(
            pred.pos[:, :, FORWARD, 0, 0:2] - curr_pos[:, None, 0:2], dim=-1)
        score = torch.where(visible, -d2, torch.full_like(d2, float("-inf")))
        _, order = torch.sort(score, dim=-1, descending=True, stable=True)
        nearest = order[:, :cfg.max_obstacles]
        pred = Prediction(pos=_rows(pred.pos, nearest),
                          size=_rows(pred.size, nearest),
                          intent_prob=_rows(pred.intent_prob, nearest))
        visible = _rows(visible, nearest)

    xref, new_start = reference_window(
        cfg, input_traj, traj_len, curr_pos, state.last_ref_start)

    any_visible = torch.any(visible, dim=-1)
    nominal = pred.pos[:, :, FORWARD, 0]                          # (S, O, 3)
    closest = find_closest_obstacle(cfg, state, curr_pos, nominal, visible)

    cand_pos, cand_size, cand_active = build_candidates(
        cfg, pred, visible, closest)                              # (S,6,H,K,*)

    # sort combos by (weight, combo-id) descending: a stable ascending
    # argsort reversed gives descending weight with descending id on ties
    w6 = intent_comb_weights(_rows(pred.intent_prob, closest))     # (S, 6)
    order = torch.argsort(w6, dim=-1, stable=True).flip(-1)
    cand_pos = _rows(cand_pos, order)
    cand_size = _rows(cand_size, order)
    cand_active = _rows(cand_active, order)

    # firstTime / no-pred: no obstacle constraints (makePlanWithPred :593-602)
    use_obs = (~state.first_time) & any_visible
    if static_obs is not None:
        use_obs = use_obs | ((~state.first_time)
                             & torch.any(static_obs[3], dim=-1))
    cand_active = cand_active * use_obs.to(cand_active.dtype)[:, None, None]

    # obstacle param conversion (updateObstacleParam :1148-1197):
    # semi-axes = size/2 + dynamic safety; yaw 0; all dynamic.
    ds = (cfg.dynamic_safety_dist if dyn_safety is None
          else dyn_safety[:, None, None, None, None])
    qsize = cand_size[:, :, :W] / 2.0 + ds
    qpos = cand_pos[:, :, :W]
    qact = cand_active
    qyaw = torch.zeros(qpos.shape[:-1], dtype=qpos.dtype, device=dev)
    qdyn = torch.ones(qpos.shape[:-1], dtype=qpos.dtype, device=dev)
    if static_obs is not None:
        qpos, qsize, qyaw, qdyn, qact = _append_static(
            cfg, static_obs, use_obs, qpos, qsize, qyaw, qdyn, qact)
    fov = None
    if curr_yaw is not None:
        # two spare slots for the FOV rows (the QP only; scoring uses the
        # unpadded obstacle set)
        qpos, qsize = _pad_slots(qpos, 0.0, 3), _pad_slots(qsize, 1.0, 3)
        qyaw, qdyn = _pad_slots(qyaw, 0.0, 3), _pad_slots(qdyn, 1.0, 3)
        qact = _pad_slots(qact, 0.0, 2)
        half_max, half_min = fov_halfspaces(curr_pos, curr_yaw)
        fov = (half_max[:, None], half_min[:, None])
    qact = qact[:, :, None, :].expand(qpos.shape[:-1])

    # linearization points: previous solution states or current position
    lin = _where_s(state.has_solution, state.states_sol[:, :W, 0:3],
                   curr_pos[:, None, :].expand(S, W, 3))
    x0 = torch.cat([curr_pos, curr_vel], dim=-1)
    qps = qplib.build_qp(cfg, x0[:, None], xref[:, None], qpos, qsize, qyaw,
                         qdyn, qact, lin[:, None], fov_rows=fov)  # (S, 6)

    warm = _where_s(state.has_solution,
                    qplib.merge_z(state.states_sol, state.controls_sol),
                    torch.zeros((S, cfg.num_vars), dtype=qpos.dtype,
                                device=dev))
    warm6 = warm[:, None, :].expand(S, 6, cfg.num_vars).contiguous()
    rho = state.rho[:, None]          # broadcasts over the candidate axis

    fac_carry = None
    refreshed = None
    if solve_override is not None:
        res = solve_override(qps, warm6)
    elif cfg.solver.fused_solve:
        # the fleet kernel (ops/fleet.py): one launch solves every candidate
        # of every scenario; it factors each cycle and carries no factor,
        # so the carried fac_* fields pass through unchanged
        res = fleet_admm(cfg, qps, warm6, max_iter, rho_override=state.rho)
    elif cfg.solver.shared_factor and cfg.solver.woodbury_candidates:
        # the candidates differ from their mean QP only in the closest
        # obstacle's slot and the second-series slot (build_candidates):
        # factor the mean without those rows, every cycle (no reuse, as in
        # JAX), and solve each candidate exactly by a Woodbury correction
        qp_mean = candidate_mean(qps)
        diff_slots = torch.stack([closest, torch.full_like(
            closest, pred.pos.shape[1])], dim=-1)                 # (S, 2)
        act = qp_mean.obs_active                                  # (S, W, K)
        keep_slot = 1.0 - torch.nn.functional.one_hot(
            diff_slots, act.shape[-1]).amax(-2).to(act.dtype)     # (S, K)
        fac = admm_factor(cfg, qp_mean._replace(
            obs_active=act * keep_slot[:, None, :]),
            rho_override=state.rho)
        refreshed = torch.ones((S,), dtype=torch.bool, device=dev)
        res = admm_solve(cfg, qps, warm6, max_iter, rho_override=rho,
                         factor=fac, diff_slots=diff_slots)
    elif cfg.solver.shared_factor:
        # one factorization per scenario: the candidate-mean QP with union
        # obstacle activity; each candidate refines against its own M
        qp_mean = candidate_mean(qps)
        fac, fac_carry, refreshed = _shared_factor(cfg, state, qp_mean,
                                                   cycle_idx, curr_yaw)
        res = admm_solve(cfg, qps, warm6, max_iter, rho_override=rho,
                         factor=fac)
    else:
        # a factor per candidate, OSQP's own per-problem factorization (and
        # with adaptive_rho its in-solve rho rule)
        res = admm_solve(cfg, qps, warm6, max_iter, rho_override=rho)
    states6, _ = qplib.split_z(res.x, cfg)                        # (S,6,H,8)

    # Acceptance mirrors the reference: OSQP's status is never checked
    # (mpcPlanner.cpp:513-526); only numerically broken results are rejected.
    accepted = torch.isfinite(res.prim_res) & (res.prim_res < 1e3) \
        & torch.all(torch.isfinite(res.x), dim=-1)

    consistency, detour, safety = _scores(
        cfg, states6, state.states_sol, state.has_solution & ~state.first_time,
        xref, cand_pos, cand_size, cand_active)

    # weight permutation quirk: sorted position i gets weight of combo id i
    best = evaluate_candidates(cfg, consistency, detour, safety, w6, accepted)

    valid = torch.any(accepted, dim=-1)
    x_best = _rows(res.x, best)
    if cfg.solver.polish:
        # OSQP's polish on the chosen candidate only (the reference executes
        # only the winner): the exact active-set KKT point with compensated
        # residuals (ops/polish.py); a rejected polish returns the iterate
        x_best = polish(cfg, _pick(qps, best), x_best,
                        res.y.map(lambda g: _rows(g, best))).x
    Xb, Ub = qplib.split_z(x_best, cfg)

    def keep(new, old):
        return _where_s(valid, new, old)

    new_state = PlannerState(
        states_sol=keep(Xb, state.states_sol),
        controls_sol=keep(Ub, state.controls_sol),
        first_time=state.first_time & ~valid,
        has_solution=state.has_solution | valid,
        last_ref_start=new_start,
        xref=keep(xref, state.xref),
        # temporal rho: the chosen candidate's OSQP rho suggestion becomes
        # the next cycle's base penalty (scfg.rho on the fused path)
        rho=(_rows(res.rho_suggest, best) if cfg.solver.temporal_rho
             else state.rho),
        fac_d=fac_carry[0] if fac_carry is not None else state.fac_d,
        fac_e=fac_carry[1] if fac_carry is not None else state.fac_e,
        fac_c=fac_carry[2] if fac_carry is not None else state.fac_c,
        fac_minv=fac_carry[3] if fac_carry is not None else state.fac_minv,
        fac_gref=(fac_carry[4] if fac_carry is not None
                  and len(fac_carry) > 4 else state.fac_gref),
    )
    return PlanOutput(state=new_state, valid=valid, best_idx=best,
                      candidate_states=states6, solved=res.solved,
                      prim_res=res.prim_res, refreshed=refreshed)


def _shared_factor(cfg: PlannerConfig, state: PlannerState,
                   qp_mean: qplib.QPData, cycle_idx: Optional[int],
                   curr_yaw: Optional[torch.Tensor]):
    """The shared factor of each scenario's candidate-mean QP, and what the
    planner carries of it: (Factor, the carried fields or None, (S,) bool
    refreshed).

    Temporal reuse: the factor is refreshed every k-th cycle (a
    batch-uniform predicate, so a skipped factorization is not computed)
    and reused in between; CG against each candidate's own operator
    absorbs the drift. Without a carried factor (k = 1), a cycle counter,
    or with the FOV rows on, every call refreshes. With
    `factor_drift_refresh` > 0 a scenario also refreshes early when the
    relative Frobenius drift of its active obstacle gradients since its
    last refresh passes the threshold: JAX decides that per scenario under
    the scenario vmap, so here the fresh factor is computed for all and
    selected per scenario on the device (no host read)."""
    S, dev = qp_mean.q.shape[0], qp_mean.q.device
    k_reuse = cfg.solver.factor_reuse_cycles
    reuse = (k_reuse > 1 and state.fac_minv is not None
             and cycle_idx is not None and curr_yaw is None)
    if not reuse:
        fac = admm_factor(cfg, qp_mean, rho_override=state.rho)
        return fac, None, torch.ones((S,), dtype=torch.bool, device=dev)
    Kq = qp_mean.G.shape[-2]  # the carried obs scaling is sized for the maximum
    on_cycle = cycle_idx % k_reuse == 0
    drift_t = cfg.solver.factor_drift_refresh
    drift = drift_t > 0 and state.fac_gref is not None
    carried = Factor(D=state.fac_d,
                     E=state.fac_e._replace(obs=state.fac_e.obs[..., :Kq]),
                     c=state.fac_c, Minv=state.fac_minv)
    if drift:
        g_now = qp_mean.G * qp_mean.obs_active[..., None]
        gref = state.fac_gref[:, :, :Kq]
        dims = (-3, -2, -1)
        rel = torch.linalg.vector_norm(g_now - gref, dim=dims) \
            / (torch.linalg.vector_norm(gref, dim=dims) + 1e-6)
        refreshed = rel > drift_t
        if on_cycle:
            refreshed = torch.ones_like(refreshed)
    else:
        refreshed = torch.full((S,), on_cycle, dtype=torch.bool, device=dev)
    if on_cycle:
        fac = admm_factor(cfg, qp_mean, rho_override=state.rho)
    elif drift:
        fresh = admm_factor(cfg, qp_mean, rho_override=state.rho)
        fac = Factor(D=_where_s(refreshed, fresh.D, carried.D),
                     E=fresh.E.map(lambda a, b: _where_s(refreshed, a, b),
                                   carried.E),
                     c=_where_s(refreshed, fresh.c, carried.c),
                     Minv=_where_s(refreshed, fresh.Minv, carried.Minv))
    else:
        fac = carried
    e_pad = torch.cat([fac.E.obs, state.fac_e.obs[..., Kq:]], dim=-1)
    fac_carry = (fac.D, fac.E._replace(obs=e_pad), fac.c, fac.Minv)
    if drift:
        g_pad = torch.cat([g_now, state.fac_gref[:, :, Kq:]], dim=2)
        fac_carry += (_where_s(refreshed, g_pad, state.fac_gref),)
    return fac, fac_carry, refreshed


def make_plan(cfg: PlannerConfig, state: PlannerState,
              curr_pos: torch.Tensor, curr_vel: torch.Tensor,
              input_traj: torch.Tensor, traj_len,
              obs_pos: torch.Tensor, obs_vel: torch.Tensor,
              obs_size: torch.Tensor, visible: torch.Tensor,
              max_iter: Optional[int] = None,
              curr_yaw: Optional[torch.Tensor] = None,
              static_obs=None,
              dyn_safety: Optional[torch.Tensor] = None) -> PlanOutput:
    """Non-predictor replanning cycle (mpcPlanner::makePlan :543-569 fed
    by updateDynamicObstacles :316-341): each obstacle held at its current
    position and size over the horizon, one QP per scenario, solved by
    admm_solve with its own factor.

    obs_pos/vel/size (S, O, 3); the velocity is carried for parity with
    updateDynamicObstacles' stored fields (the QP uses pos and size).
    Every obstacle gets a slot (no max_obstacles cap, as in JAX).
    curr_yaw and dyn_safety as make_plan_with_pred takes them. The
    returned PlanOutput broadcasts the one QP's states over the 6
    candidate slots, candidate 0 carries its acceptance and best_idx is 0.
    static_obs: the clustered static boxes as make_plan_with_pred takes
    them, in slots O..O+C."""
    H, W = cfg.horizon, cfg.mpc_window
    S, O = obs_pos.shape[0], obs_pos.shape[1]
    dev, dt = obs_pos.device, obs_pos.dtype
    xref, new_start = reference_window(
        cfg, input_traj, traj_len, curr_pos, state.last_ref_start)

    C = 0 if static_obs is None else static_obs[0].shape[1]
    K = O + C + (2 if curr_yaw is not None else 0)
    ds = (cfg.dynamic_safety_dist if dyn_safety is None
          else dyn_safety[:, None, None])
    qpos = torch.zeros((S, W, K, 3), dtype=dt, device=dev)
    qpos[:, :, :O] = obs_pos[:, None]
    qsize = torch.ones((S, W, K, 3), dtype=dt, device=dev)
    qsize[:, :, :O] = (obs_size / 2.0 + ds)[:, None]
    qyaw = torch.zeros((S, W, K), dtype=dt, device=dev)
    qdyn = torch.ones((S, W, K), dtype=dt, device=dev)
    active = torch.zeros((S, W, K), dtype=dt, device=dev)
    active[:, :, :O] = visible[:, None].to(dt)
    use_obs = (~state.first_time) & torch.any(visible, dim=-1)
    if static_obs is not None:
        sc, ss, sy, sa = static_obs
        qpos[:, :, O:O + C] = sc[:, None]
        qsize[:, :, O:O + C] = (ss / 2.0 + cfg.static_safety_dist)[:, None]
        qyaw[:, :, O:O + C] = sy[:, None]
        qdyn[:, :, O:O + C] = 0.0
        active[:, :, O:O + C] = sa[:, None].to(dt)
        use_obs = use_obs | ((~state.first_time) & torch.any(sa, dim=-1))
    active = active * use_obs.to(dt)[:, None, None]
    fov = (fov_halfspaces(curr_pos, curr_yaw) if curr_yaw is not None
           else None)

    lin = _where_s(state.has_solution, state.states_sol[:, :W, 0:3],
                   curr_pos[:, None, :].expand(S, W, 3))
    x0 = torch.cat([curr_pos, curr_vel], dim=-1)
    qp = qplib.build_qp(cfg, x0, xref, qpos, qsize, qyaw, qdyn, active, lin,
                        fov_rows=fov)
    warm = _where_s(state.has_solution,
                    qplib.merge_z(state.states_sol, state.controls_sol),
                    torch.zeros((S, cfg.num_vars), dtype=dt, device=dev))
    res = admm_solve(cfg, qp, warm, max_iter, rho_override=state.rho)
    Xs, Us = qplib.split_z(res.x, cfg)
    accepted = torch.isfinite(res.prim_res) & (res.prim_res < 1e3) \
        & torch.all(torch.isfinite(res.x), dim=-1)

    def keep(new, old):
        return _where_s(accepted, new, old)

    new_state = PlannerState(
        states_sol=keep(Xs, state.states_sol),
        controls_sol=keep(Us, state.controls_sol),
        first_time=state.first_time & ~accepted,
        has_solution=state.has_solution | accepted,
        last_ref_start=new_start,
        xref=keep(xref, state.xref),
        rho=res.rho_suggest if cfg.solver.temporal_rho else state.rho,
        # the carried shared-factor fields pass through untouched (this
        # path factors every solve)
        fac_d=state.fac_d, fac_e=state.fac_e, fac_c=state.fac_c,
        fac_minv=state.fac_minv, fac_gref=state.fac_gref)
    solved = torch.zeros((S, 6), dtype=torch.bool, device=dev)
    solved[:, 0] = accepted
    return PlanOutput(state=new_state, valid=accepted,
                      best_idx=torch.zeros((S,), dtype=torch.int64,
                                           device=dev),
                      candidate_states=Xs[:, None].expand(S, 6, H, 8),
                      solved=solved,
                      prim_res=res.prim_res[:, None].expand(S, 6))


# ---------------------------------------------------------------------------
# Trajectory sampling (getPos/getVel/getAcc/getRef, mpcPlanner.cpp:1257-1324)
# ---------------------------------------------------------------------------

def _interp(rows: torch.Tensor, ts: float, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation with end clamping: rows (S, N, d), t (S, ...)
    float32 -> (S, ..., d). idx = floor(t/ts) clamped; next = min(idx+1, N-1)."""
    n = rows.shape[1]
    idx = torch.clamp(torch.floor(t / ts).to(torch.int64), 0, n - 1)
    nxt = torch.clamp(idx + 1, max=n - 1)
    frac = (t - idx.to(rows.dtype) * ts) / ts
    r0 = _rows(rows, idx)
    r1 = _rows(rows, nxt)
    return r0 + (r1 - r0) * frac[..., None]


def sample_pos(cfg: PlannerConfig, states_sol: torch.Tensor, t) -> torch.Tensor:
    return _interp(states_sol[..., 0:3], cfg.ts, t)


def sample_vel(cfg: PlannerConfig, states_sol: torch.Tensor, t) -> torch.Tensor:
    return _interp(states_sol[..., 3:6], cfg.ts, t)


def sample_acc(cfg: PlannerConfig, controls_sol: torch.Tensor, t) -> torch.Tensor:
    return _interp(controls_sol[..., 0:3], cfg.ts, t)


def sample_ref(cfg: PlannerConfig, xref: torch.Tensor, t) -> torch.Tensor:
    return _interp(xref, cfg.ts, t)
