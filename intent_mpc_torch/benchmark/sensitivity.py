"""How far one cycle's candidate solves move under a tiny perturbation.

    python -m intent_mpc_torch.benchmark.sensitivity [--device cpu] [--seed 1]
    python -m intent_mpc_torch.benchmark.sensitivity --oracle [--device cpu]

Runs cycle 0 of the default DYNUS closed loop for one seeded scenario,
then plans cycle 1 (the first cycle with obstacle rows) twice: once from
the carried state and once with the previous solution scaled by
(1 + 1e-7), about one float32 rounding step. Prints one JSON line with
the largest candidate-state difference after each iteration budget.
Growth with the budget means the fixed-iteration ADMM iterate of these
infeasible QPs amplifies rounding, so two correct implementations that
round differently (CPU and GPU, JAX and PyTorch) part ways after a few
constrained cycles.

`--oracle` measures the same for the f64 oracle in the loop
(benchmark/oracle_loop.py) at its CLI's DYNUS widths (32 QP slots): 2
seeds fly 5 cycles twice, once as they are and once with every entry of
the oracle's float64 inputs (A, l, u, q) moved by a relative 2^-24 (a
float32 rounding step) of seeded sign. Prints the largest position
difference per cycle: the spread that float32 rounding of the QPs (the
card's against the CPU's) leaves after the oracle.
"""

from __future__ import annotations

import argparse
import json

import torch

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models import detector as det
from intent_mpc_torch.models import mpc as mpclib
from intent_mpc_torch.models import predictor as predlib
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import obstacle_state, straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device


def measure(device=None, seed: int = 1, rel: float = 1e-7,
            budgets=(10, 25, 50, 100)) -> dict:
    dev = resolve_device(device)
    cfg = IntentMPCConfig()
    scen = sh.stack_scenarios(cfg, [seed], device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device=dev)
    occ = empty_grid(dev)
    carry = cl.init_carry(cfg, scen, device=dev)
    carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, 0)

    # cycle 1 inputs, as episode_step builds them
    t0 = torch.full((), 1.0, device=dev) * (cfg.engine.control_dt
                                            * cfg.engine.ticks_per_cycle)
    obs0, _ = obstacle_state(scen, t0)
    d = det.hist_push(det.fd_update(cfg.detector, carry.detector, obs0, t0),
                      obs0)
    ph, vh, ah, sz, hl, vis = det.query_history(cfg.detector, d, scen.bbox,
                                                carry.pos)
    pred = predlib.predict(cfg.predictor, ph, vh, ah, sz, hl, occ)
    st = carry.planner
    nudged = st._replace(states_sol=st.states_sol * (1.0 + rel))

    out = {"seed": seed, "rel_perturbation": rel, "device": str(dev),
           "max_candidate_state_diff": {}}
    for iters in budgets:
        a = mpclib.make_plan_with_pred(cfg.planner, st, carry.pos, carry.vel,
                                       ref, ref.shape[0], pred, vis, iters,
                                       cycle_idx=1)
        b = mpclib.make_plan_with_pred(cfg.planner, nudged, carry.pos,
                                       carry.vel, ref, ref.shape[0], pred,
                                       vis, iters, cycle_idx=1)
        diff = (a.candidate_states - b.candidate_states).abs().max()
        out["max_candidate_state_diff"][str(iters)] = float(diff)
    return out


def measure_oracle(device=None, seeds=(0, 1), cycles: int = 5,
                   rel: float = 2.0 ** -24) -> dict:
    """Per-cycle max |pos| difference of the oracle loop under a relative
    `rel` nudge of the oracle's inputs (see the module docstring)."""
    import numpy as np

    from intent_mpc_torch.benchmark import oracle_loop as ol
    from intent_mpc_torch.oracle import native

    dev = resolve_device(device)
    cfg = ol.build_cfg(ol.parse_args([]))
    over = ol.make_oracle_override(cfg.planner)
    hdiag = ol.qplib.hessian_diag(cfg.planner).double().numpy()
    rng = np.random.default_rng(0)

    def nudged(qps, warm6):
        A, l, u, q, warm = ol.host_problems(cfg.planner, qps, warm6)
        A, l, u, q = (a * (1.0 + rel * rng.choice([-1.0, 1.0], a.shape))
                      for a in (A, l, u, q))
        xs, ys, _, _ = native.solve_qp_batch(hdiag, q, A, l, u, max_iter=150,
                                             eps=1e-3, adapt_interval=50,
                                             x0=warm)
        return ol.device_result(cfg.planner, qps, xs, ys,
                                ol.primal_residual(A, l, u, xs), False)

    scen = sh.stack_scenarios(cfg, list(seeds), device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device=dev)
    occ = empty_grid(dev)
    a = b = cl.init_carry(cfg, scen, device=dev)
    diffs = []
    for i in range(cycles):
        a, pa = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, a, i,
                                solve_override=over)
        b, pb = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, b, i,
                                solve_override=nudged)
        diffs.append(float((pa - pb).abs().max()))
    return {"seeds": list(seeds), "cycles": cycles, "rel_perturbation": rel,
            "max_obstacles": cfg.planner.max_obstacles, "device": str(dev),
            "max_pos_diff_per_cycle": diffs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--oracle", action="store_true",
                    help="nudge the f64 oracle's inputs in its loop")
    args = ap.parse_args()
    if args.oracle:
        print(json.dumps(measure_oracle(args.device)))
    else:
        print(json.dumps(measure(args.device, args.seed)))


if __name__ == "__main__":
    main()
