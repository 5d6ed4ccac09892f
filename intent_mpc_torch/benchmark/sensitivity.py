"""How far one cycle's candidate solves move under a tiny perturbation.

    python -m intent_mpc_torch.benchmark.sensitivity [--device cpu] [--seed 1]

Runs cycle 0 of the default DYNUS closed loop for one seeded scenario,
then plans cycle 1 (the first cycle with obstacle rows) twice: once from
the carried state and once with the previous solution scaled by
(1 + 1e-7), about one float32 rounding step. Prints one JSON line with
the largest candidate-state difference after each iteration budget.
Growth with the budget means the fixed-iteration ADMM iterate of these
infeasible QPs amplifies rounding, so two correct implementations that
round differently (CPU and GPU, JAX and PyTorch) part ways after a few
constrained cycles.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    print(json.dumps(measure(args.device, args.seed)))


if __name__ == "__main__":
    main()
