"""Scenario-batch rollouts on one device (port of the single-device parts
of intent_mpc_tpu/parallel/sharding.py).

The scale axis is the scenario batch: S closed-loop environments step
together on one GPU. Multi-GPU sharding is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.world import Scenario, generate_scenario_numpy
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device


def stack_scenarios(cfg: IntentMPCConfig, seeds, device=None) -> Scenario:
    """Generate seeded scenarios on the host and stack them on `device`
    (the GPU by default) as one (S, N, ...) batch."""
    dev = resolve_device(device)
    scs = [generate_scenario_numpy(int(s), cfg.world) for s in seeds]
    if not scs:
        raise ValueError("need at least one seed/trial")
    return Scenario(**{k: torch.as_tensor(np.stack([s[k] for s in scs]),
                                          device=dev)
                       for k in Scenario._fields})


def batch_rollout(cfg: IntentMPCConfig, scenarios: Scenario,
                  ref_traj: torch.Tensor, traj_len,
                  solver_iters: Optional[int] = None,
                  num_cycles: Optional[int] = None,
                  record_paths: bool = False,
                  occ=None, device=None):
    """Run a batch of episodes on one device (the GPU by default).

    Returns (per-scenario Metrics batch, aggregate dict of fleet
    statistics[, paths (S, C, 3) when record_paths])."""
    carry, paths = cl.run_episode(cfg, scenarios, ref_traj, traj_len, occ=occ,
                                  solver_iters=solver_iters,
                                  num_cycles=num_cycles,
                                  record_path=record_paths, device=device)
    m = carry.metrics
    agg = {
        "episodes": float(m.goal_reached.shape[0]),
        "goals": float(torch.sum(m.goal_reached.to(torch.float32))),
        "collisions": float(torch.sum(m.collision.to(torch.float32))),
        "path_length_sum": float(torch.sum(m.path_length)),
        "travel_time_sum": float(torch.sum(m.travel_time)),
        "min_dist_min": float(torch.min(m.min_obstacle_dist)),
        "solve_attempts": float(torch.sum(m.solve_attempts.to(torch.float32))),
        "solve_successes": float(torch.sum(
            m.solve_successes.to(torch.float32))),
    }
    if record_paths:
        return m, agg, paths
    return m, agg


def aggregate_summary(agg: dict) -> dict:
    n = max(agg["episodes"], 1.0)
    return {
        "num_episodes": int(n),
        "success_rate": agg["goals"] / n,
        "collision_rate": agg["collisions"] / n,
        "avg_path_length": agg["path_length_sum"] / n,
        "avg_travel_time": agg["travel_time_sum"] / max(agg["goals"], 1.0),
        "min_obstacle_distance": agg["min_dist_min"],
        "solver_success_rate": agg["solve_successes"]
        / max(agg["solve_attempts"], 1.0),
    }
