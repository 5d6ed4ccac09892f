"""The port's entry points: one closed-loop cycle at a tiny size (the
counterpart of the JAX package's `__graft_entry__.entry()`), and the
multi-device dry run of the torch.distributed fleet
(`__graft_entry__.dryrun_multichip`).

    from intent_mpc_torch.entry import entry, dryrun_multichip
    fn, args = entry()              # on the GPU; entry("cpu") on the CPU
    pos, vel = fn(*args)
    dryrun_multichip(1)             # one rank per GPU over NCCL
    dryrun_multichip(2, backend="gloo", device="cpu")   # two CPU ranks
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import (build_from_static_obstacles,
                                               empty_grid)
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import launch
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.config import IntentMPCConfig, small_config
from intent_mpc_torch.utils.device import resolve_device

SOLVER_ITERS = 10
# what a fleet program may send per rollout: the two statistic reductions
COLLECTIVES = {"all-reduce": 2}
COLLECTIVE_BYTES_MAX = 100
INVENTORY_CYCLES = 2    # cycles of each inventoried rollout


def tiny_config():
    """The JAX entry's config: 4 obstacles, horizon 8, a 0.5 s timeout,
    goal (6, 0, 2)."""
    return small_config(num_obstacles=4, horizon=8, timeout=0.5,
                        max_obstacles=4, hist=8).replace(goal=(6.0, 0.0, 2.0))


def tiny_setup(device):
    """The JAX entry's setup as one scenario (S = 1) on a 0.5 m
    reference."""
    cfg = tiny_config()
    scen = sh.stack_scenarios(cfg, [0], device=device)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=0.5,
                                 device=device)
    return cfg, scen, ref


def entry(device=None):
    """(fn, args): fn(carry, cycle_idx) runs one full MPC replanning cycle
    (detector history, intent prediction, the 6-candidate batched ADMM
    solve at SOLVER_ITERS iterations, scoring and selection, the control
    ticks) and returns the new (pos (1, 3), vel (1, 3)); args is the fresh
    carry and cycle 0. Runs on the GPU unless `device` names another."""
    dev = resolve_device(device)
    cfg, scen, ref = tiny_setup(dev)
    occ = empty_grid(dev)
    traj_len = ref.shape[0]

    def fn(carry, cycle_idx):
        new_carry, _ = cl.episode_step(cfg, scen, ref, traj_len, occ, carry,
                                       cycle_idx, solver_iters=SOLVER_ITERS)
        return new_carry.pos, new_carry.vel

    return fn, (cl.init_carry(cfg, scen, device=dev), 0)


def dryrun_multichip(n_devices: int, backend: str = "nccl", device=None,
                     timeout: float = 1800.0) -> dict:
    """Fly a fleet of `n_devices` ranks, one process each
    (parallel/launch.spawn), and check it behaves and communicates only
    its statistics (dryrun_rank). backend "nccl" puts rank r on cuda:r;
    "gloo" with device "cpu" runs on the CPU. Returns rank 0's summary;
    raises if any check of any rank fails."""
    if backend == "nccl":
        resolve_device(device)          # the card, or raise before spawning
    return launch.spawn("intent_mpc_torch.entry:dryrun_rank", n_devices,
                        backend,
                        device=None if device is None else str(device),
                        timeout=timeout)[0]


def _check(ok, what):
    if not ok:
        raise RuntimeError("dryrun_multichip: %s" % (what,))


def _check_inventory(name, rep):
    _check(rep["counts"] == COLLECTIVES
           and rep["total_bytes"] <= COLLECTIVE_BYTES_MAX,
           (name, "collectives beyond the two statistic reductions", rep))


def dryrun_rank(fleet: sh.Fleet, production: bool = True) -> dict:
    """One rank of dryrun_multichip (JAX __graft_entry__.py:39-148).

    The behavioural check: 2 scenarios per rank of the entry's config,
    the 3 m clear goal, obstacles moved 40 m off the corridor, 30 ADMM
    iterations, 40 cycles (4 s of flight): every episode reaches the goal
    with no collision and a travel time above 0. The inventory
    (sharding.collective_report) of the same program, run for 2 cycles
    under the profiler, must be exactly the two all-reduces, at most 100
    bytes. Then the production inventories, each on one scenario per
    rank for 2 cycles: the base program at IntentMPCConfig() (horizon
    30, 64 slots, 200 obstacles; its statistics must count the fleet's
    episodes and some solves), goal mode with ref_mode "global" over a
    static map with the keys of jax.random.split(PRNGKey(7), n), and the
    real detector. production=False stops after the toy flight's
    inventory."""
    n = fleet.world
    dev = fleet.device
    cfg = tiny_config().replace(goal=(3.0, 0.0, 2.0))
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, timeout=4.0))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=0.25,
                                 device=dev)
    scen = sh.stack_scenarios_global(cfg, range(2 * n), fleet)
    scen = scen._replace(origin=scen.origin + torch.tensor(
        [0.0, 40.0, 0.0], device=dev))
    metrics, agg = sh.batch_rollout(cfg, scen, ref, ref.shape[0],
                                    mesh=fleet, solver_iters=30,
                                    num_cycles=40)
    _check(metrics.goal_reached.shape[0] == 2, metrics.goal_reached.shape)
    _check(agg["episodes"] == 2 * n, agg)
    summary = sh.aggregate_summary(agg)
    _check(summary["success_rate"] == 1.0, summary)
    _check(summary["avg_travel_time"] > 0.0, summary)
    _check(summary["collision_rate"] == 0.0, summary)
    # the same program's inventory, over INVENTORY_CYCLES cycles (the
    # collectives are per rollout; the profiler costs ~7x a cycle's time)
    _, rep = sh.collective_report(cfg, scen, ref, ref.shape[0], fleet,
                                  solver_iters=30,
                                  num_cycles=INVENTORY_CYCLES)
    _check_inventory("toy", rep)
    out = dict(summary, world=n, rank=fleet.rank, device=str(dev),
               backend=str(torch.distributed.get_backend())
               if fleet.group is not None else None,
               collective_ops=rep["counts"], collective_bytes=rep["total_bytes"])
    if not production:
        return out

    prod = IntentMPCConfig()
    _check(prod.planner.horizon == 30 and prod.planner.max_obstacles == 64,
           "production config")
    ref_p = straight_line_ref_traj(prod.start, prod.goal, spacing=2.5,
                                   device=dev)
    scen_p = sh.stack_scenarios_global(prod, range(n), fleet)
    (_, agg_p), rep_base = sh.collective_report(
        prod, scen_p, ref_p, ref_p.shape[0], fleet,
        num_cycles=INVENTORY_CYCLES)
    _check_inventory("base", rep_base)
    _check(agg_p["episodes"] == n and agg_p["solve_attempts"] > 0, agg_p)

    goal_cfg = prod.replace(
        goal=(12.0, 0.0, 2.0),
        engine=dataclasses.replace(prod.engine, goal_mode=True,
                                   ref_mode="global", ref_vel=1.5,
                                   ref_bounds_margin=2.5))
    grid = build_from_static_obstacles(
        (-1.0, -6.0, 0.0), (15.0, 12.0, 4.6), 0.2,
        np.array([[6.0, 2.0, 2.2]], np.float32),
        np.array([[0.6, 3.0, 4.4]], np.float32),
        inflation=(0.3, 0.3, 0.2), device=dev)
    ref_g = torch.zeros((128, 3), device=dev)
    keys = prng.split(prng.prng_key(7, device=dev), n)
    _, rep_goal = sh.collective_report(goal_cfg, scen_p, ref_g,
                                       ref_g.shape[0], fleet,
                                       num_cycles=INVENTORY_CYCLES,
                                       occ=grid, ref_keys=keys)
    _check_inventory("goal_mode_global", rep_goal)

    real_cfg = prod.replace(engine=dataclasses.replace(
        prod.engine, use_fake_detector=False))
    _, rep_real = sh.collective_report(real_cfg, scen_p, ref_p,
                                       ref_p.shape[0], fleet,
                                       num_cycles=INVENTORY_CYCLES)
    _check_inventory("real_detector", rep_real)

    out["production"] = {
        "horizon": prod.planner.horizon,
        "obstacle_slots": prod.planner.max_obstacles,
        "world_obstacles": prod.world.num_obstacles,
        "solver_iters": prod.planner.solver.max_iter,
        "base": {"collectives": rep_base["counts"],
                 "bytes": rep_base["total_bytes"],
                 "episodes": int(agg_p["episodes"]),
                 "solve_attempts": int(agg_p["solve_attempts"])},
        "goal_mode_global": {"collectives": rep_goal["counts"],
                             "bytes": rep_goal["total_bytes"]},
        "real_detector": {"collectives": rep_real["counts"],
                          "bytes": rep_real["total_bytes"]},
    }
    return out
