"""Goal-mode input-trajectory composition at fleet scale: the straight line
against [RRT ->] corridor min-snap (mpcNavigation.cpp:239-290); port of
intent_mpc_tpu/benchmark/ref_modes.py.

Two worlds:
  * the wall world (default): a wall spans the corridor at mid-flight with
    one gap whose position is seed-drawn; the wall exists only in the
    static occupancy map (the reference's prebuilt-map mode), so the MPC's
    obstacle rows never see it. Straight-line (linspace) input trajectories
    drive into the replan-check monitor's stop+replan loop; the composed
    global-planner mode (engine/ref_builder.py) routes the min-snap input
    trajectory through the gap.
  * --dynus: the DYNUS protocol (200 obstacles, statics in a prebuilt
    per-seed occupancy map and as detector rows, the dynamic trefoil field
    through the GT detector, 105 m), flown in goal mode with the composed
    "global" input trajectory and the straight "linspace" one.

    python -m intent_mpc_torch.benchmark.ref_modes --seeds 0 1 2 3 4 5 6 7 \\
        --out results/ref_modes
    python -m intent_mpc_torch.benchmark.ref_modes --dynus \\
        --seeds 0 1 2 3 4 5 6 7 --timeout 100 --out results/ref_modes_dynus

The JAX script runs one seed per episode; here all seeds of a mode are one
batch on one device (the GPU unless --device names another), and `wall_s`
of a row is its batch's wall time. <out>/summary.json has the JAX script's
layout: rows (per seed, one entry per mode), config and summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from intent_mpc_torch.benchmark.real_loop import static_grid_for
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import (build_from_static_obstacles,
                                               stack_grids)
from intent_mpc_torch.models.world import Scenario, generate_scenario_numpy
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.config import IntentMPCConfig, small_config
from intent_mpc_torch.utils.device import resolve_device

MODES = ("linspace", "global")
WALL_KEYS = ("goal_reached", "collision", "flight_travel_time",
             "stop_replans", "traj_collision_cycles")
DYNUS_KEYS = ("goal_reached", "collision", "flight_travel_time",
              "path_length", "min_distance_to_obstacles", "stop_replans",
              "traj_collision_cycles")
# input-trajectory allocations: the wall world's ~detour / (ref_vel ts)
# samples plus margin; DYNUS 105 m at 5 m/s = 210 samples at 0.1 s, plus
# detour and slow-corner margin
WALL_L = 96
DYNUS_L = 384


def wall_world(seed: int, device="cpu"):
    """Wall at x = 4 over the full height band with a seed-positioned 2 m
    gap drawn off the straight line (|y| in [1.2, 2.2], random side).
    Returns (scenario with one far static dummy box (1, 1, ...), grid,
    gap centre y)."""
    rng = np.random.RandomState(seed)
    gap_c = rng.uniform(1.2, 2.2) * (1 if rng.rand() < 0.5 else -1)
    gap_lo, gap_hi = gap_c - 1.0, gap_c + 1.0
    segs = []
    if gap_lo > -3.4:
        c = (-3.4 + gap_lo) / 2.0
        segs.append(((4.0, c, 2.2), (0.6, gap_lo + 3.4, 4.4)))
    if gap_hi < 3.4:
        c = (gap_hi + 3.4) / 2.0
        segs.append(((4.0, c, 2.2), (0.6, 3.4 - gap_hi, 4.4)))
    centers = np.array([s[0] for s in segs], np.float32)
    boxes = np.array([s[1] for s in segs], np.float32)
    grid = build_from_static_obstacles(
        (-1.0, -4.5, 0.0), (11.0, 9.0, 4.6), 0.2, centers, boxes,
        inflation=(0.3, 0.3, 0.2), device=device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    sc = Scenario(origin=t([[[50.0, 50.0, 1.0]]]), scale=t(np.zeros((1, 1, 3))),
                  offset=t(np.zeros((1, 1))), slower=t(np.zeros((1, 1))),
                  bbox=t(np.full((1, 1, 3), 0.5)),
                  is_static=t(np.ones((1, 1)), torch.bool))
    return sc, grid, (gap_lo + gap_hi) / 2.0


def wall_cfg(ref_mode: str, timeout: float) -> IntentMPCConfig:
    cfg = small_config(num_obstacles=1, horizon=10, timeout=timeout,
                       max_obstacles=1, hist=12)
    cfg = cfg.replace(goal=(8.0, 0.0, 2.0))
    return cfg.replace(engine=dataclasses.replace(
        cfg.engine, goal_mode=True, ref_mode=ref_mode, ref_vel=1.5,
        ref_bounds_margin=2.5, ref_angular_vel=2.0))


def dynus_cfg(ref_mode: str, obstacles: int, timeout: float
              ) -> IntentMPCConfig:
    cfg = IntentMPCConfig()
    return cfg.replace(
        world=dataclasses.replace(cfg.world, num_obstacles=obstacles),
        engine=dataclasses.replace(
            cfg.engine, timeout=timeout, goal_mode=True, ref_mode=ref_mode,
            ref_vel=5.0,
            # 105 m routes: coarser RRT steps so the 64-slot path cap holds
            # (105 / 2.5 = 42 nodes), wider shortcutting, a deeper iteration
            # budget, a corridor-scaled sampling margin
            ref_rrt_iters=2048, ref_rrt_step=2.5, ref_rrt_shortcut=12.0,
            ref_bounds_margin=6.0, ref_waypoints=12))


def wall_batch(seeds, device):
    """(scenarios (S, 1, ...), per-seed grids (S, ...), gap centres)."""
    worlds = [wall_world(int(s), device) for s in seeds]
    scen = Scenario(*(torch.cat([w[0][i] for w in worlds])
                      for i in range(len(Scenario._fields))))
    return scen, stack_grids([w[1] for w in worlds]), [w[2] for w in worlds]


def dynus_batch(cfg: IntentMPCConfig, seeds, device):
    """(scenarios, each seed's prebuilt static map (S, ...))."""
    scen = sh.stack_scenarios(cfg, seeds, device=device)
    grids = [static_grid_for(generate_scenario_numpy(int(s), cfg.world),
                             device=device) for s in seeds]
    return scen, stack_grids(grids)


def run_mode(cfg: IntentMPCConfig, scen, occ, seeds, L: int, device):
    """One mode's batched episodes: (summaries per seed, wall seconds)."""
    dev = resolve_device(device)
    ref = torch.zeros((L, 3), dtype=torch.float32, device=dev)
    key = prng.prng_key(torch.tensor([1000 + int(s) for s in seeds]), dev)
    t0 = time.perf_counter()
    carry, _ = cl.run_episode(cfg, scen, ref, L, occ=occ, device=dev,
                              ref_key=key)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return cl.summarize(cfg, carry), time.perf_counter() - t0


def run(args) -> dict:
    dev = resolve_device(args.device)
    if args.dynus:
        cfgs = {m: dynus_cfg(m, args.obstacles, args.timeout) for m in MODES}
        scen, occ = dynus_batch(cfgs["linspace"], args.seeds, dev)
        L, keys = DYNUS_L, DYNUS_KEYS
        rows = [{"seed": s} for s in args.seeds]
        out = {"config": {"obstacles": args.obstacles,
                          "timeout": args.timeout, "seeds": args.seeds,
                          "dynus": True}}
    else:
        cfgs = {m: wall_cfg(m, args.timeout) for m in MODES}
        scen, occ, gaps = wall_batch(args.seeds, dev)
        L, keys = WALL_L, WALL_KEYS
        rows = [{"seed": s, "gap_y": round(float(g), 2)}
                for s, g in zip(args.seeds, gaps)]
        out = {}
    for c in cfgs.values():
        cl.check_supported(c)
    for mode in MODES:
        summ, wall = run_mode(cfgs[mode], scen, occ, args.seeds, L, dev)
        for row, s in zip(rows, summ):
            row[mode] = {k: s[k] for k in keys}
            row[mode]["wall_s"] = round(wall, 1)
    for row in rows:
        print("[%sseed %d] " % ("dynus " if args.dynus else "", row["seed"])
              + " | ".join("%s goal=%s col=%s replans=%d" % (
                  m, row[m]["goal_reached"], row[m]["collision"],
                  row[m]["stop_replans"]) for m in MODES)
              + " (%s+%ss)" % (row["linspace"]["wall_s"],
                               row["global"]["wall_s"]), flush=True)
    n = len(rows)
    out["rows"] = rows
    out["summary"] = {
        "linspace_success": sum(r["linspace"]["goal_reached"]
                                for r in rows) / n,
        "global_success": sum(r["global"]["goal_reached"] for r in rows) / n,
        "collisions": sum(r[m]["collision"] for r in rows for m in MODES),
    }
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "summary.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps(out["summary"], indent=1))
    print("wrote", path)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--timeout", type=float, default=20.0)
    ap.add_argument("--dynus", action="store_true",
                    help="DYNUS-protocol goal-mode run (200-obstacle world, "
                         "statics in the occupancy map + dynamic trefoil "
                         "field, 105 m; pair with --timeout 100)")
    ap.add_argument("--obstacles", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--out", type=str, default="results/ref_modes")
    return ap.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
