"""Real-perception-in-the-loop metrics delta: the GT fake detector against
the rendered-depth dynamicDetector stack on the same seeded worlds (port
of intent_mpc_tpu/benchmark/real_loop.py).

    python -m intent_mpc_torch.benchmark.real_loop --seeds 0 1 2 3 \\
        --obstacles 12 --timeout 30 --out results/real_loop
    python -m intent_mpc_torch.benchmark.real_loop --dynus --seeds $(seq 0 31) \\
        --obstacles 200 --timeout 60 --max-obstacles 64 --max-tracks 16

The reference switches the whole perception source with one flag
(use_fake_detector, mpcNavigation.cpp:129-136). Each seed flies twice:
once with ground-truth obstacle histories (models/detector.py) and once
where the only obstacle information is depth frames rendered at the
drone's pose (models/real_detector.py: render -> DBSCAN -> KF tracks ->
classification -> predictor). The per-seed rows and aggregates land in
<out>/summary.json with the JAX script's layout: config, gt, real,
gt_rows, real_rows, and the real mode's perception aggregates.

Two world modes:
  * micro (default): dynamic-only worlds in a narrow corridor;
  * --dynus: the DYNUS protocol geometry (200 obstacles, 65% dynamic, the
    105 m corridor). In real mode the statics reach the planner as the
    reference's real-perception stack hands them over: a prebuilt static
    occupancy map per seed (occupancyMap.cpp:399-475 initPrebuiltMap,
    `static_grid_for`) clustered each cycle into rotated-box MPC rows
    (PlannerConfig.static_clustering); the predictor samples its rollouts
    against that map. GT mode keeps everything on the fake detector.

The JAX script runs one seed per episode; here all seeds of a mode are
one batch on one device (the GPU unless --device names another), and a
seed's row does not depend on its batch. `wall_s` of a row is its
batch's wall time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from intent_mpc_torch.benchmark import harness as H
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import (build_from_static_obstacles,
                                               empty_grid, stack_grids)
from intent_mpc_torch.models.world import (generate_scenario_numpy,
                                           straight_line_ref_traj)
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import IntentMPCConfig, RealDetectorConfig
from intent_mpc_torch.utils.device import resolve_device

PERCEPTION_KEYS = ("track_pos_rmse", "missed_rate", "spurious_rate",
                   "track_births")


def build_cfg(args) -> IntentMPCConfig:
    """The GT-mode config of the flags (as the JAX script builds it)."""
    cfg = IntentMPCConfig()
    rd = RealDetectorConfig(max_tracks=args.max_tracks,
                            max_detections=args.max_tracks)
    planner = dataclasses.replace(cfg.planner,
                                  max_obstacles=args.max_obstacles)
    if args.dynus:
        # the statics are physical scenario boxes, so the camera's box
        # render images them: no grid ray-march (render_static_grid off)
        world = dataclasses.replace(
            cfg.world, num_obstacles=args.obstacles,
            dynamic_ratio=args.dynamic_ratio)
        return cfg.replace(
            world=world, real_detector=rd, planner=planner,
            engine=dataclasses.replace(cfg.engine, timeout=args.timeout,
                                       render_static_grid=False))
    world = dataclasses.replace(
        cfg.world, num_obstacles=args.obstacles, dynamic_ratio=1.0,
        x_range=(4.0, args.corridor - 4.0), y_range=(-3.0, 3.0),
        z_range=(1.0, 2.0))
    return cfg.replace(
        world=world, real_detector=rd, planner=planner,
        start=(0.0, 0.0, 1.5), goal=(args.corridor, 0.0, 1.5),
        engine=dataclasses.replace(cfg.engine, timeout=args.timeout))


def real_cfg_of(cfg: IntentMPCConfig, args) -> IntentMPCConfig:
    """The real-perception config: the fake detector off; at the DYNUS
    protocol scale the statics through the prebuilt map and per-cycle
    clustering rows; the veto and KF-inflation flags."""
    real = cfg.replace(engine=dataclasses.replace(
        cfg.engine, use_fake_detector=False))
    if args.dynus:
        real = real.replace(planner=dataclasses.replace(
            real.planner, static_clustering=True))
    rd = real.real_detector
    if args.static_veto:
        rd = dataclasses.replace(rd, static_map_veto=True)
    if args.kf_inflate is not None:
        rd = dataclasses.replace(rd, kf_size_inflation=args.kf_inflate)
    return real.replace(real_detector=rd)


def static_grid_for(sc: dict, resolution: float = 0.2,
                    inflation=(0.3, 0.3, 0.2), device="cpu"):
    """Prebuilt static occupancy map of a DYNUS scenario's pillars and
    walls (the reference's prebuilt-map mode, occupancyMap.cpp:399-475),
    with the robot-size inflation (inflation (0, 0, 0) gives the solid
    volume, the classification-veto grid). Fixed extents, so every seed's
    grid has one shape: (-2, -16.5, 0) + (112, 33, 7.6) m. sc: the numpy
    arrays of models/world.generate_scenario_numpy."""
    st = np.asarray(sc["is_static"])
    return build_from_static_obstacles(
        (-2.0, -16.5, 0.0), (112.0, 33.0, 7.6), resolution,
        np.asarray(sc["origin"])[st], np.asarray(sc["bbox"])[st],
        inflation=inflation, device=device)


def static_maps(cfg: IntentMPCConfig, seeds, device):
    """The occupancy maps a config's episodes read, (occ, veto_occ): with
    static clustering (the DYNUS real-perception mode) each seed's
    prebuilt static map, stacked per scenario, and with the static-map
    veto also the solid static volumes (the veto reads those, not the
    robot-inflated planning grid); otherwise the empty map and None."""
    dev = resolve_device(device)
    if not cfg.planner.static_clustering:
        return empty_grid(dev), None
    worlds = [generate_scenario_numpy(int(s), cfg.world) for s in seeds]
    occ = stack_grids([static_grid_for(w, device=dev) for w in worlds])
    veto = None
    if cfg.real_detector.static_map_veto:
        veto = stack_grids([static_grid_for(w, inflation=(0.0, 0.0, 0.0),
                                            device=dev) for w in worlds])
    return occ, veto


def run_mode(cfg: IntentMPCConfig, seeds, device):
    """One mode's batched episodes: (final carry, rows, wall seconds)."""
    dev = resolve_device(device)
    scen = sh.stack_scenarios(cfg, seeds, device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5,
                                 device=dev)
    occ, veto = static_maps(cfg, seeds, dev)
    t0 = time.perf_counter()
    carry, _ = cl.run_episode(cfg, scen, ref, ref.shape[0], occ=occ,
                              device=dev, veto_occ=veto)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = cl.summarize(cfg, carry)
    perception = cl.perception_summary(carry)
    for i, (row, seed) in enumerate(zip(rows, seeds)):
        row["seed"] = int(seed)
        row["wall_s"] = round(wall, 1)
        if perception:
            votes = carry.real_det.tracks.dyn_votes[i].detach().cpu()
            row["tracks_dynamic"] = int((votes >= 2.0).sum())
            row.update(perception[i])
    return carry, rows, wall


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--obstacles", type=int, default=12)
    ap.add_argument("--corridor", type=float, default=30.0)
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--max-obstacles", type=int, default=16)
    ap.add_argument("--max-tracks", type=int, default=8)
    ap.add_argument("--dynamic-ratio", type=float, default=0.65,
                    help="--dynus world dynamic fraction (protocol 0.65)")
    ap.add_argument("--dynus", action="store_true",
                    help="DYNUS protocol world (statics via the prebuilt "
                         "map + clustering in real mode); pair with "
                         "--obstacles 200 --timeout 60 --max-obstacles 64 "
                         "--max-tracks 16")
    ap.add_argument("--static-veto", action="store_true",
                    help="RealDetectorConfig.static_map_veto: tracks inside "
                         "the static map's solid volume are not "
                         "classified dynamic")
    ap.add_argument("--kf-inflate", type=float, default=None,
                    help="RealDetectorConfig.kf_size_inflation: track "
                         "sizes inflated by this multiple of the KF "
                         "position std")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--out", type=str, default="results/real_loop")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_cfg(args)
    real = real_cfg_of(cfg, args)
    for c in (cfg, real):
        cl.check_supported(c)
    out = {"config": {"obstacles": args.obstacles,
                      "corridor": ("dynus-105m" if args.dynus
                                   else args.corridor),
                      "timeout": args.timeout, "seeds": args.seeds,
                      "max_tracks": args.max_tracks, "dynus": args.dynus,
                      "dynamic_ratio": (args.dynamic_ratio if args.dynus
                                        else 1.0),
                      "max_obstacles": args.max_obstacles}}
    for name, c in (("gt", cfg), ("real", real)):
        _, rows, _ = run_mode(c, args.seeds, dev)
        for row in rows:
            extra = (" rmse=%.2f miss=%.2f spur=%.2f"
                     % (row["track_pos_rmse"], row["missed_rate"],
                        row["spurious_rate"]) if name == "real" else "")
            print("[%s seed %d] goal=%s col=%s t=%.1f mind=%.2f%s (%ss)"
                  % (name, row["seed"], row["goal_reached"],
                     row["collision"], row["flight_travel_time"],
                     row["min_distance_to_obstacles"], extra,
                     row["wall_s"]), flush=True)
        agg = H.aggregate(rows)
        if name == "real":
            for k in PERCEPTION_KEYS:
                agg["avg_" + k] = float(np.mean([r[k] for r in rows]))
        out[name] = agg
        out[name + "_rows"] = rows

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "summary.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({k: out[k] for k in ("gt", "real")}, indent=1,
                     default=float))
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
