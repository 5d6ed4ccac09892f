"""One-command demo: fly a full DYNUS episode and save plot + metrics.

    python -m intent_mpc_torch.benchmark.demo --seed 0 --out demo_out
        [--obstacles 200] [--timeout 100] [--iters N] [--device cuda]

`run_demo` flies the episode (on the GPU by default) and writes
`metrics_seed<seed>.json`; `main` then plots it with matplotlib
(`episode_seed<seed>.png`, benchmark/viz.py). A machine without
matplotlib can call `run_demo` alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import NamedTuple, Optional

import torch

from intent_mpc_torch.engine.closed_loop import (EngineCarry, run_episode,
                                                 summarize)
from intent_mpc_torch.models.world import (Scenario, generate_scenario,
                                           straight_line_ref_traj)
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device


class Demo(NamedTuple):
    cfg: IntentMPCConfig
    scenario: Scenario          # one scenario, (N, ...) leaves
    carry: EngineCarry          # the final carry of the S = 1 batch
    path: torch.Tensor          # (C, 3) per-cycle positions on the host
    row: dict                   # summarize's row


def run_demo(seed: int = 0, obstacles: int = 200, timeout: float = 100.0,
             iters: Optional[int] = None, device=None,
             out: str = "demo_out",
             base: Optional[IntentMPCConfig] = None) -> Demo:
    """Fly seed's episode of `base` (the production DYNUS config by
    default) with `obstacles` obstacles and a `timeout` s episode, and
    write its row to out/metrics_seed<seed>.json."""
    dev = resolve_device(device)
    cfg = base or IntentMPCConfig()
    cfg = cfg.replace(
        world=dataclasses.replace(cfg.world, num_obstacles=obstacles),
        engine=dataclasses.replace(cfg.engine, timeout=timeout))
    sc = generate_scenario(seed, cfg.world, device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5, device=dev)
    carry, path = run_episode(cfg, Scenario(*(a[None] for a in sc)), ref,
                              ref.shape[0], solver_iters=iters,
                              record_path=True, device=dev)
    row = summarize(cfg, carry)[0]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"metrics_seed{seed}.json"), "w") as f:
        json.dump(row, f, indent=2)
    return Demo(cfg, sc, carry, path[0].cpu(), row)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obstacles", type=int, default=200)
    ap.add_argument("--timeout", type=float, default=100.0)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--out", type=str, default="demo_out")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)

    from intent_mpc_torch.benchmark import viz

    d = run_demo(args.seed, args.obstacles, args.timeout, args.iters,
                 args.device, args.out)
    s = d.row
    viz.plot_episode(
        d.cfg, d.scenario, d.path.numpy(),
        os.path.join(args.out, f"episode_seed{args.seed}.png"),
        title=(f"seed {args.seed}: "
               f"{'success' if s['goal_reached'] else 'timeout'} "
               f"in {s['flight_travel_time']:.1f}s, "
               f"{s['collision_count']} collisions"))
    print(json.dumps(s, indent=2))
    return s


if __name__ == "__main__":
    main()
