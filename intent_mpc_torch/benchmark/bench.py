"""Benchmark: full-horizon MPC solve throughput on one GPU (the port's
counterpart of bench.py).

    python -m intent_mpc_torch.benchmark.bench [--batch 128] [--cycles 10]
        [--obstacles 200] [--iters N] [--fused]

Runs the DYNUS closed loop (200-obstacle trefoil world, horizon-30 MPC
with 6 intent-combination candidate QPs per replan) for a batch of
scenarios on one CUDA device and measures candidate-QP solves per second:
batch x 6 x cycles / elapsed. Like bench.py it runs 2 x cycles cycles
first (bench.py's compile and retrace calls; here they warm the CUDA
context, the kernel build and the allocator), then times `cycles` more
from the carried state, ending the window with torch.cuda.synchronize().
`--fused` solves with the fleet kernel (SolverConfig.fused_solve, one
launch of csrc/fleet_admm.cu per cycle).

Prints ONE JSON line, {"metric", "value", "unit", "vs_baseline"} with
the 1000 solves/s north-star as the baseline, and a summary line on
stderr. Needs a CUDA device.

Not ported from bench.py: the XLA-only options (--platform, the
compilation cache, cliff padding of the batch and --no-pad, the XLA
cost-analysis --roofline, the jax --profile trace; for a profile see
benchmark/profile_cycle.py), the solver-variant flags the port does not
run, and --latency / --load (a later port).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device


def bench_config(obstacles: int = 200, fused: bool = False) -> IntentMPCConfig:
    cfg = IntentMPCConfig()
    cfg = cfg.replace(world=dataclasses.replace(cfg.world,
                                                num_obstacles=obstacles))
    if fused:
        cfg = cfg.replace(planner=dataclasses.replace(
            cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                    fused_solve=True)))
    return cfg


def run(batch: int, cycles: int, obstacles: int = 200, iters=None,
        fused: bool = False, device=None) -> dict:
    """Warm up for 2 x cycles cycles, then time `cycles` cycles."""
    dev = resolve_device(device)
    cfg = bench_config(obstacles, fused)
    scen = sh.stack_scenarios(cfg, range(batch), device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5, device=dev)
    occ = empty_grid(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def cycles_from(carry, start):
        for i in range(start, start + cycles):
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                       carry, i, iters)
        return carry

    t0 = time.perf_counter()
    carry = cycles_from(cl.init_carry(cfg, scen, device=dev), 0)
    carry = cycles_from(carry, cycles)
    sync()
    warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    carry = cycles_from(carry, 2 * cycles)
    sync()
    elapsed = time.perf_counter() - t0
    return dict(solves=batch * 6 * cycles, elapsed=elapsed, warmup=warmup,
                device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else str(dev)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128,
                    help="scenarios (6 candidate QPs each per cycle)")
    ap.add_argument("--cycles", type=int, default=10, help="timed MPC cycles")
    ap.add_argument("--obstacles", type=int, default=200)
    ap.add_argument("--iters", type=int, default=None,
                    help="ADMM iterations per solve (default: config)")
    ap.add_argument("--fused", action="store_true",
                    help="solve with the fleet kernel (csrc/fleet_admm.cu)")
    args = ap.parse_args()
    r = run(args.batch, args.cycles, args.obstacles, args.iters, args.fused)
    sps = r["solves"] / r["elapsed"]
    print(json.dumps({
        "metric": "mpc_solves_per_sec_per_chip",
        "value": round(sps, 1),
        "unit": "solves/s",
        "vs_baseline": round(sps / 1000.0, 3),
    }))
    print(f"# batch={args.batch} cycles={args.cycles} "
          f"obstacles={args.obstacles} fused={args.fused} "
          f"elapsed={r['elapsed']:.3f}s "
          f"cycle={r['elapsed'] / args.cycles * 1e3:.1f}ms "
          f"warmup={r['warmup']:.1f}s device={r['device']}", file=sys.stderr)


if __name__ == "__main__":
    main()
