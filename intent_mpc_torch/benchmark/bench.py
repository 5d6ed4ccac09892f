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

`--latency` then measures the per-replan-cycle latency against the 100 ms
budget (bench.py:211-283), 50 cycles in each of two patterns:
  * blocking: enqueue cycle i, fetch its command (pos and vel of every
    scenario) to the host, repeat;
  * pipelined depth-1: enqueue cycle i+1, then wait for cycle i's
    command, which an asynchronous copy into pinned host memory fetched
    behind a CUDA event. This is the reference's own semantics: mpcCB
    commits a plan while trajExeCB executes the previous one
    (mpcNavigation.cpp:222-370 vs :499-567).
It prints p50/p99/max in ms for both on stderr, with the card's name and
power limit. `--load N` runs N busy-looping CPU processes (a co-located
load) for the whole command; they start before the first CUDA call and
are stopped when it ends.

The solver-variant flags of bench.py run as there (--refine,
--refine-mode, --refine-x0, --factor-reuse, --drift-refresh, --flat-iter,
--per-candidate-factor). Not ported from bench.py: the XLA-only options
(--platform, the compilation cache, cliff padding of the batch and
--no-pad, the XLA cost-analysis --roofline, the jax --profile trace; for
a profile see benchmark/profile_cycle.py), --ew-kernel (on by default
here) and the solver variants the port does not run (--folded-refine,
--minv-bf16).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device


def bench_config(obstacles: int = 200, fused: bool = False,
                 solver: Optional[dict] = None) -> IntentMPCConfig:
    """The default DYNUS config at `obstacles`, with the fleet-fused solve
    if `fused`, and the SolverConfig fields of `solver` set."""
    cfg = IntentMPCConfig()
    cfg = cfg.replace(world=dataclasses.replace(cfg.world,
                                                num_obstacles=obstacles))
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(
            cfg.planner.solver, **dict(solver or {}),
            fused_solve=fused or cfg.planner.solver.fused_solve)))


def solver_fields(args) -> dict:
    """The SolverConfig fields bench.py's solver-variant flags set."""
    out = {}
    if args.per_candidate_factor:
        out["shared_factor"] = False
    for flag, field in (("refine", "shared_refine_iters"),
                        ("refine_mode", "shared_refine_mode"),
                        ("refine_x0", "shared_refine_x0"),
                        ("factor_reuse", "factor_reuse_cycles"),
                        ("drift_refresh", "factor_drift_refresh")):
        if getattr(args, flag) is not None:
            out[field] = getattr(args, flag)
    if args.flat_iter:
        out["flat_iter"] = True
    return out


def _burn():
    """A co-located CPU load: one busy loop until terminated."""
    x = 1.0
    while True:
        x = x * 1.0000001 + 1e-9


def start_burners(n: int) -> list:
    """Start n CPU burner processes (spawned: the parent may already hold a
    CUDA context, which a forked child must not inherit)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_burn, daemon=True) for _ in range(n)]
    for p in procs:
        p.start()
    return procs


def stop_burners(procs: list) -> None:
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(timeout=10)


def blocking_cycles(step, carry, idxs):
    """Run cycle i and fetch its command to the host, for each i in idxs.
    Returns (carry, seconds per cycle, host commands)."""
    secs, cmds = [], []
    for i in idxs:
        t0 = time.perf_counter()
        carry, cmd = step(carry, i)
        cmds.append(cmd.cpu())
        secs.append(time.perf_counter() - t0)
    return carry, secs, cmds


def pipelined_cycles(step, carry, idxs):
    """Depth-1 pipelining over the cycles idxs: each cycle's command is
    copied into pinned host memory without blocking and a CUDA event is
    recorded after the copy; the host waits on cycle i's event only after
    cycle i+1 has been enqueued. The first cycle is enqueued untimed, so
    len(idxs) - 1 latencies come back. Returns (carry, seconds per timed
    cycle, host commands of every cycle in idxs)."""
    bufs = []

    def enqueue(carry, k, i):
        carry, cmd = step(carry, i)
        if len(bufs) < 2:
            bufs.append(torch.empty(cmd.shape, dtype=cmd.dtype,
                                    pin_memory=True))
        buf = bufs[k % 2]       # cycle i-1's buffer is still being read
        buf.copy_(cmd, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return carry, (buf, done)

    idxs = list(idxs)
    carry, prev = enqueue(carry, 0, idxs[0])
    secs, cmds = [], []
    for k, i in enumerate(idxs[1:], 1):
        t0 = time.perf_counter()
        carry, cur = enqueue(carry, k, i)
        prev[1].synchronize()
        cmds.append(prev[0].clone())
        secs.append(time.perf_counter() - t0)
        prev = cur
    prev[1].synchronize()
    cmds.append(prev[0].clone())
    return carry, secs, cmds


def _percentiles(secs) -> dict:
    a = np.asarray(secs) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a.max()),
            "cycles": int(a.size)}


def command_step(cfg, scen, iters=None):
    """step(carry, i) -> (carry, command): cycle i of the closed loop on
    the scenario batch, and the deployment fetch, each scenario's pos and
    vel as one (S, 6) tensor on the scenarios' device."""
    dev = scen.origin.device
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5, device=dev)
    occ = empty_grid(dev)

    def step(carry, i):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry,
                                   i, iters)
        return carry, torch.cat([carry.pos, carry.vel], dim=-1)
    return step


def latency(batch: int, cycles: int = 50, obstacles: int = 200, iters=None,
            fused: bool = False, device=None,
            solver: Optional[dict] = None) -> dict:
    """Per-cycle latency of the closed loop at `batch` scenarios, blocking
    and pipelined depth-1, `cycles` timed cycles each (bench.py's cycle
    indices: 2 warm-up cycles, blocking 2.., pipelined from 60 on)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("latency is measured on a CUDA device, got %s"
                           % dev)
    cfg = bench_config(obstacles, fused, solver)
    scen = sh.stack_scenarios(cfg, range(batch), device=dev)
    step = command_step(cfg, scen, iters)
    carry = cl.init_carry(cfg, scen, device=dev)
    carry, _, _ = blocking_cycles(step, carry, range(2))
    carry, blocking, _ = blocking_cycles(step, carry, range(2, 2 + cycles))
    start = max(60, 2 + cycles)
    carry, pipelined, _ = pipelined_cycles(
        step, carry, range(start, start + cycles + 1))
    return {"scenarios": batch, "fused": fused,
            "blocking": _percentiles(blocking),
            "pipelined": _percentiles(pipelined), "budget_ms": 100.0}


def card_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def run(batch: int, cycles: int, obstacles: int = 200, iters=None,
        fused: bool = False, device=None,
        solver: Optional[dict] = None) -> dict:
    """Warm up for 2 x cycles cycles, then time `cycles` cycles."""
    dev = resolve_device(device)
    cfg = bench_config(obstacles, fused, solver)
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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128,
                    help="scenarios (6 candidate QPs each per cycle)")
    ap.add_argument("--cycles", type=int, default=10, help="timed MPC cycles")
    ap.add_argument("--obstacles", type=int, default=200)
    ap.add_argument("--iters", type=int, default=None,
                    help="ADMM iterations per solve (default: config)")
    ap.add_argument("--fused", action="store_true",
                    help="solve with the fleet kernel (csrc/fleet_admm.cu)")
    ap.add_argument("--latency", action="store_true",
                    help="also measure per-cycle latency, blocking and "
                         "pipelined depth-1 (100 ms replan budget)")
    ap.add_argument("--load", type=int, default=0,
                    help="co-located CPU burner processes for the run")
    ap.add_argument("--refine", type=int, default=None,
                    help="shared-factor refinement steps per x-update")
    ap.add_argument("--refine-mode", type=str, default=None,
                    choices=["stationary", "cg"])
    ap.add_argument("--refine-x0", type=str, default=None,
                    choices=["minv", "prev"],
                    help="CG x-update initial guess (see SolverConfig)")
    ap.add_argument("--factor-reuse", type=int, default=None,
                    help="refresh the shared factor every k-th cycle "
                         "(SolverConfig.factor_reuse_cycles)")
    ap.add_argument("--drift-refresh", type=float, default=None,
                    help="drift-aware early factor refresh threshold "
                         "(SolverConfig.factor_drift_refresh)")
    ap.add_argument("--flat-iter", action="store_true",
                    help="flat-constraint-space iteration "
                         "(SolverConfig.flat_iter)")
    ap.add_argument("--per-candidate-factor", action="store_true",
                    help="factor every intent candidate separately")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    burners = start_burners(args.load)     # before the first CUDA call
    try:
        report(args)
    finally:
        stop_burners(burners)


def report(args):
    solver = solver_fields(args)
    r = run(args.batch, args.cycles, args.obstacles, args.iters, args.fused,
            solver=solver)
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
    if args.latency:
        lat = latency(args.batch, obstacles=args.obstacles, iters=args.iters,
                      fused=args.fused, solver=solver)
        tag = f" (load={args.load})" if args.load else ""
        card = card_power()
        for mode, name in (("blocking", "blocking"),
                           ("pipelined", "pipelined depth-1")):
            a = lat[mode]
            print(f"# cycle latency {name}{tag}: p50={a['p50_ms']:.1f} "
                  f"p99={a['p99_ms']:.1f} max={a['max_ms']:.1f} ms "
                  f"(budget 100 ms/replan) card={card}",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
