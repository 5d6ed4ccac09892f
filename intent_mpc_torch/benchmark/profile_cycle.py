"""Where a closed-loop cycle's time goes on the GPU.

    python -m intent_mpc_torch.benchmark.profile_cycle [--scenarios 128]
        [--cycles 4] [--fused] [--option quadrotor] [--trace cycle_trace.json]

Runs the default DYNUS closed loop (with `--fused`, the fleet-fused
solve of bench.py --fused; with `--option NAME`, one of the loop options
of benchmark/capture.LOOP_OPTIONS, `real_dynus`, the real-perception
DYNUS loop of benchmark/real_loop.py --dynus, or `goal_linspace`,
`goal_minsnap`, `goal_global`, the DYNUS goal-mode protocol of
benchmark/ref_modes.py --dynus), warms up on cycles 0-3, then profiles
`--cycles` further cycles (4.. , so one factor refresh and three reuse
cycles at the default k = 4) with torch.profiler, and prints one JSON
line: wall time per cycle, device-busy time per cycle (the summed kernel
time of the window, so the device's idle share is 1 - busy / wall), kernel
launches per cycle, the counters of utils/trace per cycle, each stage's
host self time per cycle from the spans of utils/trace (recorded in the
profiled window, so the profiler's own cost is in them), and the kernels
with the most device time. In the
composed goal modes a build cycle (every scenario's input trajectory
re-armed, as after a stop+replan) is profiled first, on its own, and
reported under "build_cycle". Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from intent_mpc_torch.benchmark.bench import bench_config
from intent_mpc_torch.benchmark import capture as C
from intent_mpc_torch.benchmark.capture import (LOOP_OPTIONS, fused,
                                                option_start,
                                                real_dynus_config,
                                                with_option)
from intent_mpc_torch.benchmark.real_loop import static_maps
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import trace
from intent_mpc_torch.utils.device import resolve_device

GOAL_OPTIONS = ("goal_linspace", "goal_minsnap", "goal_global")


def _dev_time(e):      # the attribute was renamed across torch versions
    t = getattr(e, "device_time_total", None)
    return t if t is not None else getattr(e, "cuda_time_total", 0.0)


def profiled(step, carry, cycles,
             activities=(ProfilerActivity.CPU, ProfilerActivity.CUDA)):
    """Run `step(carry, i)` for the cycle indices `cycles` under
    torch.profiler: (carry, wall s, {kernel: (count, device us)},
    launches). The kernels are the CUDA activity's; without the CPU
    activity the profiler records no host op and costs less."""
    with profile(activities=list(activities)) as prof:
        t0 = time.perf_counter()
        for i in cycles:
            carry = step(carry, i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {e.key: (e.count, _dev_time(e)) for e in prof.key_averages()
               if e.device_type == cuda}
    launches = sum(1 for e in prof.events() if e.device_type == cuda)
    return carry, wall, by_name, launches, prof


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=128)
    ap.add_argument("--cycles", type=int, default=4)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--option", default=None,
                    choices=sorted(LOOP_OPTIONS) + ["real_dynus"]
                    + list(GOAL_OPTIONS))
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    dev = resolve_device(None)
    if args.option in GOAL_OPTIONS:
        return goal_main(args, dev)
    start = None
    if args.option == "real_dynus":
        cfg = real_dynus_config()
        cfg = fused(cfg) if args.fused else cfg
    else:
        cfg = bench_config(fused=args.fused)
        if args.option:
            cfg = with_option(cfg, args.option)
            start = option_start(args.option)
    scen = sh.stack_scenarios(cfg, range(args.scenarios), device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device=dev)
    occ, veto = static_maps(cfg, range(args.scenarios), dev)
    carry = cl.init_carry(cfg, scen, device=dev)
    if start is not None:
        carry = start(carry, cfg)
    for i in range(4):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i,
                                   veto_occ=veto)
    torch.cuda.synchronize()

    def step(c, i):
        return cl.episode_step(cfg, scen, ref, ref.shape[0], occ, c, i,
                               veto_occ=veto)[0]
    trace.reset()
    trace.start()
    carry, wall, by_name, launches, prof = profiled(
        step, carry, range(4, 4 + args.cycles))
    spans, counts = trace.stop(), trace.counters()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy_us = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    c = args.cycles
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "scenarios": args.scenarios, "cycles": c, "fused": args.fused,
        "option": args.option,
        "wall_ms_per_cycle": wall / c * 1e3,
        "device_busy_ms_per_cycle": busy_us / c / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches_per_cycle": launches / c,
        "ew_chain_launches_per_cycle": counts.get("ew_chain.launches", 0) / c,
        "fleet_admm_launches_per_cycle":
            counts.get("fleet_admm.launches", 0) / c,
        "dbscan_host_reads_per_cycle":
            counts.get("clustering.host_reads", 0) / c,
        "counters_per_cycle": {k: v / c for k, v in sorted(counts.items())},
        "stage_self_ms_per_cycle": trace.self_ms(spans),
        "top_kernels": [{"name": k[:80], "count_per_cycle": n / c,
                         "device_ms_per_cycle": t / c / 1e3}
                        for k, (n, t) in top],
    }))


def goal_main(args, dev):
    """--option goal_*: the DYNUS goal-mode protocol at --scenarios seeds;
    a build cycle (composed modes) and --cycles MPC cycles, each window
    profiled on its own."""
    mode = args.option[len("goal_"):]
    cfg, run = C.goal_dynus(mode, args.scenarios, dev, args.fused)
    carry = C.goal_init(cfg, run, dev)
    for i in range(4):
        carry = C.goal_step(cfg, run, carry, i)[0]
    torch.cuda.synchronize()

    def step(c, i):
        return C.goal_step(cfg, run, c, i)[0]
    out = {"device": torch.cuda.get_device_name(0),
           "scenarios": args.scenarios, "cycles": args.cycles,
           "fused": args.fused, "option": args.option}
    first = 4
    if cl.composed(cfg):
        carry, wall, by_name, launches, _ = profiled(
            step, C.rearm_build(carry), [first])
        busy = sum(t for _, t in by_name.values())
        out["build_cycle"] = {
            "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "kernel_launches": launches}
        first += 1
    c = args.cycles
    trace.reset()
    trace.start()
    carry, wall, by_name, launches, prof = profiled(
        step, carry, range(first, first + c))
    spans, counts = trace.stop(), trace.counters()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    out.update({
        "wall_ms_per_cycle": wall / c * 1e3,
        "device_busy_ms_per_cycle": busy / c / 1e3,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "kernel_launches_per_cycle": launches / c,
        "ew_chain_launches_per_cycle": counts.get("ew_chain.launches", 0) / c,
        "fleet_admm_launches_per_cycle":
            counts.get("fleet_admm.launches", 0) / c,
        "build_host_reads_per_cycle":
            counts.get("closed_loop.host_reads", 0) / c,
        "counters_per_cycle": {k: v / c for k, v in sorted(counts.items())},
        "stage_self_ms_per_cycle": trace.self_ms(spans),
        "top_kernels": [{"name": k[:80], "count_per_cycle": n / c,
                         "device_ms_per_cycle": t / c / 1e3}
                        for k, (n, t) in top]})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
