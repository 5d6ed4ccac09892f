"""Weak-scaling study of the fleet: throughput against the world size
(port of intent_mpc_tpu/benchmark/scaling.py).

Each world size W runs as W processes, one rank per device
(parallel/launch.spawn), each flying `per_device` scenarios of JAX's
study config (small_config, horizon 10, history 16, a 2 s timeout)
through sharding.batch_rollout with the fleet: a warm-up rollout, a
settling one, then a timed one started together by a barrier. The
timed rollout ends with the fleet's all_reduce, so rank 0's time covers
the slowest rank. Rows: world size, batch, solves/s, per-device solves/s
and the weak-scaling efficiency against the smallest world; then the
collective inventory (sharding.collective_report) of the largest world.

    python -m intent_mpc_torch.benchmark.scaling --worlds 1     # NCCL
    python -m intent_mpc_torch.benchmark.scaling --worlds 1,2,4 \\
        --backend gloo --device cpu --threads 1               # CPU ranks

NCCL refuses two ranks of one communicator on one GPU, so world sizes
above the number of cards are dropped on the NCCL backend.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.distributed as dist

from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import launch
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import small_config
from intent_mpc_torch.utils.device import resolve_device

ROW_KEYS = ("devices", "batch", "solves_per_sec", "per_device",
            "weak_scaling_efficiency")


def study_config(obstacles: int):
    """JAX's study config."""
    return small_config(num_obstacles=obstacles, horizon=10, timeout=2.0,
                        max_obstacles=obstacles, hist=16)


def study_rank(fleet: sh.Fleet, per_device: int, cycles: int,
               obstacles: int, iters: int, inventory: bool) -> dict:
    """One rank of one world size: the seconds of the timed rollout of
    this rank's per_device scenarios (of per_device x world), and with
    `inventory` the inventory of one more rollout."""
    cfg = study_config(obstacles)
    dev = fleet.device
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5,
                                 device=dev)
    scen = sh.stack_scenarios_global(cfg, range(fleet.world * per_device),
                                     fleet)

    def run():
        return sh.batch_rollout(cfg, scen, ref, ref.shape[0], mesh=fleet,
                                solver_iters=iters, num_cycles=cycles)[1]

    run()      # warm-up: library handles, caches
    run()      # settle
    if fleet.group is not None:
        dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    agg = run()                  # its aggregate's host read ends the run
    seconds = time.perf_counter() - t0
    out = {"seconds": seconds, "episodes": agg["episodes"]}
    if inventory:
        _, rep = sh.collective_report(cfg, scen, ref, ref.shape[0], fleet,
                                      solver_iters=iters, num_cycles=cycles)
        out["collectives"] = rep["counts"]
        out["collective_bytes"] = rep["total_bytes"]
    return out


def run_study(worlds, per_device: int = 4, cycles: int = 5,
              obstacles: int = 8, iters: int = 30, backend: str = "nccl",
              device=None, threads=None, timeout: float = 1800.0):
    """(rows, inventory of the largest world): the weak-scaling rows of
    JAX's study, one per world size in `worlds`."""
    if backend == "nccl":
        resolve_device(device)          # the card, or raise before spawning
    worlds = list(worlds)
    rows, rep, base = [], None, None
    for w in worlds:
        res = launch.spawn("intent_mpc_torch.benchmark.scaling:study_rank",
                           w, backend, kwargs=dict(
                               per_device=per_device, cycles=cycles,
                               obstacles=obstacles, iters=iters,
                               inventory=w == worlds[-1]),
                           device=device, threads=threads, timeout=timeout)
        B = w * per_device
        sps = B * 6 * cycles / res[0]["seconds"]
        if base is None:
            base = sps / w
        rows.append({"devices": w, "batch": B, "solves_per_sec": sps,
                     "per_device": sps / w,
                     "weak_scaling_efficiency": sps / (base * w)})
        if w == worlds[-1]:
            rep = {"collectives": res[0]["collectives"],
                   "collective_bytes_per_fleet_episode":
                       res[0]["collective_bytes"]}
    return rows, rep


def main(argv=None):  # pragma: no cover
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=str, default="1,2,4,8")
    ap.add_argument("--per-device", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--obstacles", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--backend", type=str, default="nccl",
                    choices=["nccl", "gloo"])
    ap.add_argument("--device", type=str, default=None,
                    help="each rank's device ('cpu'; default cuda:<rank>)")
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    worlds = [int(w) for w in args.worlds.split(",")]
    card = None
    if args.backend == "nccl":
        avail = torch.cuda.device_count()
        worlds = [w for w in worlds if w <= avail]
        if not worlds:
            raise SystemExit("no world size fits the %d CUDA devices"
                             % avail)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    rows, rep = run_study(worlds, args.per_device, args.cycles,
                          args.obstacles, args.iters, args.backend,
                          args.device, args.threads)
    print(json.dumps({"rows": rows, **rep, "backend": args.backend,
                      "nvidia_smi": card}, indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
