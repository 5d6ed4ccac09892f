"""Where the fleet kernel's time goes: its device cycles per phase kind.

    python -m intent_mpc_torch.benchmark.fleet_phases [--scenarios 128 32]
        [--iters 100]

For each scenario count, runs the fused DYNUS loop to its cycle 2 (the
second with obstacle rows; `capture.capture_fused_qps`), packs those
candidate QPs as the planner does, and launches csrc/fleet_admm.cu with
its cycle count on: thread 0 of every block adds the clock64() cycles of
each phase, from the barrier that ends one phase to the barrier that ends
the next, per kind (`fleet.PHASES`: Minv apply, A_ext CSR, A_ext^T CSR,
linear rows, obstacle rows, vector updates; where the kernel fuses two
kinds into one phase, its source says under which kind the phase
counts). Prints one JSON line per
size: each kind's share of the block's cycles (mean over blocks), its
cycles per iteration, and that share of the kernel's time with the count
off (CUDA events), beside the time with it on. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from intent_mpc_torch.benchmark.capture import capture_fused_qps, cuda_time_ms
from intent_mpc_torch.ops import fleet as fl


def phase_split(clk: torch.Tensor, iters: int, kernel_ms: float,
                counted_ms: float) -> dict:
    """The split of a counted launch that has run: `clk` is the (S,
    len(PHASES)) cycle count it filled. Returns each phase kind's share of
    the blocks' cycles, its cycles per iteration, and its share of
    `kernel_ms` (the kernel's time with the count off). `counted_ms` is
    the time with the count on, to show its cost."""
    per_block = clk.double().mean(0)                  # (phases,)
    total = float(per_block.sum())
    out = {"iters": iters, "scenarios": clk.shape[0],
           "kernel_ms": kernel_ms, "counted_ms": counted_ms,
           "count_overhead": counted_ms / kernel_ms - 1.0,
           "block_cycles": total,
           "block_cycles_max": float(clk.sum(1).max()),
           "cycles_per_ms": total / counted_ms}
    for name, c in zip(fl.PHASES, per_block.tolist()):
        share = c / total
        out[name] = {"share": share,
                     "cycles_per_iter": c / max(iters, 1),
                     "ms": share * kernel_ms}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, nargs="+", default=[128, 32])
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    from intent_mpc_torch.utils.config import IntentMPCConfig
    from intent_mpc_torch.utils.device import resolve_device

    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = IntentMPCConfig()
    pcfg = cfg.planner
    refine = pcfg.solver.shared_refine_iters
    for S in args.scenarios:
        qps, warm, rho = capture_fused_qps(cfg, S, 2, dev)
        fp, _ = fl.fleet_setup(pcfg, qps, warm, rho_override=rho)
        d = fl._check(pcfg, fp)
        clk = torch.zeros((S, len(fl.PHASES)), dtype=torch.int64, device=dev)
        ms = cuda_time_ms(
            lambda: fl.fleet_solve(pcfg, fp, args.iters, refine), reps=10)
        counted = cuda_time_ms(
            lambda: fl._launch(pcfg, fp, d, args.iters, refine, clk), reps=10)
        split = phase_split(clk, args.iters, ms, counted)
        split["refine"] = refine
        print(json.dumps({"fleet_phases": split, "device":
                          torch.cuda.get_device_name(0), "nvidia_smi": smi}),
              flush=True)
        del qps, warm, fp
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
