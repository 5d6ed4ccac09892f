"""Roofline accounting of the replan cycle on the GPU.

    python -m intent_mpc_torch.benchmark.bench --batch 32 --cycles 4 --roofline

An analytic per-cycle model of the production solve (`cycle_model`, the
JAX package's count for count: shared factor, per-candidate CG
refinement, every Minv apply counted as a read of Minv), set against the
card's peaks and cross-checked by a microbenchmark of the dominant
operation, the x-update inverse apply (B, 385, 385) @ (B, 385, 6).

Peaks are keyed by `torch.cuda.get_device_name()`. The port runs every
float32 product in IEEE fp32 with TF32 off (utils/device.resolve_device),
so the bound on operations is the float32 rate outside the tensor cores,
not a tensor-core rate. A card without an entry raises with its name.

The card's L2 (50 MB on an H100) changes the model's premise that each
apply re-reads Minv from HBM: Minv is B x 385^2 x 4 bytes, 18.97 MB at
B = 32, which can stay in L2 across chained applies, and 75.9 MB at
B = 128, which cannot. Where Minv fits, `analyze` times the apply against
the time an HBM read of Minv would take, labels it L2-resident, and
states no HBM share; where it does not fit but an apply still beats the
HBM read (part of Minv served from L2), no HBM share is stated either.
"""

from __future__ import annotations

import statistics
import sys

import torch

from intent_mpc_torch.utils.device import resolve_device

H100 = "NVIDIA H100 80GB HBM3"
# card name -> (float32 FLOP/s outside the tensor cores, HBM bytes/s):
# NVIDIA's data sheet, SXM part, at the full 700 W power limit
PEAKS = {H100: (67e12, 3.35e12)}

SPIN_CYCLES = 100_000_000     # ~50 ms device-side spin before each chain
CHAIN_LENGTHS = (10, 300)


def peaks(name: str):
    """(float32 FLOP/s, HBM bytes/s) of the card `name`."""
    if name not in PEAKS:
        raise KeyError("no peaks for the card %r: add its float32 and HBM "
                       "rates to roofline.PEAKS" % name)
    return PEAKS[name]


def cycle_model(cfg, batch: int, iters: int) -> dict:
    """Analytic FLOPs / bytes for one batch-B replan cycle at the
    production solver config (shared factor + per-candidate CG refine)."""
    p = cfg.planner
    n = p.num_vars
    H, W, K = p.horizon, p.mpc_window, p.max_obstacles
    C = 6                                   # intent candidates
    B = batch
    R = p.solver.shared_refine_iters        # CG refine steps per x-update
    # Minv applies per x-update: 1 initial + 1 preconditioner before the
    # CG loop + (R-1) inside it; normal-operator applies: R
    minv_applies = 2 + max(R - 1, 0)
    m = 2 * (8 * H) + 5 * W + K * W         # flat constraint rows

    flops_iter = (
        minv_applies * 2 * B * n * n * C        # x-update inverse applies
        + R * 2 * B * C * W * K * 3 * 2         # m_op obstacle einsums
        + 12 * B * C * m)                       # elementwise z/y updates
    flops_factor = B * (2 * H * 13 ** 3         # block-Cholesky recursion
                        + 2 * H * 13 * (13 * H) * 13  # L^{-1} row blocks
                        + 2 * (13 * H) ** 2 * 13 * H // 2)  # Minv = Y^T Y
    flops = iters * flops_iter + flops_factor

    # bytes per iteration: Minv read on every apply, QP data re-read by
    # the m_op applies, iterate state read and written
    bytes_iter = (minv_applies * B * n * n * 4
                  + R * B * C * (W * K * 4) * 4
                  + 6 * B * C * (n + m) * 4)
    bytes_setup = B * C * (W * K * 3 + 4 * W * K + 2 * m + n) * 4 \
        + B * n * n * 4
    bts = iters * bytes_iter + bytes_setup
    return {"flops": flops, "bytes": bts, "minv_applies": minv_applies,
            "m": m, "n": n, "minv_bytes": batch * n * n * 4}


def microbench_minv(batch: int, n: int = 385, C: int = 6,
                    device=None, reps: int = 5) -> float:
    """us per batched inverse apply (B, n, n) @ (B, n, C), chained: each
    apply reads the previous one's output, a device-side data dependency.
    M is a seeded orthogonal matrix in every batch entry, so the chain
    keeps its scale and needs no normalising op between applies.

    Each chain is timed between CUDA events behind a long device-side
    spin, so the host has enqueued every launch before the device reaches
    them; the difference of the median times of two chain lengths takes
    out the constant."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the inverse apply is timed on a CUDA device, "
                           "got %s" % dev)
    g = torch.Generator().manual_seed(0)
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=g,
                                       dtype=torch.float64))
    M = q.float().to(dev).expand(batch, n, n).contiguous()
    r0 = torch.randn((batch, n, C), generator=g).to(dev)

    def chain(L):
        c = r0
        for _ in range(L):
            c = torch.matmul(M, c)
        return c

    ms = {}
    for L in CHAIN_LENGTHS:
        chain(L)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            chain(L)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms[L] = statistics.median(times)
    lo, hi = CHAIN_LENGTHS
    return (ms[hi] - ms[lo]) / (hi - lo) * 1e3


def analyze(cfg, batch: int, iters: int, cycle_s=None,
            device=None) -> dict:
    """The model at `batch` and `iters` against the card's peaks, the
    measured inverse apply against its HBM read, and with `cycle_s` (a
    measured cycle time) the achieved rates. A share is given only where
    its premise holds, so none exceeds 1."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the roofline is measured on a CUDA device, "
                           "got %s" % dev)
    name = torch.cuda.get_device_name(dev)
    pk_f, pk_b = peaks(name)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    md = cycle_model(cfg, batch, iters)
    us_apply = microbench_minv(batch, md["n"], device=dev)
    hbm_us = md["minv_bytes"] / pk_b * 1e6
    fits = md["minv_bytes"] <= l2
    out = {"card": name, "batch": batch, "iters": iters,
           "gflop": md["flops"] / 1e9, "model_mb": md["bytes"] / 1e6,
           "minv_applies_per_iter": md["minv_applies"],
           "minv_mb": md["minv_bytes"] / 1e6, "l2_mb": l2 / 1e6,
           "minv_fits_l2": fits, "apply_us": us_apply,
           "minv_hbm_read_us": hbm_us,
           "apply_hbm_share": (None if fits or us_apply < hbm_us
                               else hbm_us / us_apply),
           "operations_floor_ms": md["flops"] / pk_f * 1e3,
           "hbm_floor_ms": None if fits else md["bytes"] / pk_b * 1e3}
    if fits:
        out["apply_verdict"] = "L2-resident: Minv fits in L2"
    elif us_apply < hbm_us:
        out["apply_verdict"] = ("faster than an HBM read of Minv: part of "
                                "it is served from L2")
    else:
        out["apply_verdict"] = "HBM-bound: Minv does not fit in L2"
    if cycle_s is not None:
        out["cycle_ms"] = cycle_s * 1e3
        out["fp32_share"] = md["flops"] / cycle_s / pk_f
        out["hbm_share"] = None if fits else md["bytes"] / cycle_s / pk_b
    return out


def report(cfg, batch: int, cycles: int, elapsed: float, iters: int,
           device=None) -> dict:
    """Print the roofline of a measured run (`cycles` cycles in `elapsed`
    s) on stderr and return analyze's numbers."""
    r = analyze(cfg, batch, iters, elapsed / cycles, device)
    pk_f, pk_b = peaks(r["card"])
    print(f"# roofline [{r['card']}] analytic model, batch={batch} "
          f"iters={iters}: {r['gflop']:.1f} GF, {r['model_mb']:.0f} MB "
          f"per cycle ({r['minv_applies_per_iter']} Minv reads per "
          f"iteration of {r['minv_mb']:.2f} MB; L2 {r['l2_mb']:.1f} MB)",
          file=sys.stderr)
    hbm = ("HBM share not stated (Minv L2-resident)" if r["hbm_share"] is None
           else f"{100 * r['hbm_share']:.2f}% of HBM peak")
    print(f"# achieved {r['gflop'] / r['cycle_ms']:.4f} TFLOP/s "
          f"({100 * r['fp32_share']:.3f}% of the float32 peak "
          f"{pk_f / 1e12:.0f} TFLOP/s), {hbm}", file=sys.stderr)
    floors = f"operations {r['operations_floor_ms']:.2f} ms"
    if r["hbm_floor_ms"] is not None:
        floors += f", all-HBM {r['hbm_floor_ms']:.2f} ms"
    print(f"# floors: {floors} vs measured {r['cycle_ms']:.1f} ms/cycle",
          file=sys.stderr)
    share = ("" if r["apply_hbm_share"] is None
             else f", {100 * r['apply_hbm_share']:.0f}% of the HBM rate")
    print(f"# x-update apply measured {r['apply_us']:.2f} us vs "
          f"{r['minv_hbm_read_us']:.2f} us for an HBM read of its "
          f"{r['minv_mb']:.2f} MB at {pk_b / 1e12:.2f} TB/s: "
          f"{r['apply_verdict']}{share}", file=sys.stderr)
    return r
