#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device    name, power limit (nvidia-smi)
  2. build     nvcc of every intent_mpc_torch/csrc/*.cu, in parallel
  3. kernel    each kernel against its plain PyTorch version at the
               production shapes (128 scenarios x 6 candidates, horizon 30,
               65 obstacle slots), including +-inf bounds, rho = 1e-6 rows,
               duals of 1e4 and a NaN row; bit-equal, NaN masks equal
  4. loop      the default DYNUS closed loop (IntentMPCConfig defaults:
               200 obstacles, 100 ADMM iterations, factor refresh every 4th
               cycle) for 8 cycles at 128 and at 32 scenarios, through the
               public entry points; the kernel must launch exactly
               100 x 8 times per run
  5. card/cpu  the same scenarios on the GPU and on the CPU (plain
               versions): positions held to 1e-3 m where the iteration is
               stable (see the phase)
  6. modules   neither jax nor the JAX package was imported
Then a JSON line with each kernel's numbers, and last
{"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is present.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(ok, what):
    """A failed check ends the run with a non-zero exit (unlike assert,
    it survives python -O)."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: %s" % (what,))


def cuda_time_ms(fn, reps=50):
    """Median of `reps` CUDA-event timings of fn() (after one warm-up).

    Each timing starts behind a ~2 ms device-side spin, so the host has
    enqueued fn()'s launches before the device reaches them and the events
    time device work, not host launch overhead."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def production_ew_inputs(S, cfg, device):
    """Seeded inputs of the elementwise chain at the main path's shapes,
    in the production regime: +-inf bounds, equality rows, rho = 1e-6 on
    loose rows, duals of 1e4 and one NaN row."""
    import torch
    from intent_mpc_torch.ops.qp import ConVec
    g = torch.Generator(device=device)
    g.manual_seed(0)
    N = S * 6
    H, W = cfg.planner.horizon, cfg.planner.mpc_window
    K = cfg.planner.max_obstacles + 1
    n = cfg.planner.num_vars
    shapes = [(N, H, 8), (N, H, 8), (N, W, 5), (N, W, K)]

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    def unif(shape):
        return torch.rand(shape, generator=g, device=device)

    z, y, zt, rho, lo, hi = [], [], [], [], [], []
    for gi, shp in enumerate(shapes):
        z.append(rnd(shp, 3.0))
        zt.append(rnd(shp, 3.0))
        yv = rnd(shp, 10.0)
        if gi == 3:                       # obstacle duals ramp to ~1e4
            yv = yv * 1e3
        y.append(yv)
        l = rnd(shp) - 1.0
        u = l + unif(shp) * 4.0
        loose = unif(shp) < 0.3
        l = torch.where(loose | (unif(shp) < 0.1), torch.full_like(l, -float("inf")), l)
        u = torch.where(loose, torch.full_like(u, float("inf")), u)
        if gi == 0:                       # equality rows: l == u
            u = l.clone()
            loose = torch.zeros_like(loose)
        r = 0.05 + unif(shp) * 2.0
        r = torch.where(loose, torch.full_like(r, 1e-6), r)
        if gi == 0:
            r = torch.full_like(r, 100.0)
        rho.append(r)
        lo.append(l)
        hi.append(u)
    z[3][5] = float("nan")                # one broken iterate row
    x = rnd((N, n), 2.0)
    x_t = rnd((N, n), 2.0)
    x[7] = float("nan")
    return (x, x_t, ConVec(*z), ConVec(*y), ConVec(*zt), ConVec(*rho),
            ConVec(*lo), ConVec(*hi))


def flat(outs):
    x_n, z_n, y_n, rzy = outs
    return [x_n] + list(z_n) + list(y_n) + list(rzy)


def check_bit_equal(got, want):
    """Bit-equal up to NaN payloads: same NaN mask, torch.equal elsewhere.
    Returns the max |difference| over the finite entries."""
    import torch
    worst = 0.0
    for a, b in zip(flat(got), flat(want)):
        na, nb = torch.isnan(a), torch.isnan(b)
        check(torch.equal(na, nb), "NaN masks differ")
        a0 = torch.where(na, torch.zeros_like(a), a)
        b0 = torch.where(nb, torch.zeros_like(b), b)
        fin = torch.isfinite(a0) & torch.isfinite(b0)
        if fin.any():
            worst = max(worst, float((a0[fin] - b0[fin]).abs().max()))
        check(torch.equal(a0, b0), "kernel and plain version differ")
    return worst


def ew_bound(args, outs):
    """Least time for the chain on an H100: bytes moved (each input read
    once, each output written once) over HBM bandwidth, against the
    float32 operations over the float32 peak."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in [args[0], args[1]] + [a for grp in args[2:]
                                                for a in grp])
    nbytes += sum(t.numel() * t.element_size() for t in flat(outs))
    n_x = args[0].numel()
    n_con = sum(a.numel() for a in args[2])
    # x blend: 3 per element; per constraint row: relax 3, shift 2,
    # clip 2, dual 3, rho*z - y 2
    flops = 3 * n_x + 12 * n_con
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def finite_carry(carry):
    import torch

    def leaves(t):
        if t is None:
            return []
        if isinstance(t, tuple):
            return [x for s in t for x in leaves(s)]
        return [t]
    bad = [t.shape for t in leaves(carry)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    return not bad


def run_loop(cfg, S, cycles, device):
    """Drive the closed loop through the public entry points; returns
    (carry, per-cycle seconds with a synchronize after each cycle)."""
    import torch
    from intent_mpc_torch.engine import closed_loop as cl
    from intent_mpc_torch.models.occupancy import empty_grid
    from intent_mpc_torch.models.world import straight_line_ref_traj
    from intent_mpc_torch.parallel import sharding as sh
    scen = sh.stack_scenarios(cfg, range(S), device=device)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5,
                                 device=device)
    occ = empty_grid(device)
    carry = cl.init_carry(cfg, scen, device=device)
    secs, positions = [], []
    for i in range(cycles):
        t0 = time.perf_counter()
        carry, pos = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        positions.append(pos.detach().cpu())
    return carry, secs, positions


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from intent_mpc_torch.ops import build
    from intent_mpc_torch.ops import ew_chain as ew
    from intent_mpc_torch.utils.config import IntentMPCConfig, small_config
    from intent_mpc_torch.utils.device import resolve_device

    # ---- 1. device ----
    dev = resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    phase("device", kind=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = build.build_all()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          per_kernel=built, flags=" ".join(build.NVCC_FLAGS))

    # ---- 3. kernel against plain version, production shapes ----
    cfg = IntentMPCConfig()
    alpha = cfg.planner.solver.alpha
    timed = {}
    for S in (128, 32):
        args = production_ew_inputs(S, cfg, dev)
        got = ew.ew_chain(alpha, *args)
        want = ew.ew_chain_reference(alpha, *args)
        torch.cuda.synchronize()
        max_err = check_bit_equal(got, want)
        ms = cuda_time_ms(lambda: ew.ew_chain(alpha, *args))
        plain_ms = cuda_time_ms(lambda: ew.ew_chain_reference(alpha, *args))
        bound_ms, bound_by, nbytes = ew_bound(args, got)
        timed[S] = (max_err, ms, plain_ms, bound_ms, bound_by)
        phase("kernel", kernel="ew_chain", scenarios=S, problems=S * 6,
              bit_equal=True, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        del args, got, want
    max_err, ms, plain_ms, bound_ms, bound_by = timed[128]

    # ---- 4. closed loop at production size ----
    loop = {}
    for s in (128, 32):
        run_loop(cfg, s, 1, dev)          # warm-up: library handles, caches
        ew.EW_LAUNCHES = 0
        carry, secs, _ = run_loop(cfg, s, 8, dev)
        launches = ew.EW_LAUNCHES
        iters = cfg.planner.solver.max_iter
        check(launches == 8 * iters, ("kernel launches", launches, 8 * iters))
        check(finite_carry(carry), "non-finite carry leaf")
        succ = carry.metrics.solve_successes
        check(int(succ.sum()) > 0, "no successful solve")
        elapsed = sum(secs)
        loop[s] = dict(launches=launches, cycle_ms=elapsed / 8 * 1e3,
                       cycle_ms_each=[round(x * 1e3, 3) for x in secs],
                       solves_per_s=s * 6 * 8 / elapsed,
                       min_solve_successes=int(succ.min()))
        phase("loop", scenarios=s, cycles=8, **loop[s])

    # ---- 5. card against CPU ----
    # Small config (the parity tests' size): every cycle is held to 1e-3 m.
    # Production config: the first cycle has no obstacle rows (a feasible,
    # converged QP) and is held to 1e-3 m; from the first constrained cycle
    # on, the 100-iteration ADMM iterate of the infeasible DYNUS QPs
    # amplifies rounding differences (see
    # intent_mpc_torch/benchmark/sensitivity.py), so later cycles are
    # reported, and held only to finiteness and equal solve counts.
    tiny = small_config(num_obstacles=4, horizon=8, timeout=0.5,
                        max_obstacles=4, hist=8).replace(goal=(6.0, 0.0, 2.0))
    for name, c, held in (("small", tiny, 4), ("production", cfg, 1)):
        cc, _, pg = run_loop(c, 2, 4, dev)
        cc_cpu, _, pc = run_loop(c, 2, 4, "cpu")
        diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
        check(max(diffs[:held]) <= 1e-3, (name, diffs))
        check(finite_carry(cc) and finite_carry(cc_cpu), "non-finite carry")
        check(torch.equal(cc.metrics.solve_successes.cpu(),
                          cc_cpu.metrics.solve_successes),
              ("solve counts differ", name))
        phase("card_vs_cpu", config=name, scenarios=2, cycles=4,
              max_pos_diff_per_cycle=diffs, held_cycles=held, tol=1e-3)

    # ---- 6. clean modules ----
    dirty = [m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("intent_mpc_tpu")]
    check(not dirty, ("modules of the JAX package loaded", dirty))
    phase("modules", jax_free=True)

    kernels = [{
        "name": "ew_chain",
        "route": "cuda",
        "source": "intent_mpc_torch/csrc/ew_chain.cu",
        "replaces": "intent_mpc_tpu/ops/pallas_ew.py:51 (_ew_kernel)",
        "launches": loop[128]["launches"],
        "max_abs_err": max_err,
        "max_abs_diff": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
