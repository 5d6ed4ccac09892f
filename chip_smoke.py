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
  6. kernel    fleet_admm against its plain version at 128 and at 32
               scenarios, on the real candidate QPs of a constrained cycle
               of the fused DYNUS loop: after 1 iteration x within 1e-5 of
               max|x|, after 10 the unscaled candidate states within
               1e-3 m, after 100 both finite with the same acceptance
               mask; and the full solve of a small config within 1e-3
  7. loop_fused the DYNUS loop with fused_solve=True (bench.py --fused)
               for 8 cycles at 128 and at 32 scenarios: exactly one
               fleet_admm launch per cycle and no ew_chain launch
  8. card/cpu  the fused loop on the small config, held to 1e-3 m
  9. modules   neither jax nor the JAX package was imported
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


def fused(cfg):
    """The config with the fleet-fused solve, as bench.py --fused sets it."""
    import dataclasses
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                fused_solve=True)))


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


def capture_fused_qps(cfg, S, cycle, device):
    """The candidate QPs that the planner hands to fleet_admm at `cycle` of
    the fused DYNUS loop (cycles 0..cycle run from a fresh carry): a
    recorder stands in for mpc.fleet_admm during this run only."""
    from intent_mpc_torch.models import mpc as mpclib
    solve = mpclib.fleet_admm
    seen = []

    def record(cfg_, qps, warm, max_iter=None, **kw):
        seen.append((qps, warm, kw.get("rho_override")))
        return solve(cfg_, qps, warm, max_iter, **kw)
    mpclib.fleet_admm = record
    try:
        run_loop(fused(cfg), S, cycle + 1, device)
    finally:
        mpclib.fleet_admm = solve
    return seen[cycle]


def small_fleet_qps(pcfg, S, device):
    """(S, 6) seeded candidate QPs at the small config of the fleet parity
    test (horizon 10, 4 obstacle slots, 3 active, static ones yawed)."""
    import numpy as np
    import torch
    from intent_mpc_torch.ops import qp as qplib
    H, W, K = pcfg.horizon, pcfg.mpc_window, pcfg.max_obstacles
    cols = [[] for _ in range(8)]
    for p in range(S * 6):
        rng = np.random.RandomState(p)
        x0 = np.array([0.0, 0.0, 2.0, 1.0, 0.0, 0.0])
        xref = np.stack([np.linspace(0, 2.5 * H, H), np.zeros(H),
                         np.full(H, 2.0)], axis=-1)
        oxyz, osize = np.zeros((W, K, 3)), np.ones((W, K, 3))
        yaw, dyn, act = np.zeros((W, K)), np.ones((W, K)), np.zeros((W, K))
        for k in range(3):
            p0 = np.array([5.0 + 3 * k, (-1) ** k * 2.5, 2.0])
            v = np.array([0.2, -0.1 * (-1) ** k, 0.0])
            oxyz[:, k] = p0 + np.arange(W)[:, None] * 0.1 * v
            osize[:, k] = 0.4 + pcfg.dynamic_safety_dist
            act[:, k] = 1.0
            if k % 2 == 1:
                dyn[:, k] = 0.0
                yaw[:, k] = rng.uniform(-1, 1)
        lin = x0[None, 0:3] + np.arange(W)[:, None] * 0.1 * x0[None, 3:6]
        for i, a in enumerate((x0, xref, oxyz, osize, yaw, dyn, act, lin)):
            cols[i].append(a)
    args = [torch.as_tensor(np.stack(c).reshape((S, 6) + c[0].shape),
                            dtype=torch.float32, device=device) for c in cols]
    return qplib.build_qp(pcfg, *args)


def accepted(res):
    """The planner's acceptance rule (models/mpc.py)."""
    import torch
    return (torch.isfinite(res.prim_res) & (res.prim_res < 1e3)
            & torch.all(torch.isfinite(res.x), dim=-1))


def fleet_bound(pcfg, fp, iters, refine, live_k):
    """Least time for the fleet solve on an H100: each input read once
    (Minv's live n x n block; A_ext as its CSR arrays) and each output
    written once, over HBM bandwidth, against the float32 operations this
    solve needs over the float32 peak: per live candidate and iteration
    (1 + refine) Minv applies of 2 n^2, 2 + 2 refine sparse A_ext products
    of 2 nnz, and the obstacle, linear-row and vector elementwise work."""
    from intent_mpc_torch.ops import fleet as fl
    S, n = fp.minv.shape[0], pcfg.num_vars
    d = fl.fleet_dims(pcfg, fp.gx.shape[-1], S)
    nnz = int(fl.csr(fl.a_ext(pcfg, d.K))[0][-1])
    per_iter = ((1 + refine) * 2 * n * n + (2 + 2 * refine) * 2 * nnz
                + (20 * refine + 30) * d.W * live_k
                + (3 * refine + 14) * d.m_lin + (8 + 5 * refine) * n)
    flops = per_iter * fl.LIVE * S * iters
    nbytes = S * n * n * 4 + 2 * (2 * nnz + d.n_ext + d.n_pad + 2) * 4
    nbytes += sum(t.numel() * 4 for f, t in zip(fp._fields, fp)
                  if f not in ("a_ext", "minv"))
    nbytes += S * fl.LANES * (d.n_pad + d.lin_pad + d.W * d.K) * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def check_fleet_kernel(cfg, S, dev):
    """fleet_admm against fleet_solve_reference on the QPs of the third
    cycle (the second with obstacle rows) of the fused DYNUS loop."""
    import torch
    from intent_mpc_torch.ops import fleet as fl
    from intent_mpc_torch.ops import qp as qplib
    pcfg = cfg.planner
    refine = pcfg.solver.shared_refine_iters
    qps, warm, rho = capture_fused_qps(cfg, S, 2, dev)
    rows = int(qps.obs_active.sum())
    check(rows > 0, "the captured cycle has no obstacle rows")
    fp, fac = fl.fleet_setup(pcfg, qps, warm, rho_override=rho)
    out = {"scenarios": S, "problems": S * 6, "active_obstacle_rows": rows}
    for iters in (1, 10, 100):
        got = fl.fleet_solve(pcfg, fp, iters, refine)
        want = fl.fleet_solve_reference(pcfg, fp, iters, refine)
        torch.cuda.synchronize()
        rg = fl.fleet_result(pcfg, qps, fac, *got)
        rw = fl.fleet_result(pcfg, qps, fac, *want)
        xg, xw = got[0][:, :fl.LIVE], want[0][:, :fl.LIVE]
        rel_x = float((xg - xw).abs().max() / xw.abs().max())
        states = float((qplib.split_z(rg.x, pcfg)[0]
                        - qplib.split_z(rw.x, pcfg)[0]).abs().max())
        duals = max(float((a - b).abs().max() / (b.abs().max() + 1.0))
                    for a, b in zip(rg.y, rw.y))
        same_mask = bool(torch.equal(accepted(rg), accepted(rw)))
        out["iters_%d" % iters] = dict(
            x_rel_diff=rel_x, state_max_abs_diff=states, dual_rel_diff=duals,
            accepted=int(accepted(rg).sum()), same_acceptance=same_mask)
        if iters == 1:
            check(rel_x <= 1e-5, ("fleet_admm 1 iteration", S, rel_x))
        elif iters == 10:
            check(states <= 1e-3, ("fleet_admm 10 iterations", S, states))
            out["max_abs_err"] = states
        else:
            check(all(bool(torch.isfinite(t).all())
                      for t in list(got) + list(want)),
                  ("fleet_admm 100 iterations: non-finite", S))
            check(same_mask, ("fleet_admm 100 iterations: acceptance", S))
    ms = cuda_time_ms(lambda: fl.fleet_solve(pcfg, fp, 100, refine), reps=20)
    plain_ms = cuda_time_ms(
        lambda: fl.fleet_solve_reference(pcfg, fp, 100, refine), reps=3)
    bound_ms, bound_by, nbytes, flops = fleet_bound(pcfg, fp, 100, refine,
                                                    qps.G.shape[-2])
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, iters_timed=100)
    return out


def check_fleet_small(dev):
    """The full 60-iteration solve at the fleet parity test's config
    (horizon 10, 4 slots, 4 scenarios, stationary refinement x3): kernel
    and plain version agree to 1e-3."""
    import torch
    from intent_mpc_torch.ops import fleet as fl
    from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig
    pcfg = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
        max_iter=60, shared_refine_mode="stationary", shared_refine_iters=3))
    qps = small_fleet_qps(pcfg, 4, dev)
    warm = torch.zeros((4, 6, pcfg.num_vars), device=dev)
    fp, _ = fl.fleet_setup(pcfg, qps, warm)
    got = fl.fleet_solve(pcfg, fp, 60, 3)
    want = fl.fleet_solve_reference(pcfg, fp, 60, 3)
    torch.cuda.synchronize()
    diff = float((got[0][:, :fl.LIVE] - want[0][:, :fl.LIVE]).abs().max())
    check(diff <= 1e-3, ("fleet_admm small config", diff))
    return diff


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from intent_mpc_torch.ops import build
    from intent_mpc_torch.ops import ew_chain as ew
    from intent_mpc_torch.ops import fleet as fl
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
        fl.FLEET_LAUNCHES = 0
        carry, secs, _ = run_loop(cfg, s, 8, dev)
        launches = ew.EW_LAUNCHES
        iters = cfg.planner.solver.max_iter
        check(launches == 8 * iters, ("kernel launches", launches, 8 * iters))
        check(fl.FLEET_LAUNCHES == 0, ("fleet_admm launches on the default "
                                       "path", fl.FLEET_LAUNCHES))
        check(finite_carry(carry), "non-finite carry leaf")
        succ = carry.metrics.solve_successes
        check(int(succ.sum()) > 0, "no successful solve")
        elapsed = sum(secs)
        loop[s] = dict(launches=launches, fleet_admm_launches=0,
                       cycle_ms=elapsed / 8 * 1e3,
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

    # ---- 6. fleet kernel against plain version, real QPs ----
    fleet = {}
    for S in (128, 32):
        fleet[S] = check_fleet_kernel(cfg, S, dev)
        phase("kernel", kernel="fleet_admm", **fleet[S])
    phase("kernel", kernel="fleet_admm", config="small", scenarios=4,
          iters=60, max_abs_diff=check_fleet_small(dev), tol=1e-3)

    # ---- 7. fused closed loop at production size ----
    loop_f = {}
    for s in (128, 32):
        run_loop(fused(cfg), s, 1, dev)   # warm-up
        ew.EW_LAUNCHES = 0
        fl.FLEET_LAUNCHES = 0
        carry, secs, _ = run_loop(fused(cfg), s, 8, dev)
        launches, ew_launches = fl.FLEET_LAUNCHES, ew.EW_LAUNCHES
        check(launches == 8, ("fleet_admm launches", launches, 8))
        check(ew_launches == 0, ("ew_chain launches on the fused path",
                                 ew_launches))
        check(finite_carry(carry), "non-finite carry leaf (fused)")
        succ = carry.metrics.solve_successes
        check(int(succ.sum()) > 0, "no successful solve (fused)")
        elapsed = sum(secs)
        loop_f[s] = dict(launches=launches, ew_chain_launches=ew_launches,
                         cycle_ms=elapsed / 8 * 1e3,
                         cycle_ms_each=[round(x * 1e3, 3) for x in secs],
                         solves_per_s=s * 6 * 8 / elapsed,
                         min_solve_successes=int(succ.min()))
        phase("loop_fused", scenarios=s, cycles=8, **loop_f[s])

    # ---- 8. fused loop, card against CPU, small config ----
    cc, _, pg = run_loop(fused(tiny), 2, 4, dev)
    cc_cpu, _, pc = run_loop(fused(tiny), 2, 4, "cpu")
    diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
    check(max(diffs) <= 1e-3, ("fused small", diffs))
    check(finite_carry(cc) and finite_carry(cc_cpu), "non-finite carry")
    check(torch.equal(cc.metrics.solve_successes.cpu(),
                      cc_cpu.metrics.solve_successes),
          ("solve counts differ", "fused small"))
    phase("card_vs_cpu", config="small", solve="fused", scenarios=2,
          cycles=4, max_pos_diff_per_cycle=diffs, held_cycles=4, tol=1e-3)

    # ---- 9. clean modules ----
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
    }, {
        "name": "fleet_admm",
        "route": "cuda",
        "source": "intent_mpc_torch/csrc/fleet_admm.cu",
        "replaces": "intent_mpc_tpu/ops/pallas_fused.py:300 (_fleet_kernel)",
        "launches": loop_f[128]["launches"],
        "max_abs_err": fleet[128]["max_abs_err"],
        "max_abs_diff": fleet[128]["max_abs_err"],
        "max_abs_err_of": "unscaled candidate states after 10 iterations",
        "ms": fleet[128]["ms"],
        "plain_ms": fleet[128]["plain_ms"],
        "bound_ms": fleet[128]["bound_ms"],
        "bound_by": fleet[128]["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
