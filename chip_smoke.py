#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device    name, power limit (nvidia-smi)
  2. build     nvcc of every intent_mpc_torch/csrc/*.cu, in parallel
  3. kernel    ew_chain against its plain PyTorch version at the
               production shapes (128 and 32 scenarios x 6 candidates,
               horizon 30, 65 obstacle slots, timed; 33 and 1 scenarios,
               whose x and cb segments end inside a float4), including
               +-inf bounds, rho = 1e-6 rows, duals of 1e4 and a NaN row;
               bit-equal, NaN masks equal
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
               mask; its time, bound, the design's streamed bytes (and
               their time at HBM peak) and its phase split; and the full
               solve of a small config within 1e-3
  7. loop_fused the DYNUS loop with fused_solve=True (bench.py --fused)
               for 8 cycles at 128 and at 32 scenarios: exactly one
               fleet_admm launch per cycle and no ew_chain launch
  8. card/cpu  the fused loop on the small config, held to 1e-3 m
  9. kernel    dense_loop against its plain version at 128 and at 32
               scenarios, on the real candidate QPs of a constrained cycle
               of the default DYNUS loop as the dense-A path builds them
               (structured factor, refine 0): after 1 iteration x within
               1e-5 of max|x|, after 10 the unscaled candidate states
               within 1e-3 m, after 100 both finite with the same
               acceptance mask; its time, bound, A's nonzeros against
               their structural maximum and the kernel's CSR capacity, and
               the design's streamed bytes; on a small config (dense
               factor, 150 iterations, refine 0 and 1) within 1e-3 of
               max|x|, and admm_solve_dense against admm_solve within 2e-3
     entry     admm_solve_dense on the 128-scenario candidates through its
               public signature: exactly one dense_loop launch; the loop
               phases (4, 7) launched it no time
 10. harness   benchmark/harness.run_trials at the full DYNUS config on
               16 seeds for 12 cycles, default and fused path: the JAX
               harness's 28 row keys in its order, finite floats, the 14
               aggregate keys, trials.csv read back equal by
               analyze.load_rows, the path's launches, seconds per cycle
 11. checkpoint the same seeds with a 1.2 s timeout (12 cycles), both
               paths: run_trials_checkpointed (a snapshot every 5 cycles,
               off the factor-refresh cycles 0, 4, 8) gives rows identical
               (==) to run_trials, and a run cut at 5 cycles and resumed
               from its file gives rows identical to the uninterrupted one
 12. latency   bench.latency at 32 scenarios, both paths: 50 blocking and
               50 pipelined depth-1 cycles, p50/p99/max ms against the
               100 ms budget, with the card's name and power limit
 13. modules   neither jax nor the JAX package was imported
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
    x[min(7, N - 1)] = float("nan")
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
    from intent_mpc_torch.engine.checkpoint import flatten
    bad = [t.shape for t in flatten(carry)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    return not bad


# the JAX harness's row keys, in its order (harness.py:254-283)
HARNESS_KEYS = [
    "trial_id", "seed", "num_obstacles", "dynamic_ratio", "goal_reached",
    "timeout_reached", "collision", "collision_count", "flight_travel_time",
    "path_length", "straight_line_distance", "path_efficiency",
    "min_distance_to_obstacles", "vel_violation_count", "acc_violation_count",
    "jerk_violation_count", "vel_total_samples", "acc_total_samples",
    "jerk_total_samples", "max_velocity", "max_acceleration", "avg_velocity",
    "jerk_rms", "jerk_integral", "mpc_solve_count", "mpc_solve_successes",
    "mpc_prim_res_avg", "mpc_prim_res_max"]


def launch_counts():
    from intent_mpc_torch.ops import dense_loop as dl
    from intent_mpc_torch.ops import ew_chain as ew
    from intent_mpc_torch.ops import fleet as fl
    return {"ew_chain": ew.EW_LAUNCHES, "fleet_admm": fl.FLEET_LAUNCHES,
            "dense_loop": dl.DENSE_LAUNCHES}


def reset_launch_counts():
    from intent_mpc_torch.ops import dense_loop as dl
    from intent_mpc_torch.ops import ew_chain as ew
    from intent_mpc_torch.ops import fleet as fl
    ew.EW_LAUNCHES = fl.FLEET_LAUNCHES = dl.DENSE_LAUNCHES = 0


def expected_launches(cfg, cycles):
    """Launches of each kernel in `cycles` cycles of cfg's solve path."""
    if cfg.planner.solver.fused_solve:
        return {"ew_chain": 0, "fleet_admm": cycles, "dense_loop": 0}
    return {"ew_chain": cycles * cfg.planner.solver.max_iter,
            "fleet_admm": 0, "dense_loop": 0}


def with_timeout(cfg, seconds):
    import dataclasses
    return cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                  timeout=seconds))


def first_row_diff(a, b):
    for i, (ra, rb) in enumerate(zip(a, b)):
        for k in ra:
            if ra[k] != rb[k]:
                return (i, k, ra[k], rb[k])
    return None if len(a) == len(b) else ("rows", len(a), len(b))


def check_harness(cfg, seeds, cycles, out_dir, dev):
    """run_trials on one solve path: JAX's 28 keys in order, finite floats,
    the 14 aggregate keys, the CSV round trip, and the path's launches."""
    import math
    from intent_mpc_torch.benchmark import analyze, harness
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = harness.run_trials(cfg, seeds, num_cycles=cycles, device=dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    check(launches == expected_launches(cfg, cycles),
          ("harness launches", launches))
    check(all(list(r) == HARNESS_KEYS for r in rows), "harness row keys")
    check(all(math.isfinite(v) for r in rows for v in r.values()
              if isinstance(v, float)), "non-finite harness value")
    agg = harness.aggregate(rows)
    check(len(agg) == 14, ("aggregate keys", sorted(agg)))
    path = os.path.join(out_dir, "trials.csv")
    harness.save_csv(rows, path)
    back = analyze.load_rows(path)
    check(back == rows, ("CSV round trip", first_row_diff(back, rows)))
    return dict(trials=len(rows), cycles=cycles, seconds=secs,
                seconds_per_cycle=secs / cycles, launches=launches,
                solver_success_rate=agg["solver_success_rate"],
                collisions=sum(r["collision"] for r in rows))


def check_checkpoint(cfg, seeds, chunk, cut, out_dir, dev):
    """run_trials_checkpointed against run_trials (==), and a run cut after
    `cut` cycles and resumed from its file against the uninterrupted
    checkpointed run (==)."""
    import shutil
    from intent_mpc_torch.benchmark import harness
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    plain = harness.run_trials(cfg, seeds, device=dev)
    ck = harness.run_trials_checkpointed(
        cfg, seeds, os.path.join(out_dir, "whole.npz"), chunk_cycles=chunk,
        device=dev)
    check(ck == plain, ("checkpointed rows differ from run_trials",
                        first_row_diff(ck, plain)))
    cut_path = os.path.join(out_dir, "cut.npz")
    harness.run_trials_checkpointed(
        with_timeout(cfg, cut * cfg.engine.control_dt
                     * cfg.engine.ticks_per_cycle),
        seeds, cut_path, chunk_cycles=chunk, device=dev)
    resumed = harness.run_trials_checkpointed(cfg, seeds, cut_path,
                                              chunk_cycles=chunk, device=dev)
    check(resumed == ck, ("resumed rows differ", first_row_diff(resumed, ck)))
    return dict(trials=len(seeds), cycles=cfg.engine.num_cycles,
                chunk_cycles=chunk, cut_at=cut, rows_equal=True,
                resumed_equal=True, seconds=time.perf_counter() - t0)


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


def fleet_stream(pcfg, fp, iters, refine):
    """What the fleet kernel's design streams from L2 or HBM in one solve:
    per scenario and iteration, Minv's live rows (n x n rounded up to 4
    columns) once per apply, the obstacle records (32 B per live slot)
    once per row pass, and z_obs / y_obs read and written in the update
    pass; plus the first pass's records and z/y writes."""
    from intent_mpc_torch.ops import fleet as fl
    S, n = fp.minv.shape[0], pcfg.num_vars
    d = fl.fleet_dims(pcfg, fp.gx.shape[-1], S)
    slots = fl.LIVE * d.W * d.K
    minv = n * ((n + 3) // 4 * 4) * 4
    rec = slots * 32
    zy = slots * 4
    per_iter = (1 + refine) * (minv + rec) + 4 * zy
    return S * (iters * per_iter + rec + 2 * zy)


def check_fleet_kernel(cfg, S, dev):
    """fleet_admm against fleet_solve_reference on the QPs of the third
    cycle (the second with obstacle rows) of the fused DYNUS loop; its
    time, bound, the design's streamed bytes and its phase split."""
    import torch
    from intent_mpc_torch.benchmark import fleet_phases
    from intent_mpc_torch.benchmark.capture import (capture_fused_qps,
                                                    cuda_time_ms)
    from intent_mpc_torch.ops import build
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
    stream = fleet_stream(pcfg, fp, 100, refine)
    d = fl._check(pcfg, fp)
    clk = torch.zeros((S, len(fl.PHASES)), dtype=torch.int64, device=dev)
    counted_ms = cuda_time_ms(
        lambda: fl._launch(pcfg, fp, d, 100, refine, clk), reps=5)
    split = fleet_phases.phase_split(clk, 100, ms, counted_ms)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, iters_timed=100,
               streamed_bytes=stream,
               streamed_ms=stream / PEAK_BYTES_PER_S * 1e3,
               **build.kernel_resources("fleet_admm"),
               phase_split={k: split[k]["share"] for k in fl.PHASES},
               phase_count_overhead=split["count_overhead"])
    return out


def dense_bound(sp, iters, refine):
    """Least time for the dense loop on an H100, the larger of two times.
    Bytes: each input the solve reads once, the dense A included (M only
    when refine > 0), and x written once, over HBM bandwidth. Operations:
    the float32 work these inputs need, over the float32 peak, with A's
    products counted on its nonzeros (sp.amat != 0): per candidate the
    prologue's A x0 (2 nnz), then per iteration A^T w and A x (4 nnz),
    1 + refine Minv and refine M products (2 n^2 each), and the
    elementwise work (12 per row, 6 + 2 refine per variable). The kernel's
    extra A^T w after the last iteration, which nothing reads, is not
    counted. Also returns what the kernel's design streams: A once, Minv
    (and M) once per apply, and lo and hi once per iteration."""
    C, n = sp.q.shape
    m = sp.rho.shape[-1]
    nnz = int((sp.amat != 0).sum())
    per_iter = (1 + 2 * refine) * 2 * n * n + 12 * m + (6 + 2 * refine) * n
    flops = 2 * nnz + iters * (4 * nnz + C * per_iter)
    nbytes = sum(t.numel() * 4 for f, t in zip(sp._fields, sp)
                 if f != "mmat" or refine) + C * n * 4
    stream = C * 4 * (m * n + iters * ((1 + 2 * refine) * n * n + 2 * m))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops, stream)


def check_dense_kernel(cfg, S, dev):
    """dense_loop against dense_loop_reference on the QPs of the third
    cycle (the second with obstacle rows) of the default DYNUS loop, built
    as admm_solve_dense builds them. Returns the phase's fields and the
    plain version's 100-iteration acceptance mask."""
    import torch
    from intent_mpc_torch.benchmark.capture import (capture_default_qps,
                                                    cuda_time_ms)
    from intent_mpc_torch.ops import admm as admmlib
    from intent_mpc_torch.ops import build
    from intent_mpc_torch.ops import dense_loop as dl
    from intent_mpc_torch.ops import qp as qplib
    pcfg = cfg.planner
    scfg = pcfg.solver
    refine = scfg.refine_iters
    n = pcfg.num_vars
    qps, warm = capture_default_qps(cfg, S, 2, dev)
    rows = int(qps.obs_active.sum())
    check(rows > 0, "the captured cycle has no obstacle rows")
    n_pad, m_pad = admmlib.dense_pads(pcfg, qps.G.shape[-2])
    flat = admmlib._flatten(qps, 2)
    sp, (D, _, _) = admmlib._dense_scaled_problem(
        pcfg, flat, warm.reshape(-1, n), scfg, n_pad, m_pad)
    # A's nonzeros against their structural maximum and the kernel's CSR
    # (10 bytes per nonzero: value, column, row, place in the A^T lists;
    # uint16 row and column pointers)
    K = qps.G.shape[-2]
    m = 2 * 8 * pcfg.horizon + (5 + K) * pcfg.mpc_window
    per = (sp.amat != 0).sum(dim=(-2, -1))
    nnz_max = qplib.dense_a_nnz_max(pcfg, K)
    cap = dl.csr_capacity(n_pad, m_pad)
    check(int(per.max()) <= nnz_max <= cap,
          ("A's nonzeros, structural maximum, CSR capacity",
           int(per.max()), nnz_max, cap))
    nnz = float(per.float().mean())
    out = {"scenarios": S, "problems": S * 6, "active_obstacle_rows": rows,
           "n_pad": n_pad, "m_pad": m_pad, "refine": refine,
           "structured_factor": scfg.structured_factor,
           "a_nnz_per_candidate": nnz,
           "a_nnz_per_candidate_max": int(per.max()),
           "a_nnz_structural_max": nnz_max,
           "a_csr_capacity": cap,
           "a_nonzero_share": nnz / (m * n),
           "a_csr_bytes_per_candidate": nnz * 10 + (m_pad + n_pad + 2) * 2}
    for iters in (1, 10, 100):
        got = dl.admm_iterations_dense(sp, iters, scfg.sigma, scfg.alpha,
                                       refine)
        want = dl.dense_loop_reference(sp, iters, scfg.sigma, scfg.alpha,
                                       refine)
        torch.cuda.synchronize()
        rel_x = float((got - want).abs().max() / want.abs().max())
        xg, xw = D * got[:, :n], D * want[:, :n]
        states = float((qplib.split_z(xg, pcfg)[0]
                        - qplib.split_z(xw, pcfg)[0]).abs().max())
        rg = admmlib.dense_result(pcfg, flat, xg, scfg)
        rw = admmlib.dense_result(pcfg, flat, xw, scfg)
        same_mask = bool(torch.equal(accepted(rg), accepted(rw)))
        out["iters_%d" % iters] = dict(
            x_rel_diff=rel_x, state_max_abs_diff=states,
            accepted=int(accepted(rg).sum()), same_acceptance=same_mask)
        if iters == 1:
            check(rel_x <= 1e-5, ("dense_loop 1 iteration", S, rel_x))
        elif iters == 10:
            check(states <= 1e-3, ("dense_loop 10 iterations", S, states))
            out["max_abs_err"] = states
        else:
            check(bool(torch.isfinite(got).all())
                  and bool(torch.isfinite(want).all()),
                  ("dense_loop 100 iterations: non-finite", S))
            check(same_mask, ("dense_loop 100 iterations: acceptance", S))
            mask = accepted(rw).reshape(S, 6)
    reps = 5
    ms = cuda_time_ms(lambda: dl.admm_iterations_dense(
        sp, 100, scfg.sigma, scfg.alpha, refine), reps=reps)
    plain_ms = cuda_time_ms(lambda: dl.dense_loop_reference(
        sp, 100, scfg.sigma, scfg.alpha, refine), reps=3)
    bound_ms, bound_by, nbytes, flops, stream = dense_bound(sp, 100, refine)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, stream_bytes=stream,
               stream_ms_at_peak=stream / PEAK_BYTES_PER_S * 1e3,
               iters_timed=100, reps=reps,
               **build.kernel_resources("dense_loop"))
    return out, mask, qps, warm


def check_dense_small(dev):
    """The horizon-10, 4-slot config of tests/test_pallas_admm.py (dense
    factor, 150 iterations) on 4 x 6 seeded QPs: kernel and plain version
    within 1e-3 of max|x| at refine 0 and 1, and admm_solve_dense against
    admm_solve (factor=None) within 2e-3 (rtol and atol) at refine 0.
    Also reports, after 1 and after 150 iterations, each candidate's own
    max|dx| / max|x| (candidate p's static obstacles take their yaw from
    seed p): the spread the card tests' limits are read against."""
    import dataclasses
    import torch
    from intent_mpc_torch.ops import admm as admmlib
    from intent_mpc_torch.ops import dense_loop as dl
    from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig
    pcfg = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
        max_iter=150, refine_iters=0, structured_factor=False))
    n = pcfg.num_vars
    qps = small_fleet_qps(pcfg, 4, dev)
    warm = torch.zeros((4, 6, n), device=dev)
    n_pad, m_pad = admmlib.dense_pads(pcfg, qps.G.shape[-2])
    out = {}
    for refine in (0, 1):
        scfg = dataclasses.replace(pcfg.solver, refine_iters=refine)
        sp, _ = admmlib._dense_scaled_problem(
            pcfg, admmlib._flatten(qps, 2), warm.reshape(-1, n), scfg,
            n_pad, m_pad)
        spread = {}
        for iters in (1, 150):
            got = dl.admm_iterations_dense(sp, iters, scfg.sigma, scfg.alpha,
                                           refine)
            want = dl.dense_loop_reference(sp, iters, scfg.sigma, scfg.alpha,
                                           refine)
            torch.cuda.synchronize()
            each = ((got - want).abs().amax(-1) / want.abs().amax(-1)).tolist()
            spread["iters_%d" % iters] = dict(
                min=min(each), median=statistics.median(each), max=max(each),
                x_rel_diff=float((got - want).abs().max()
                                 / want.abs().max()))
        diff = float((got - want).abs().max())
        rel = diff / float(want.abs().max())
        check(rel <= 1e-3, ("dense_loop small config", refine, diff, rel))
        out["refine_%d" % refine] = dict(max_abs_diff=diff, x_rel_diff=rel,
                                         per_candidate=spread)
    res = admmlib.admm_solve_dense(pcfg, qps, warm, 150)
    ref = admmlib.admm_solve(pcfg, qps, warm, 150)
    torch.cuda.synchronize()
    diff = float((res.x - ref.x).abs().max())
    check(bool(torch.allclose(res.x, ref.x, rtol=2e-3, atol=2e-3)),
          ("admm_solve_dense against admm_solve", diff))
    out["entry_vs_admm_solve_max_abs_diff"] = diff
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
    from intent_mpc_torch.benchmark.capture import cuda_time_ms, fused, run_loop
    from intent_mpc_torch.ops import admm as admmlib
    from intent_mpc_torch.ops import build
    from intent_mpc_torch.ops import dense_loop as dl
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
              bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
              **build.kernel_resources("ew_chain"))
        del args, got, want
    for S in (33, 1):                     # x and cb end inside a float4
        args = production_ew_inputs(S, cfg, dev)
        check(args[0].numel() % 4 and args[2].cb.numel() % 4,
              ("ragged segment ends", S))
        got = ew.ew_chain(alpha, *args)
        want = ew.ew_chain_reference(alpha, *args)
        torch.cuda.synchronize()
        phase("kernel", kernel="ew_chain", scenarios=S, problems=S * 6,
              bit_equal=True, max_abs_err=check_bit_equal(got, want))
        del args, got, want
    max_err, ms, plain_ms, bound_ms, bound_by = timed[128]

    # ---- 4. closed loop at production size ----
    loop = {}
    for s in (128, 32):
        run_loop(cfg, s, 1, dev)          # warm-up: library handles, caches
        ew.EW_LAUNCHES = 0
        fl.FLEET_LAUNCHES = 0
        dl.DENSE_LAUNCHES = 0
        carry, secs, _ = run_loop(cfg, s, 8, dev)
        launches = ew.EW_LAUNCHES
        iters = cfg.planner.solver.max_iter
        check(launches == 8 * iters, ("kernel launches", launches, 8 * iters))
        check(fl.FLEET_LAUNCHES == 0, ("fleet_admm launches on the default "
                                       "path", fl.FLEET_LAUNCHES))
        check(dl.DENSE_LAUNCHES == 0, ("dense_loop launches on the default "
                                       "path", dl.DENSE_LAUNCHES))
        check(finite_carry(carry), "non-finite carry leaf")
        succ = carry.metrics.solve_successes
        check(int(succ.sum()) > 0, "no successful solve")
        elapsed = sum(secs)
        loop[s] = dict(launches=launches, fleet_admm_launches=0,
                       dense_loop_launches=0,
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
        dl.DENSE_LAUNCHES = 0
        carry, secs, _ = run_loop(fused(cfg), s, 8, dev)
        launches, ew_launches = fl.FLEET_LAUNCHES, ew.EW_LAUNCHES
        check(launches == 8, ("fleet_admm launches", launches, 8))
        check(ew_launches == 0, ("ew_chain launches on the fused path",
                                 ew_launches))
        check(dl.DENSE_LAUNCHES == 0, ("dense_loop launches on the fused "
                                       "path", dl.DENSE_LAUNCHES))
        check(finite_carry(carry), "non-finite carry leaf (fused)")
        succ = carry.metrics.solve_successes
        check(int(succ.sum()) > 0, "no successful solve (fused)")
        elapsed = sum(secs)
        loop_f[s] = dict(launches=launches, ew_chain_launches=ew_launches,
                         dense_loop_launches=0,
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

    # ---- 9. dense-A kernel against plain version, real QPs; the entry ----
    dense, entry_in = {}, None
    for S in (128, 32):
        dense[S], mask, qps_d, warm_d = check_dense_kernel(cfg, S, dev)
        phase("kernel", kernel="dense_loop", **dense[S])
        if S == 128:
            entry_in = (qps_d, warm_d, mask)
        del qps_d, warm_d
        torch.cuda.empty_cache()
    phase("kernel", kernel="dense_loop", config="small", scenarios=4,
          iters=150, tol_rel=1e-3, entry_tol=2e-3, **check_dense_small(dev))
    qps_d, warm_d, mask = entry_in
    dl.DENSE_LAUNCHES = 0
    res = admmlib.admm_solve_dense(cfg.planner, qps_d, warm_d)
    torch.cuda.synchronize()
    dense_launches = dl.DENSE_LAUNCHES
    check(dense_launches == 1, ("dense_loop launches per admm_solve_dense "
                                "call", dense_launches))
    n = cfg.planner.num_vars
    check(tuple(res.x.shape) == (128, 6, n), ("entry x shape", res.x.shape))
    check(bool(torch.isfinite(res.x).all()), "entry: non-finite x")
    check(torch.equal(accepted(res), mask),
          "entry: acceptance differs from the plain version's")
    check(bool(torch.isnan(res.dual_res).all())
          and all(bool(torch.isnan(g).all()) for g in res.y),
          "entry: the duals are not NaN")
    phase("entry", fn="admm_solve_dense", scenarios=128, problems=128 * 6,
          iters=cfg.planner.solver.max_iter, launches=dense_launches,
          accepted=int(accepted(res).sum()), solved=int(res.solved.sum()),
          loop_phase_launches=0)
    del entry_in, qps_d, warm_d, res
    torch.cuda.empty_cache()

    # ---- 10-12. the multi-trial harness, checkpointed resume, latency ----
    from intent_mpc_torch.benchmark import bench
    t_new = time.perf_counter()
    seeds = list(range(16))
    work = os.path.join(HERE, "build", "chip_smoke")
    paths = (("default", cfg), ("fused", fused(cfg)))
    for name, c in paths:
        phase("harness", solve=name, **check_harness(
            c, seeds, 12, os.path.join(work, "harness_" + name), dev))
    for name, c in paths:
        phase("checkpoint", solve=name, **check_checkpoint(
            with_timeout(c, 1.2), seeds, 5, 5,
            os.path.join(work, "checkpoint_" + name), dev))
    for name, f in (("default", False), ("fused", True)):
        reset_launch_counts()
        lat = bench.latency(32, cycles=50, fused=f, device=dev)
        phase("latency", solve=name, nvidia_smi=smi, launches=launch_counts(),
              **lat)
    phase("new_phases", seconds=time.perf_counter() - t_new)

    # ---- 13. clean modules ----
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
    }, {
        "name": "dense_loop",
        "route": "cuda",
        "source": "intent_mpc_torch/csrc/dense_loop.cu",
        "replaces": "intent_mpc_tpu/ops/pallas_admm.py:70 (_kernel)",
        "launches": dense_launches,
        "launches_of": "one admm_solve_dense call (no closed-loop path)",
        "max_abs_err": dense[128]["max_abs_err"],
        "max_abs_diff": dense[128]["max_abs_err"],
        "max_abs_err_of": "unscaled candidate states after 10 iterations",
        "ms": dense[128]["ms"],
        "plain_ms": dense[128]["plain_ms"],
        "bound_ms": dense[128]["bound_ms"],
        "bound_by": dense[128]["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
