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
 13. df        ops/df.py's error-free transforms exact on the card (in
               float64, 2^20 pairs) and df_matvec at 128 x 2510 x 385
               within 1e-12 of the float64 product
 14. loop_osqp truncation="osqp" on the default DYNUS loop, 6 cycles at 128
               and at 32 scenarios: ms per cycle, blocks run, the share of
               candidates frozen before the cap, ew_chain launches (one
               per iteration run) and host reads per cycle
 15. loop_adaptive a factor per candidate with in-solve adaptive rho and
               temporal rho, 6 cycles at 32: rho switches per solve, the
               carried rho's range, peak memory
 16. loop_polish polish=True on the default and fused paths, 6 cycles at
               32: the polish's share of the cycle, accepted share,
               median KKT residual, peak memory; polish_small: the polish
               on the card against the CPU on small converged QPs
 17. card/cpu  each new option on the small config, held to 1e-4 m
 18. loop_options the default DYNUS loop at 32 scenarios for 6 cycles,
               then each loop option of benchmark/capture.LOOP_OPTIONS on
               it (the rigid-body quadrotor plant, goal relax with its
               stall counter started past the grace, the FOV rows, the
               constant-obstacle MPC, the flat iteration, stationary
               refinement, the drift-aware factor refresh, the stale
               predictor history) and the quadrotor plant and the FOV rows
               on the fused path: ms per cycle, exact kernel launches per
               cycle (ew_chain 100 on the default path, 0 under flat_iter;
               fleet_admm 1 on the fused path), factor refreshes per
               cycle; fleet_admm against its plain version on the FOV
               candidate QPs at 32 scenarios, to phase 6's limits; and
               each option on the small config, card against CPU, held to
               1e-4 m
 20. real_perception the real-perception DYNUS loop
               (benchmark/capture.real_dynus_config: real_loop --dynus
               --obstacles 200 --max-obstacles 64 --max-tracks 16; depth
               render, DBSCAN, KF tracks, static clustering of each seed's
               prebuilt map, the sampled predictor) at 32 scenarios, 6
               cycles after a warm-up on the default path: ms per cycle,
               device ms per stage (render, dbscan, tracking, the rest of
               the sense tick, clustering, predictor, plan, control),
               DBSCAN's rounds and host reads per cycle, kernel launches
               per cycle, ew_chain exactly 100 per cycle, peak memory; and
               3 cycles on the fused path, fleet_admm exactly 1 per cycle
 21. card/cpu  the small real-perception configs (micro world, DYNUS-style
               world with static clustering) for 3 cycles, held to 1e-4 m
               with equal track tables and integer perception stats
 22. kernel    fleet_admm against its plain version at 32 scenarios: to
               phase 6's limits on the candidate QPs of the GT DYNUS loop
               with static clustering (64 + 1 + 16 = 81 slots, padded to
               88); on the real configuration's (16 tracks + 1 + 16
               static slots), whose float32 iterate departs from the
               float64 one faster, after 10 iterations within twice the
               plain version's own distance from its float64 run
 23. goal_mode the DYNUS goal-mode protocol (ref_modes --dynus: 200
               obstacles, each seed's prebuilt static map, RRT 2048
               iterations, 12 waypoints, L = 384) at 8 scenarios, "global"
               and "linspace": the first cycle (the build pass) and 6 MPC
               cycles, ms per cycle, the build's stages (threefry, RRT and
               shortcut, min-snap rounds, sampling and tail), kernel
               launches of a build cycle and of an MPC cycle, ew_chain
               exactly 100 per cycle (build cycles included), host reads
               per cycle (1 composed, 0 linspace), peak memory, each
               committed route's head, tail and largest step; "global" on
               the fused path, fleet_admm exactly 1 per cycle; the wall
               world in each ref_mode, card against CPU, held to 1e-4 m
               with equal ref_len and stop_replans; utils/prng.py's bits
               on the card equal to the CPU's
 24. modules   neither jax nor the JAX package was imported
Then a JSON line with each kernel's numbers, and last
{"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is present.
"""

import contextlib
import dataclasses
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


# the solver options that card_vs_cpu holds on the small config, beside
# the default and fused paths. The per-candidate entry refines once, as
# the CPU parity tests hold that path: with refine_iters = 0 each x-update
# is Minv rhs alone and carries the card's and the CPU's float32 factor
# rounding straight into x (9.4e-6 m at cycle 0, 1.07e-4 m by cycle 3)
NEW_OPTIONS = (
    ("truncation_osqp", dict(truncation="osqp")),
    ("per_candidate_adaptive_temporal", dict(
        shared_factor=False, adaptive_rho=True, temporal_rho=True,
        refine_iters=1)),
    ("temporal_rho", dict(temporal_rho=True)),
    ("polish", dict(polish=True)),
    ("polish_fused", dict(polish=True, fused_solve=True)))

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
    """Launches of each kernel in `cycles` cycles of cfg's solve path (the
    flat iteration, which runs on the shared factor of the predictor
    path, launches no ew_chain)."""
    sv = cfg.planner.solver
    if sv.fused_solve:
        return {"ew_chain": 0, "fleet_admm": cycles, "dense_loop": 0}
    flat = (sv.flat_iter and sv.shared_factor and cfg.engine.use_predictor
            and sv.truncation != "osqp")
    return {"ew_chain": 0 if flat else cycles * sv.max_iter,
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


def check_fleet_kernel(cfg, S, dev, float64_limit=False):
    """fleet_admm against fleet_solve_reference on the QPs of the third
    cycle (the second with obstacle rows) of cfg's fused loop; its time,
    bound, the design's streamed bytes and its phase split.

    Phase 6's limits: x within 1e-5 of max|x| after 1 iteration, the
    unscaled candidate states within 1e-3 m after 10, after 100 finite
    with the same acceptance. With `float64_limit` (QPs whose float32
    iterate departs from the float64 one faster than that, as the real
    configuration's with their static rows do) the plain version also runs
    in float64, and after 10 iterations the kernel's states must lie
    within max(1e-3, 2 x the float32 plain version's own distance) of the
    float64 ones; after 100 both must be finite, and the acceptance masks
    are reported."""
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
    fp64 = fl.FleetProblem(*(t.double() for t in fp)) if float64_limit \
        else None
    out = {"scenarios": S, "problems": S * 6, "active_obstacle_rows": rows,
           "qp_slots": qps.G.shape[-2],
           "fleet_slots": fl.fleet_dims(pcfg, qps.G.shape[-2], S).K}

    def states(x):
        return qplib.split_z(fl.unpack_x(pcfg, x, fac.D.to(x.dtype)), pcfg)[0]
    for iters in (1, 10, 100):
        got = fl.fleet_solve(pcfg, fp, iters, refine)
        want = fl.fleet_solve_reference(pcfg, fp, iters, refine)
        torch.cuda.synchronize()
        rg = fl.fleet_result(pcfg, qps, fac, *got)
        rw = fl.fleet_result(pcfg, qps, fac, *want)
        xg, xw = got[0][:, :fl.LIVE], want[0][:, :fl.LIVE]
        rel_x = float((xg - xw).abs().max() / xw.abs().max())
        diff = float((states(got[0]) - states(want[0])).abs().max())
        duals = max(float((a - b).abs().max() / (b.abs().max() + 1.0))
                    for a, b in zip(rg.y, rw.y))
        same_mask = bool(torch.equal(accepted(rg), accepted(rw)))
        line = dict(x_rel_diff=rel_x, state_max_abs_diff=diff,
                    dual_rel_diff=duals, accepted=int(accepted(rg).sum()),
                    same_acceptance=same_mask)
        if fp64 is not None:
            s64 = states(fl.fleet_solve_reference(pcfg, fp64, iters, refine)[0])
            line["kernel_vs_float64"] = float(
                (states(got[0]).double() - s64).abs().max())
            line["plain_vs_float64"] = float(
                (states(want[0]).double() - s64).abs().max())
        out["iters_%d" % iters] = line
        if iters == 1:
            check(rel_x <= 1e-5, ("fleet_admm 1 iteration", S, rel_x))
        elif iters == 10:
            if fp64 is None:
                check(diff <= 1e-3, ("fleet_admm 10 iterations", S, diff))
            else:
                lim = max(1e-3, 2.0 * line["plain_vs_float64"])
                check(line["kernel_vs_float64"] <= lim,
                      ("fleet_admm 10 iterations against float64", S,
                       line["kernel_vs_float64"], lim))
                line["float64_limit"] = lim
            out["max_abs_err"] = diff
        else:
            check(all(bool(torch.isfinite(t).all())
                      for t in list(got) + list(want)),
                  ("fleet_admm 100 iterations: non-finite", S))
            if fp64 is None:
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


def with_solver(cfg, **kw):
    import dataclasses
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver, **kw)))


def check_df(dev):
    """The double-float transforms on the card: two_sum, two_prod and split
    exact (checked in float64) on 2^20 seeded pairs, and df_matvec at the
    polish's A shape for 128 scenarios (128 x 2510 x 385) against the
    float64 product, beside plain float32's error and its time."""
    import torch
    from intent_mpc_torch.benchmark.capture import cuda_time_ms
    from intent_mpc_torch.ops import df
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    n = 1 << 20
    a = torch.randn(n, generator=g, device=dev)
    b = torch.randn(n, generator=g, device=dev) * 1e-4
    c = torch.randn(n, generator=g, device=dev)
    s, e = df.two_sum(a, b)
    check(torch.equal(s.double() + e.double(), a.double() + b.double()),
          "df.two_sum is not exact on the card")
    nz_sum = int((e != 0).sum())
    p, e = df.two_prod(a, c)
    check(torch.equal(p.double() + e.double(), a.double() * c.double()),
          "df.two_prod is not exact on the card")
    nz_prod = int((e != 0).sum())
    big = a * 1e6
    hi, lo = df.split(big)
    check(torch.equal(hi + lo, big)
          and all(torch.equal((h * h).float().double(), h * h)
                  for h in (hi.double(), lo.double())),
          "df.split is not exact on the card")
    check(nz_sum > 0 and nz_prod > 0, "error terms all zero: no teeth")
    M = torch.randn((128, 2510, 385), generator=g, device=dev)
    x = torch.randn((128, 385), generator=g, device=dev)
    zeros = torch.zeros_like(x)
    mh, ml = df.df_matvec(M, x, zeros)
    ref = torch.matmul(M.double(), x.double()[..., None])[..., 0]
    den = ref.abs() + 1.0
    rel = float(((mh.double() + ml.double() - ref).abs() / den).max())
    plain = float(((torch.matmul(M, x[..., None])[..., 0].double() - ref)
                   .abs() / den).max())
    check(rel < 1e-12, ("df_matvec relative error", rel))
    ms = cuda_time_ms(lambda: df.df_matvec(M, x, zeros), reps=5)
    plain_ms = cuda_time_ms(lambda: torch.matmul(M, x[..., None]), reps=5)
    return dict(pairs=n, two_sum_exact=True, two_prod_exact=True,
                split_exact=True, nonzero_errors=[nz_sum, nz_prod],
                matvec_shape=[128, 2510, 385], matvec_rel_err=rel,
                plain_f32_rel_err=plain, matvec_ms=ms, plain_matvec_ms=plain_ms)


class SolveRecorder:
    """Stands in for models/mpc.py's admm_solve, polish and
    make_plan_with_pred during a run: keeps each solve's per-problem
    iterations and rho switches, each polish's result with CUDA events
    around the call, and each plan (its factor refreshes)."""

    def __enter__(self):
        from intent_mpc_torch.models import mpc as mpclib
        self.mpc = mpclib
        self.solve, self.pol = mpclib.admm_solve, mpclib.polish
        self.plan = mpclib.make_plan_with_pred
        self.results, self.polishes, self.plans = [], [], []

        def plan(*a, **k):
            out = self.plan(*a, **k)
            self.plans.append(out)
            return out

        def solve(*a, **k):
            res = self.solve(*a, **k)
            self.results.append(res)
            return res

        def polish(cfg, qp, x, y, scfg=None):
            import torch
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = self.pol(cfg, qp, x, y, scfg)
            t1.record()
            self.polishes.append((t0, t1, out, x))
            self.last_polish_args = (cfg, qp, x, y)
            return out
        mpclib.admm_solve, mpclib.polish = solve, polish
        mpclib.make_plan_with_pred = plan
        return self

    def __exit__(self, *exc):
        self.mpc.admm_solve, self.mpc.polish = self.solve, self.pol
        self.mpc.make_plan_with_pred = self.plan


def run_path(cfg, S, cycles, dev, start=None):
    """One warm-up cycle, then `cycles` cycles of cfg's loop from a fresh
    carry (changed by `start(carry, cfg)` where given) with the launch
    counts and the truncation host reads set to 0 just before and read
    just after, the peak device memory, and the recorded solves,
    polishes and plans. Every float leaf of the carry but the metrics
    must be finite; the metrics' non-finite fields are returned as
    `non_finite_metrics` (a cycle whose every candidate is rejected adds
    the chosen candidate's non-finite residual to prim_res_sum, in JAX
    too), and the default paths hold them finite."""
    import torch
    from intent_mpc_torch.benchmark.capture import run_loop
    from intent_mpc_torch.ops import admm as admmlib
    run_loop(cfg, S, 1, dev, start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    admmlib.HOST_READS = 0
    with SolveRecorder() as rec:
        carry, secs, _ = run_loop(cfg, S, cycles, dev, start)
    launches = launch_counts()
    check(finite_carry(carry._replace(metrics=None)), "non-finite carry leaf")
    check(int(carry.metrics.solve_successes.sum()) > 0, "no successful solve")
    bad = [f for f, t in zip(carry.metrics._fields, carry.metrics)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    out = dict(scenarios=S, cycles=cycles, launches=launches,
               cycle_ms=sum(secs) / cycles * 1e3,
               cycle_ms_each=[round(x * 1e3, 3) for x in secs],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               min_solve_successes=int(carry.metrics.solve_successes.min()),
               non_finite_metrics=bad)
    return out, carry, rec, admmlib.HOST_READS


def check_loop_osqp(cfg, S, cycles, dev):
    """truncation="osqp" on the default path: per cycle the blocks the
    termination loop ran (its longest problem's iterations over the check
    interval), the share of candidates frozen before the cap, ew_chain
    launches (one per iteration the loop ran) and host reads."""
    c = with_solver(cfg, truncation="osqp")
    sv = c.planner.solver
    out, _, rec, reads = run_path(c, S, cycles, dev)
    check(not out["non_finite_metrics"], out["non_finite_metrics"])
    iters = [r.iters for r in rec.results]
    check(len(iters) == cycles, ("solves recorded", len(iters)))
    ran = [int(t.max()) for t in iters]
    check(out["launches"]["ew_chain"] == sum(ran),
          ("ew_chain launches against iterations run", out["launches"], ran))
    check(out["launches"]["fleet_admm"] == 0
          and out["launches"]["dense_loop"] == 0, out["launches"])
    out.update(max_iter=sv.max_iter, check_interval=sv.term_check_interval,
               blocks_per_cycle=[r / sv.term_check_interval for r in ran],
               frozen_before_cap=float(sum(
                   int((t < sv.max_iter).sum()) for t in iters))
               / sum(t.numel() for t in iters),
               frozen_per_cycle=[float((t < sv.max_iter).float().mean())
                                 for t in iters],
               ew_chain_launches_per_cycle=out["launches"]["ew_chain"]
               / cycles,
               host_reads=reads, host_reads_per_cycle=reads / cycles)
    return out


def check_loop_adaptive(cfg, S, cycles, dev):
    """A factor per candidate with in-solve adaptive rho and temporal rho:
    the rho switches per solve (each switch refactors; every problem is
    refactored after each block but the last, and keeps the factor only
    where its rho moved), and the range of the carried rho."""
    import torch
    c = with_solver(cfg, shared_factor=False, adaptive_rho=True,
                    temporal_rho=True)
    sv = c.planner.solver
    out, carry, rec, _ = run_path(c, S, cycles, dev)
    check(not out["non_finite_metrics"], out["non_finite_metrics"])
    blocks = max(sv.max_iter // sv.adapt_interval, 1)
    check(out["launches"]["ew_chain"] == cycles * blocks * sv.adapt_interval,
          ("ew_chain launches", out["launches"]))
    sw = [r.rho_switches.float() for r in rec.results]
    rho = carry.planner.rho
    check(bool(torch.isfinite(rho).all()), "non-finite carried rho")
    out.update(blocks_per_solve=blocks,
               factorizations_per_solve=blocks,
               rho_switches_per_solve=float(sum(float(s.sum()) for s in sw)
                                            / sum(s.numel() for s in sw)),
               rho_switches_per_cycle=[float(s.mean()) for s in sw],
               carried_rho_min=float(rho.min()),
               carried_rho_max=float(rho.max()))
    return out


def check_loop_polish(cfg, S, cycles, dev, held=4):
    """polish=True on one path: the polish's CUDA-event span per cycle and
    its share of the cycle, the share of scenarios whose polish passed the
    gate, the median final KKT residual over the finite ones and the share
    that is NaN (on the infeasible DYNUS QPs the correction rounds do not
    converge: duals near 3e7, residuals that grow; the JAX version
    diverges there too, to other values, and both gates reject), and the
    path's launches. Held: an accepted polish is finite, a rejected one
    hands back its input bit for bit, and the last cycle's polish of the
    first `held` scenarios, rerun on the CPU from the same inputs, has the
    same acceptance and, where accepted, x within 1e-4."""
    import math
    import torch
    from intent_mpc_torch.ops import polish as pol
    c = with_solver(cfg, polish=True)
    out, _, rec, _ = run_path(c, S, cycles, dev)
    check(not out["non_finite_metrics"], out["non_finite_metrics"])
    check(len(rec.polishes) == cycles, ("polishes recorded",
                                        len(rec.polishes)))
    exp = expected_launches(c, cycles)
    check(out["launches"] == exp, ("launches", out["launches"], exp))
    pol_ms = [a.elapsed_time(b) for a, b, _, _ in rec.polishes]
    acc = [p.accepted for _, _, p, _ in rec.polishes]
    for _, _, p, x_in in rec.polishes:
        a = p.accepted
        check(bool(torch.isfinite(p.x[a]).all())
              and bool(torch.isfinite(p.kkt_res[a]).all()),
              "an accepted polish is not finite")
        check(torch.equal(p.x[~a], x_in[~a]),
              "a rejected polish changed its input")
    kkt = [float(v) for _, _, p, _ in rec.polishes for v in p.kkt_res.cpu()]
    finite = [v for v in kkt if math.isfinite(v)]
    pcfg, qp, x, y = rec.last_polish_args

    def part(t):
        return type(t)(*(part(v) for v in t)) if isinstance(t, tuple) \
            else t[:held].cpu()
    card = rec.polishes[-1][2]
    cpu = pol.polish(pcfg, part(qp), part(x), part(y))
    both = card.accepted[:held].cpu() & cpu.accepted
    diff = float((card.x[:held].cpu() - cpu.x)[both].abs().max()) \
        if bool(both.any()) else 0.0
    check(torch.equal(card.accepted[:held].cpu(), cpu.accepted),
          ("polish acceptance, card against CPU",
           card.accepted[:held].tolist(), cpu.accepted.tolist()))
    check(diff <= 1e-4, ("polish card against CPU", diff))
    out.update(polish_ms_each=[round(v, 3) for v in pol_ms],
               polish_share=sum(pol_ms) / (out["cycle_ms"] * cycles),
               accepted_share=float(sum(int(a.sum()) for a in acc))
               / sum(a.numel() for a in acc),
               accepted_per_cycle=[int(a.sum()) for a in acc],
               median_kkt_res=(statistics.median(finite) if finite
                               else None),
               nan_kkt_share=1.0 - len(finite) / len(kkt),
               last_cycle_vs_cpu=dict(scenarios=held,
                                      accepted=int(both.sum()),
                                      max_abs_diff=diff, tol=1e-4))
    return out


def check_polish_small(dev):
    """The polish on the card against its CPU run, on 6 seeded small QPs
    (horizon 10, 4 slots, 3 active) from an 800-iteration per-candidate
    ADMM solve on the CPU: every polish accepted on both, x within 1e-5,
    final KKT residual below 1e-4."""
    import torch
    from intent_mpc_torch.ops import admm as admmlib
    from intent_mpc_torch.ops import polish as pol
    from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig
    pcfg = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
        max_iter=800, refine_iters=1))
    qps = small_fleet_qps(pcfg, 1, "cpu")
    res = admmlib.admm_solve(pcfg, qps)
    cpu = pol.polish(pcfg, qps, res.x, res.y)

    def to(t):
        return type(t)(*(to(v) for v in t)) if isinstance(t, tuple) \
            else t.to(dev)
    card = pol.polish(pcfg, to(qps), res.x.to(dev), to(res.y))
    diff = float((card.x.cpu() - cpu.x).abs().max())
    check(bool(card.accepted.all()) and bool(cpu.accepted.all()),
          ("polish rejected", card.accepted.tolist(), cpu.accepted.tolist()))
    check(diff <= 1e-5, ("polish card against CPU", diff))
    kkt = float(card.kkt_res.max())
    check(kkt < 1e-4, ("polish KKT residual on the card", kkt))
    return dict(problems=6, accepted=True, max_abs_diff=diff, tol=1e-5,
                max_kkt_res=kkt)


def check_loop_options(cfg, S, cycles, dev):
    """The default loop, then each loop option on the default path and the
    quadrotor plant and the FOV rows on the fused path, from fresh
    carries: each run's exact kernel launches (expected_launches), ms per
    cycle, the shared factor's refreshes per cycle (scenarios refreshed
    over scenarios, per cycle; None where the path keeps no shared
    factor), and what the option moved. Returns the phase lines."""
    import torch
    from intent_mpc_torch.benchmark.capture import (LOOP_OPTIONS, fused,
                                                    option_start,
                                                    with_option)
    runs = [("default", None)] + [("default", n) for n in LOOP_OPTIONS] \
        + [("fused", "quadrotor"), ("fused", "use_fov")]
    lines = []
    for solve, name in runs:
        c = cfg if name is None else with_option(cfg, name)
        c = fused(c) if solve == "fused" else c
        start = None if name is None else option_start(name)
        out, carry, rec, _ = run_path(c, S, cycles, dev, start)
        # stationary refinement diverges on some production cycles: every
        # candidate rejected, the chosen one's residual non-finite, as in
        # JAX (ROADMAP queue 3); the other paths keep every metric finite
        check(name == "stationary" or not out["non_finite_metrics"],
              (name, solve, out["non_finite_metrics"]))
        out["rejected_solves"] = int((carry.metrics.solve_attempts
                                      - carry.metrics.solve_successes).sum())
        exp = expected_launches(c, cycles)
        check(out["launches"] == exp, (name, solve, "launches",
                                       out["launches"], exp))
        refreshed = [p.refreshed for p in rec.plans]
        shared = all(r is not None for r in refreshed) and refreshed
        out.update(
            option=name or "none", solve=solve,
            launches_per_cycle={k: v / cycles
                                for k, v in out["launches"].items()},
            refreshes_per_cycle=([float(r.float().mean()) for r in refreshed]
                                 if shared else None))
        if name == "goal_relax":
            out["stall_cycles_end"] = [int(carry.stall_cycles.min()),
                                       int(carry.stall_cycles.max())]
        if name == "quadrotor":
            tilt = 2.0 * torch.acos(torch.clamp(
                torch.sqrt(carry.quad.quat[:, 0] ** 2
                           + carry.quad.quat[:, 3] ** 2), max=1.0))
            out["max_tilt_rad"] = float(tilt.max())
            check(float(tilt.max()) > 0.0, "the rigid body never tilted")
        lines.append(out)
    return lines


# the loop options of the card_vs_cpu entries: the loop_options runs on the
# small config (LOOP_OPTIONS names; "fused" ones on the fleet path). The
# constant-obstacle entry refines once per x-update, as the CPU parity test
# holds it: at refine_iters 0 the x-update is Minv rhs alone and carries
# each device's float32 factor rounding into x
SMALL_OPTIONS = (("default", "quadrotor", {}), ("default", "goal_relax", {}),
                 ("default", "use_fov", {}),
                 ("default", "no_predictor", dict(refine_iters=1)),
                 ("default", "flat_iter", {}), ("default", "stationary", {}),
                 ("default", "drift_refresh", {}),
                 ("default", "predictor_stale", {}),
                 ("fused", "quadrotor", {}), ("fused", "use_fov", {}))


def check_small_options(tiny, dev):
    """Each SMALL_OPTIONS entry on the small config for 4 cycles, card
    against CPU: positions within 1e-4 m, equal solve counts."""
    import torch
    from intent_mpc_torch.benchmark.capture import (fused, option_start,
                                                    run_loop, with_option)
    lines = []
    for solve, name, solver in SMALL_OPTIONS:
        c = with_solver(with_option(tiny, name), **solver)
        c = fused(c) if solve == "fused" else c
        start = option_start(name)
        cc, _, pg = run_loop(c, 2, 4, dev, start)
        cc_cpu, _, pc = run_loop(c, 2, 4, "cpu", start)
        diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
        check(max(diffs) <= 1e-4, (name, solve, diffs))
        check(finite_carry(cc) and finite_carry(cc_cpu), "non-finite carry")
        check(torch.equal(cc.metrics.solve_successes.cpu(),
                          cc_cpu.metrics.solve_successes),
              ("solve counts differ", name, solve))
        lines.append(dict(config="small", option=name, solve=solve,
                          scenarios=2, cycles=4,
                          max_pos_diff_per_cycle=diffs, held_cycles=4,
                          tol=1e-4))
    return lines


class StageTimer:
    """Stands in for the real-perception cycle's stage functions during a
    run: CUDA events around every call, summed per stage. render is the
    depth render and its projection to points, dbscan the detector's
    clustering, tracking the KF track step, perception the whole sense
    tick (so perception - render - dbscan - tracking is the detection
    extraction, history rings and stats), clustering the static rows,
    predictor and plan their calls."""

    def __init__(self, sites=None):
        from intent_mpc_torch.engine import closed_loop as cl
        from intent_mpc_torch.models import mpc, perception, predictor
        from intent_mpc_torch.models import real_detector, sensor
        self.sites = sites or [("render", sensor, "render_depth"),
                      ("render", perception, "project_depth"),
                      ("dbscan", real_detector, "dbscan"),
                      ("tracking", perception, "track_step"),
                      ("perception", cl, "_sense"),
                      ("clustering", cl, "_static_rows"),
                      ("predictor", predictor, "predict"),
                      ("plan", mpc, "make_plan_with_pred")]
        self.events = {}

    def __enter__(self):
        import torch
        self.saved = [getattr(m, a) for _, m, a in self.sites]
        for (stage, m, a), fn in zip(self.sites, self.saved):
            def timed(*args, _fn=fn, _stage=stage, **kw):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = _fn(*args, **kw)
                t1.record()
                self.events.setdefault(_stage, []).append((t0, t1))
                return out
            setattr(m, a, timed)
        return self

    def __exit__(self, *exc):
        for (_, m, a), fn in zip(self.sites, self.saved):
            setattr(m, a, fn)

    def ms(self):
        """Device ms per stage, summed over the run's calls."""
        import torch
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


def kernel_launches(fn):
    """CUDA kernels fn() launches, counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda)


def check_real_perception(cfg, S, cycles, dev, stages):
    """The real-perception DYNUS loop (benchmark/capture.real_dynus_config)
    at S scenarios: one warm-up cycle, then `cycles` cycles with the
    launch counts, DBSCAN's host reads and rounds set to 0 just before and
    read just after; ms per cycle; with `stages`, device ms per cycle of
    each stage (StageTimer; control is the cycle's remainder), and the
    kernels of one more cycle; peak device memory."""
    import torch
    from intent_mpc_torch.benchmark.capture import run_loop
    from intent_mpc_torch.benchmark.real_loop import static_maps
    from intent_mpc_torch.engine import closed_loop as cl
    from intent_mpc_torch.models import clustering as clus
    from intent_mpc_torch.models.world import straight_line_ref_traj
    from intent_mpc_torch.parallel import sharding as sh
    run_loop(cfg, S, 1, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    clus.HOST_READS = clus.ROUNDS = 0
    timer = StageTimer()
    scen = sh.stack_scenarios(cfg, range(S), device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device=dev)
    occ, veto = static_maps(cfg, range(S), dev)
    carry = cl.init_carry(cfg, scen, device=dev)
    secs, cyc = [], []
    with timer if stages else contextlib.nullcontext():
        for i in range(cycles):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                       carry, i, veto_occ=veto)
            b.record()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            cyc.append(a.elapsed_time(b))
    launches = launch_counts()
    reads, rounds = clus.HOST_READS, clus.ROUNDS
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches == expected_launches(cfg, cycles),
          ("real_perception launches", launches))
    check(finite_carry(carry), "non-finite carry leaf (real perception)")
    check(int(carry.metrics.solve_successes.sum()) > 0, "no successful solve")
    live = int(carry.real_det.tracks.live.sum())
    check(live > 0, "no live track after the run")
    out = dict(scenarios=S, cycles=cycles, launches=launches,
               launches_per_cycle={k: v / cycles for k, v in launches.items()},
               cycle_ms=sum(secs) / cycles * 1e3,
               cycle_ms_each=[round(x * 1e3, 3) for x in secs],
               device_cycle_ms=sum(cyc) / cycles,
               dbscan_host_reads_per_cycle=reads / cycles,
               dbscan_rounds_per_cycle=rounds / cycles,
               peak_memory_gb=peak, live_tracks=live,
               births=int(carry.real_det.stats.births_sum.sum()),
               static_rows_active=int(cl._static_rows(
                   cfg, occ, carry.pos)[3].sum()))
    if stages:
        ms = timer.ms()
        per = {k: v / cycles for k, v in ms.items()}
        per["perception_other"] = per["perception"] - per["render"] \
            - per["dbscan"] - per["tracking"]
        per["control"] = sum(cyc) / cycles - per["perception"] \
            - per["clustering"] - per["predictor"] - per["plan"]
        out["stage_ms_per_cycle"] = per
        out["kernel_launches_per_cycle"] = kernel_launches(
            lambda: cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry,
                                    cycles, veto_occ=veto))
    return out


def goal_build_sites():
    """The goal-mode build's stages for StageTimer: threefry (every RRT
    draw of the build, one batched hash), rrt (the RRT and its shortcut,
    the draws included), minsnap (the corridor-shrink loop: 10 min-snap
    solves and their collision samples) and build (the whole build pass,
    its host read and commit included)."""
    from intent_mpc_torch.engine import closed_loop as cl
    from intent_mpc_torch.engine import ref_builder as rb
    from intent_mpc_torch.models import global_planner as gp
    from intent_mpc_torch.models import poly_planner as pp
    return [("threefry", gp, "rrt_draws"), ("rrt", rb, "rrt_plan"),
            ("minsnap", pp, "plan"), ("build", cl, "_build_ref")]


def check_goal_dynus(ref_mode, S, mpc_cycles, dev, fused_solve=False,
                     count_build_launches=True):
    """The DYNUS goal-mode protocol (benchmark/capture.goal_dynus, the
    flags of `ref_modes --dynus`) at S scenarios: one warm-up cycle, then
    from a fresh carry the first cycle (in the composed modes the build
    pass) and `mpc_cycles` more, with the launch counts and the engine's
    build-flag host reads set to 0 just before and read just after: ms
    per cycle, device ms of the build's stages, the committed routes'
    properties (head at the drone, end at the goal, steps under 1 m),
    kernel launches of one MPC cycle and (with count_build_launches; the
    profiler takes about a minute over a build's ~345k launches) of one
    build cycle, peak memory."""
    import torch
    from intent_mpc_torch.benchmark import capture as C
    from intent_mpc_torch.engine import closed_loop as cl
    cfg, run = C.goal_dynus(ref_mode, S, dev, fused_solve)
    composed = cl.composed(cfg)
    C.goal_step(cfg, run, C.goal_init(cfg, run, dev), 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    cl.HOST_READS = 0
    timer = StageTimer(goal_build_sites())
    carry = C.goal_init(cfg, run, dev)
    cycles = 1 + mpc_cycles
    secs = []
    with timer if composed else contextlib.nullcontext():
        for i in range(cycles):
            t0 = time.perf_counter()
            carry, _ = C.goal_step(cfg, run, carry, i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    launches = launch_counts()
    reads = cl.HOST_READS
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches == expected_launches(cfg, cycles),
          ("goal_mode launches", ref_mode, launches))
    check(reads == (cycles if composed else 0),
          ("goal_mode host reads", ref_mode, reads))
    check(finite_carry(carry), ("non-finite carry leaf (goal mode)",
                                ref_mode))
    check(int(carry.metrics.solve_successes.min()) > 0,
          ("a scenario never solved (goal mode)", ref_mode))
    out = dict(ref_mode=ref_mode, fused=fused_solve, scenarios=S,
               cycles=cycles, launches=launches,
               launches_per_cycle={k: v / cycles for k, v in launches.items()},
               host_reads_per_cycle=reads / cycles,
               first_cycle_ms=secs[0] * 1e3,
               mpc_cycle_ms=sum(secs[1:]) / mpc_cycles * 1e3,
               cycle_ms_each=[round(x * 1e3, 3) for x in secs],
               peak_memory_gb=peak,
               stop_replans=carry.metrics.stop_replans.tolist())
    step1 = cycles
    out["kernel_launches_mpc_cycle"] = kernel_launches(
        lambda: C.goal_step(cfg, run, carry, step1))
    if composed:
        ms = timer.ms()
        out["build_stage_ms"] = {
            "threefry": ms["threefry"],
            "rrt_and_shortcut": ms["rrt"] - ms["threefry"],
            "minsnap_rounds": ms["minsnap"],
            "sampling_and_tail": ms["build"] - ms["rrt"] - ms["minsnap"],
            "build": ms["build"]}
        check(not bool(carry.need_ref.any()), ("a route was not committed",
                                               ref_mode))
        start = torch.tensor(cfg.start, device=dev)
        goal = torch.tensor(cfg.goal, device=dev)
        n = carry.ref_len.long()
        ref = carry.ref_traj
        ar = torch.arange(S, device=dev)
        head = torch.linalg.vector_norm(ref[:, 0] - start, dim=-1)
        tail = torch.linalg.vector_norm(ref[ar, n - 1] - goal, dim=-1)
        steps = torch.linalg.vector_norm(ref[:, 1:] - ref[:, :-1], dim=-1)
        valid = torch.arange(ref.shape[1] - 1, device=dev) < (n - 1)[:, None]
        max_step = torch.where(valid, steps, torch.zeros_like(steps)).amax(-1)
        out["routes"] = dict(ref_len=n.tolist(),
                             head_m=head.tolist(), tail_m=tail.tolist(),
                             max_step_m=max_step.tolist())
        check(float(head.max()) < 1e-3 and float(tail.max()) < 1e-3
              and float(max_step.max()) < 1.0, ("route properties", out))
        if count_build_launches:
            out["kernel_launches_build_cycle"] = kernel_launches(
                lambda: C.goal_step(cfg, run, C.rearm_build(carry), step1))
    return out


def check_goal_small(dev):
    """The wall world in goal mode (benchmark/capture.goal_wall_loop, two
    seeds from the test start: stop+replan at cycle 0, the composed
    modes' build at cycle 1, their first two solves at cycles 2 and 3;
    linspace solves from cycle 1) for 4 cycles at ref_poly_iters 20 (the
    400-iteration float32 min-snap solve amplifies rounding to
    centimetres, tests/test_torch_goal_mode.py), card against CPU:
    positions within 1e-4 m, ref_len and stop_replans equal per cycle."""
    from intent_mpc_torch.benchmark.capture import goal_wall_loop
    lines = []
    for mode in ("linspace", "minsnap", "global"):
        cg, pg, ng = goal_wall_loop(mode, [0, 2], 4, dev, 20)
        cc, pc, nc = goal_wall_loop(mode, [0, 2], 4, "cpu", 20)
        diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
        check(max(diffs) <= 1e-4, ("goal_small", mode, diffs))
        same = all((a[0] is None or bool((a[0] == b[0]).all()))
                   and bool((a[1] == b[1]).all()) for a, b in zip(ng, nc))
        check(same, ("goal_small ref_len or stop_replans differ", mode))
        check(finite_carry(cg) and finite_carry(cc), "non-finite carry")
        lines.append(dict(config="goal_wall_small", ref_mode=mode,
                          scenarios=2, cycles=4, tol=1e-4,
                          max_pos_diff_per_cycle=diffs,
                          ref_len=(None if ng[-1][0] is None
                                   else ng[-1][0].tolist()),
                          stop_replans=ng[-1][1].tolist(),
                          counts_equal=same))
    return lines


def check_prng(dev):
    """utils/prng.py on the card bit-equal to the CPU: the keys of 8
    scenarios folded with cycle indices up to 2^31 - 1, each folded with
    2048 RRT iterations, split, and drawn from with uniform(()) and
    uniform((3,))."""
    import torch
    from intent_mpc_torch.utils import prng
    out = {}
    for where in (dev, "cpu"):
        keys = prng.prng_key(torch.arange(1000, 1008), where)
        k = prng.fold_in(keys[:, None], torch.tensor(
            [0, 1, 77, 2 ** 31 - 1], device=where)[None])
        it = prng.split(prng.fold_in(k[:, :, None],
                                     torch.arange(2048, device=where)))
        out[str(where)] = [k, it, prng.uniform(it[..., 0, :]),
                           prng.uniform(it[..., 1, :], (3,))]
    card, cpu = out[str(dev)], out["cpu"]
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    check(equal, "prng: card and CPU bits differ")
    return dict(draws=int(cpu[3].numel() + cpu[2].numel()), bit_equal=equal)


def check_real_small(dev):
    """The small real-perception configs (benchmark/capture.real_small_config:
    the micro world and the DYNUS-style world with static clustering) for
    3 cycles at 2 scenarios, card against CPU: positions within 1e-4 m,
    equal solve counts, track tables and integer perception stats."""
    import torch
    from intent_mpc_torch.benchmark.capture import real_small_config, run_loop
    lines = []
    for world in ("micro", "dynus"):
        c = real_small_config(world)
        cc, _, pg = run_loop(c, 2, 3, dev)
        cc_cpu, _, pc = run_loop(c, 2, 3, "cpu")
        diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
        check(max(diffs) <= 1e-4, ("real_small", world, diffs))
        check(finite_carry(cc) and finite_carry(cc_cpu), "non-finite carry")
        check(torch.equal(cc.metrics.solve_successes.cpu(),
                          cc_cpu.metrics.solve_successes),
              ("solve counts differ", "real_small", world))
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            (cc.real_det.tracks.live, cc.real_det.tracks.age)
            + tuple(cc.real_det.stats[1:]),
            (cc_cpu.real_det.tracks.live, cc_cpu.real_det.tracks.age)
            + tuple(cc_cpu.real_det.stats[1:])))
        check(same, ("real_small track tables or stats differ", world))
        lines.append(dict(config="real_small", world=world, scenarios=2,
                          cycles=3, max_pos_diff_per_cycle=diffs,
                          held_cycles=3, tol=1e-4, tracks_and_stats_equal=same))
    return lines


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

    # ---- 13-17. the OSQP-semantics solve: df, truncation, adaptive rho,
    # the polish, and card against CPU ----
    t_opt = time.perf_counter()
    phase("df", **check_df(dev))
    torch.cuda.empty_cache()
    osqp = {}
    for S in (128, 32):
        osqp[S] = check_loop_osqp(cfg, S, 6, dev)
        phase("loop_osqp", **osqp[S])
    adaptive = check_loop_adaptive(cfg, 32, 6, dev)
    phase("loop_adaptive", **adaptive)
    polished = {}
    for name, c in (("default", cfg), ("fused", fused(cfg))):
        polished[name] = check_loop_polish(c, 32, 6, dev)
        phase("loop_polish", solve=name, **polished[name])
    phase("polish_small", **check_polish_small(dev))
    for name, kw in NEW_OPTIONS:
        c = with_solver(tiny, **kw)
        cc, _, pg = run_loop(c, 2, 4, dev)
        cc_cpu, _, pc = run_loop(c, 2, 4, "cpu")
        diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
        check(max(diffs) <= 1e-4, (name, diffs))
        check(finite_carry(cc) and finite_carry(cc_cpu), "non-finite carry")
        check(torch.equal(cc.metrics.solve_successes.cpu(),
                          cc_cpu.metrics.solve_successes),
              ("solve counts differ", name))
        phase("card_vs_cpu", config="small", solve=name, scenarios=2,
              cycles=4, max_pos_diff_per_cycle=diffs, held_cycles=4, tol=1e-4,
              carried_rho_card=cc.planner.rho.cpu().tolist(),
              carried_rho_cpu=cc_cpu.planner.rho.tolist())
    phase("option_phases", seconds=time.perf_counter() - t_opt)

    # ---- 18. the loop options: launches, times, refreshes; fleet_admm on
    # the FOV rows; card against CPU ----
    from intent_mpc_torch.benchmark.capture import with_option
    t_loop = time.perf_counter()
    options = check_loop_options(cfg, 32, 6, dev)
    for line in options:
        phase("loop_options", **line)
    fleet_fov = check_fleet_kernel(with_option(cfg, "use_fov"), 32, dev)
    phase("kernel", kernel="fleet_admm", config="use_fov", **fleet_fov)
    for line in check_small_options(tiny, dev):
        phase("card_vs_cpu", **line)
    phase("loop_option_phases", seconds=time.perf_counter() - t_loop)

    # ---- 20-22. the real-perception DYNUS loop: the phase at S = 32 on the
    # default path (stages, host reads, memory) and on the fused path;
    # card against CPU on the small configs; fleet_admm on its QPs ----
    from intent_mpc_torch.benchmark.capture import real_dynus_config
    t_real = time.perf_counter()
    rcfg = real_dynus_config()
    real = check_real_perception(rcfg, 32, 6, dev, stages=True)
    phase("real_perception", solve="default", nvidia_smi=smi, **real)
    real_f = check_real_perception(fused(rcfg), 32, 3, dev, stages=False)
    phase("real_perception", solve="fused", nvidia_smi=smi, **real_f)
    for line in check_real_small(dev):
        phase("card_vs_cpu", **line)
    fleet_real = check_fleet_kernel(fused(rcfg), 32, dev, float64_limit=True)
    phase("kernel", kernel="fleet_admm", config="real_dynus", **fleet_real)
    gt_static = rcfg.replace(engine=dataclasses.replace(
        rcfg.engine, use_fake_detector=True))
    fleet_81 = check_fleet_kernel(fused(gt_static), 32, dev)
    phase("kernel", kernel="fleet_admm", config="gt_dynus_static_rows",
          **fleet_81)
    phase("real_phases", seconds=time.perf_counter() - t_real)

    # ---- 23. goal mode: the DYNUS goal-mode protocol at S = 8 (build
    # cycle + 6 MPC cycles) for "global" and "linspace", "global" fused;
    # card against CPU on the wall world; the generator's bits ----
    t_goal = time.perf_counter()
    goal = {m: check_goal_dynus(m, 8, 6, dev) for m in ("global", "linspace")}
    for m in ("global", "linspace"):
        phase("goal_mode", nvidia_smi=smi, **goal[m])
    goal_f = check_goal_dynus("global", 8, 3, dev, fused_solve=True,
                              count_build_launches=False)
    phase("goal_mode", nvidia_smi=smi, **goal_f)
    for line in check_goal_small(dev):
        phase("card_vs_cpu", **line)
    phase("prng", **check_prng(dev))
    phase("goal_phases", seconds=time.perf_counter() - t_goal)

    # ---- 24. clean modules ----
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
        "launches_of_other_paths": {
            "real_perception_32": real["launches"]["ew_chain"],
            "goal_global_8": goal["global"]["launches"]["ew_chain"],
            "goal_linspace_8": goal["linspace"]["launches"]["ew_chain"],
            "truncation_osqp_128": osqp[128]["launches"]["ew_chain"],
            "truncation_osqp_32": osqp[32]["launches"]["ew_chain"],
            "per_candidate_adaptive_32": adaptive["launches"]["ew_chain"],
            "polish_32": polished["default"]["launches"]["ew_chain"],
            **{"%s_32" % o["option"]: o["launches"]["ew_chain"]
               for o in options if o["solve"] == "default"}},
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
        "launches_of_other_paths": {
            "real_perception_fused_32": real_f["launches"]["fleet_admm"],
            "goal_global_fused_8": goal_f["launches"]["fleet_admm"],
            "polish_fused_32": polished["fused"]["launches"]["fleet_admm"],
            **{"%s_fused_32" % o["option"]: o["launches"]["fleet_admm"]
               for o in options if o["solve"] == "fused"}},
        "max_abs_err": fleet[128]["max_abs_err"],
        "max_abs_diff": fleet[128]["max_abs_err"],
        "max_abs_err_of": "unscaled candidate states after 10 iterations",
        "ms_of_other_qps": {
            "real_dynus_32": fleet_real["ms"],
            "gt_dynus_static_rows_32": fleet_81["ms"]},
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
