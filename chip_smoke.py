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
 12. latency   bench.latency at 32 scenarios, both paths: 20 blocking and
               20 pipelined depth-1 cycles, p50/p99/max ms against the
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
 24. mapping   the mapping stack at the DYNUS width (benchmark/capture.
               dynus_frames: the real-perception camera flown 2 s at 5 m/s
               along the start-to-goal line, 60 frames at 30 Hz, each
               seed's obstacles at the frame's time) at 32 scenarios on
               747 x 220 x 51 voxels at 0.15 m: device ms per frame of
               integrate_cloud and its kernel launches, the inflation,
               free_regions, octree builds (both unknown-space semantics),
               the goal-mode RRT over each octree (2048 iterations, step
               2.5, 20 m ahead; its launch-bound ms and the launches of
               one build per semantics), the ESDF of 4 seeds, peak memory
               (< 24 GB), occupied and unknown voxels, RRT successes, the
               share of the static solid volume in the swept range marked
               occupied; the small world card against CPU: log-odds
               bit-equal, octree answers equal, RRT paths within 1e-6 m
 25. perception_fusion the U-V detector, bird's-eye tracks, DBSCAN
               detections, mutual-best fusion on the same frames, the YOLO
               network on a seeded (32, 3, 352, 352) batch, decode,
               person_rects and fuse_external_2d: ms per frame per stage,
               ms per YOLO forward, live tracks, peak memory; small inputs
               card against CPU: network outputs within 1e-4, decoded
               boxes, track tables and fusion flags equal; the two phases'
               seconds (none of the three kernels launches in them)
 26. exploration the exploration and trajectory-optimisation stack on the
               mapping phase's 32 maps (747 x 220 x 51 at 0.15 m): 3 DEP
               cycles at DEPConfig() (device ms per stage: sampling,
               prune, gains, bellman_ford, scoring; live nodes,
               successes, launches of a cycle), the next-best view with
               its PRM path, RRT* (1024 iterations, step 2.5) and the PRM
               on the inflated grids to 20 m ahead (successes, launches,
               launch-bound ms), the grid wavefront on 8 grids (integer
               costs and 1e9), the ESDF of the 32 inflated grids, 100
               B-spline Adam steps from each RRT* path with the ESDF and
               the dynamic obstacles of the last 30 frames, each spline
               sampled every 0.1 s, divided into braking zones and
               time-parameterized at the planner's max_vel and max_acc
               (sampled speeds within the limits), peak memory; card
               against CPU on the small maps (DEP half-explored and
               walled, RRT*, PRM, wavefront, B-spline, divider, TOPP)
               and at full width for 2 scenarios (one dep_step's gains
               equal, one TOPP within 1e-5); none of the three kernels
               launches
 28. tools     the port's tools: entry() on the card against
               entry("cpu") (1e-4 m and m/s, exactly 10 ew_chain
               launches); benchmark/stage_profile at 32 scenarios of the
               production config (wall ms, device-busy ms and launches
               per stage); benchmark/roofline at 128 and 32 scenarios
               against phase 4's cycles (GFLOP, MB, the inverse apply
               against its HBM read, the L2 verdict, no share above 1);
               the f64 oracle in the loop (benchmark/oracle_loop, 32 QP
               slots) for 5 cycles of 2 scenarios, card against CPU (see
               ORACLE_TOL), no kernel launches, host round-trip ms per
               cycle; benchmark/demo.run_demo(seed=0) for 2 s of the
               production world (summarize's keys, finite values)
 30. fleet     the torch.distributed fleet (parallel/sharding.py) at world
               size 1 over NCCL in this process: batch_rollout with the
               mesh at 128 scenarios for 8 cycles on the default path
               (ew_chain exactly 800 launches) and the fused path
               (fleet_admm exactly 8), per-scenario metrics and aggregate
               bit-equal to the one-device batch_rollout of the same
               seeds, the collective inventory of the same program under
               torch.profiler exactly {"all-reduce": 2}, 32 bytes
 31. dryrun_multichip entry.dryrun_multichip(1) over NCCL in a process of
               its own: the toy flight reaches the goal in every episode,
               and the inventories of the toy, the production base
               program, goal mode "global" and the real detector are each
               the two all-reduces
 32. scaling   benchmark/scaling.run_study at world 1 (JAX's protocol: 4
               scenarios per device, 5 cycles, 8 obstacles, 30
               iterations): solves/s and the inventory
 33. solver_knobs the TPU-tuned solver options (Woodbury candidates, block
               and folded refinement, the bf16 factor, two-phase
               refinement) on the production config at 32 scenarios for 6
               cycles: ms per cycle, exact launches (ew_chain 100 per
               cycle but 0 under Woodbury and two phases), rejected
               solves, primal residuals; each on the small config, card
               against CPU (KNOB_TOL)
 29. modules   neither jax nor the JAX package was imported
Then a JSON line with each kernel's numbers, and last
{"ok": true, "device": {...}}.

Exits non-zero without a result when no CUDA device is present.
"""

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

from intent_mpc_torch.benchmark.roofline import H100, PEAKS

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = PEAKS[H100]


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(ok, what):
    """A failed check ends the run with a non-zero exit (unlike assert,
    it survives python -O)."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: %s" % (what,))


def nan_max(xs):
    """The largest of the floats xs (0.0 for none), NaN if any is NaN:
    Python's max passes over a NaN that does not come first."""
    xs = list(xs)
    return math.nan if any(map(math.isnan, xs)) else max(xs, default=0.0)


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
    """Launches of each kernel in `cycles` cycles of cfg's solve path. On
    the shared factor of the predictor path the flat iteration (unless
    the refinement is by blocks or folded), the Woodbury x-update and the
    two-phase refinement take no ew_chain (JAX's dispatch; truncation
    runs one phase)."""
    sv = cfg.planner.solver
    if sv.fused_solve:
        return {"ew_chain": 0, "fleet_admm": cycles, "dense_loop": 0}
    shared = sv.shared_factor and cfg.engine.use_predictor
    osqp = sv.truncation == "osqp"
    grouped = shared and (sv.woodbury_candidates or (
        not osqp and int(sv.max_iter * sv.shared_refine_warm_frac) > 0))
    flat = (shared and sv.flat_iter and not osqp and not sv.block_refine
            and not sv.folded_refine)
    return {"ew_chain": 0 if grouped or flat else cycles * sv.max_iter,
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
        check(nan_max(diffs) <= 1e-4, (name, solve, diffs))
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
    """CUDA kernels fn() launches, counted by torch.profiler (on its raw
    device events: building its event tree takes a minute over ~300k)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda)


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
        check(nan_max(diffs) <= 1e-4, ("goal_small", mode, diffs))
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
        check(nan_max(diffs) <= 1e-4, ("real_small", world, diffs))
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


# the DYNUS map of the mapping phase: real_loop.static_grid_for's extents
MAP_ORIGIN = (-2.0, -16.5, 0.0)
MAP_SIZE = (112.0, 33.0, 7.6)


def timed(fn):
    """(fn()'s result, device-timeline ms between CUDA events around it)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def swept_voxels(fr, m, rd, max_range):
    """Voxels of map m (nx, ny, nz) whose centers some frame's camera saw:
    inside its image, depth in (depth_min, max_range]. The frames' camera
    path is the same for every scenario."""
    import torch
    dev = m.log_odds.device
    axes = [m.origin[a] + (torch.arange(n, device=dev) + 0.5) * m.resolution
            for a, n in enumerate(m.log_odds.shape[1:])]
    c = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    seen = torch.zeros(c.shape[:3], dtype=torch.bool, device=dev)
    for f in range(fr.cam_pos.shape[0]):
        q = (c - fr.cam_pos[f, 0]) @ fr.rot[0]           # world -> optical
        z = q[..., 2]
        zs = torch.clamp(z, min=1e-6)
        u = rd.fx * q[..., 0] / zs + rd.cx
        v = rd.fy * q[..., 1] / zs + rd.cy
        seen |= ((z > rd.depth_min) & (z <= max_range) & (u >= 0)
                 & (u < rd.im_w) & (v >= 0) & (v < rd.im_h))
    return seen


def check_mapping(seeds, fr, dev):
    """The mapping stack at the DYNUS width (S = len(seeds) maps of
    MAP_SIZE at 0.15 m) on the camera frames fr (capture.dynus_frames):
    every frame integrated into each scenario's log-odds map (device ms
    per frame, kernel launches of one frame), then the inflated grids,
    free_regions at the dynamic obstacles' boxes of the last frame, the
    octrees (levels 4) in both unknown-space semantics, the goal-mode RRT
    (2048 iterations, step 2.5) over each octree from the last camera
    position to 20 m ahead, and the ESDF of 4 seeds' inflated grids; peak
    memory, occupied and unknown voxels, RRT successes and the kernel
    launches of one RRT build per semantics (its CUDA-event interval is
    the host's launch time of an eager loop, so it is reported as
    rrt_launch_bound_ms, not as device-busy time), and the share of
    the static solid volume inside the camera's swept range that the map
    marks occupied (reported, not gated). Returns (the phase's fields, the
    log-odds maps, the inflated grids)."""
    import torch
    from intent_mpc_torch.benchmark.capture import real_dynus_config
    from intent_mpc_torch.benchmark.real_loop import static_grid_for
    from intent_mpc_torch.models import global_planner as gp
    from intent_mpc_torch.models import mapping as mp
    from intent_mpc_torch.models import octo
    from intent_mpc_torch.models.world import generate_scenario_numpy
    from intent_mpc_torch.utils import prng
    rcfg_all = real_dynus_config()
    rd = rcfg_all.real_detector
    cfg = mp.MappingConfig()
    F, S = fr.pts.shape[:2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = mp.init_map(MAP_ORIGIN, MAP_SIZE, cfg, batch=S, device=dev)
    dims = tuple(m.log_odds.shape[1:])
    mp.integrate_cloud(cfg, m, fr.cam_pos[0], fr.pts[0], fr.valid[0])
    frame_ms = []
    for f in range(F):
        m, ms = timed(lambda m=m, f=f: mp.integrate_cloud(
            cfg, m, fr.cam_pos[f], fr.pts[f], fr.valid[f]))
        frame_ms.append(ms)
    launches = kernel_launches(lambda: mp.integrate_cloud(
        cfg, m, fr.cam_pos[-1], fr.pts[-1], fr.valid[-1]))
    lo = m.log_odds
    occupied = int((lo >= cfg.l_occ).sum())
    unknown = int((lo == 0.0).sum())
    check(occupied > 0 and bool(torch.isfinite(lo).all()),
          ("mapping: no occupied voxel or a non-finite log-odds", occupied))

    g, inflate_ms = timed(lambda: mp.to_occupancy_grid(cfg, m, inflated=True))
    dyn = fr.dynamic[..., None]
    inf = float("inf")
    box_lo = torch.where(dyn, fr.obs_pos[-1] - fr.obs_size / 2,
                         torch.full_like(fr.obs_size, inf))
    box_hi = torch.where(dyn, fr.obs_pos[-1] + fr.obs_size / 2,
                         torch.full_like(fr.obs_size, -inf))
    freed, free_ms = timed(lambda: mp.free_regions(
        g.grid, m.origin, m.resolution, box_lo, box_hi))
    cleared = int(((g.grid > 0) & (freed == 0)).sum())
    octos, octo_ms = {}, {}
    for ign in (True, False):
        octos[ign], octo_ms[ign] = timed(lambda ign=ign: octo.from_log_odds(
            m, cfg, levels=4, ignore_unknown=ign))

    start = fr.cam_pos[-1]
    goal = start + torch.tensor([20.0, 0.0, 0.0], device=dev)
    b_lo, b_hi = route_bounds(start, goal)
    rrt_cfg = gp.RRTConfig(max_iters=2048, incremental_dist=2.5,
                           goal_reach_dist=2.5, max_shortcut_dist=12.0)
    keys = prng.prng_key(torch.tensor([1000 + int(s) for s in seeds]), dev)
    rrt_ms, rrt_launches, successes = {}, {}, {}
    for ign in (True, False):
        def build(ign=ign):
            return gp.rrt_plan(octos[ign], start, goal, b_lo, b_hi, keys,
                               rrt_cfg)
        res, rrt_ms[ign] = timed(build)
        check(bool(torch.isfinite(res.path).all()), "mapping: RRT path")
        successes[ign] = int(res.success.sum())
        rrt_launches[ign] = kernel_launches(build)

    n_esdf = min(4, S)
    d, esdf_ms = timed(lambda: mp.esdf(g.grid[:n_esdf], m.resolution))
    occ4 = g.grid[:n_esdf] > 0
    check(bool(torch.isfinite(d).all()) and bool((d[occ4] <= 0).all())
          and bool((d[~occ4] > 0).all()), "mapping: ESDF signs")

    world = rcfg_all.world
    solid = torch.stack([static_grid_for(
        generate_scenario_numpy(int(s), world), resolution=cfg.resolution,
        inflation=(0.0, 0.0, 0.0), device=dev).grid for s in seeds]) > 0
    check(tuple(solid.shape[1:]) == dims, ("solid grid dims", solid.shape))
    seen = swept_voxels(fr, m, rd, cfg.raycast_max_len)[None]
    solid_seen = solid & seen
    share = float(((lo >= cfg.l_occ) & solid_seen).sum()) \
        / max(int(solid_seen.sum()), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 24.0, ("mapping peak memory", peak))
    return dict(
        scenarios=S, frames=F, map_dims=list(dims), resolution=m.resolution,
        voxels_per_map=dims[0] * dims[1] * dims[2],
        points_per_frame=fr.pts.shape[2],
        valid_points_per_frame=float(fr.valid.float().sum(-1).mean()),
        integrate_ms_per_frame=sum(frame_ms) / F,
        integrate_ms_each=[round(x, 3) for x in frame_ms],
        integrate_launches_per_frame=launches,
        inflate_ms=inflate_ms, free_regions_ms=free_ms,
        free_regions_cleared=cleared,
        octree_ms={"ignore_unknown": octo_ms[True],
                   "conservative": octo_ms[False]},
        rrt_launch_bound_ms={"ignore_unknown": rrt_ms[True],
                             "conservative": rrt_ms[False]},
        rrt_launches={"ignore_unknown": rrt_launches[True],
                      "conservative": rrt_launches[False]},
        rrt_successes={"ignore_unknown": successes[True],
                       "conservative": successes[False]},
        esdf_ms=esdf_ms, esdf_maps=n_esdf,
        occupied_voxels=occupied, unknown_voxels=unknown,
        solid_voxels_in_swept_range=int(solid_seen.sum()),
        solid_in_swept_range_occupied_share=share,
        peak_memory_gb=peak), m, g


def check_mapping_small(dev):
    """The mapping stack on the card against the CPU on the small world
    (capture.small_frames: 2 scenarios, 5 boxes, a 10 x 6 x 3 m map at
    0.2 m, 6 frames; the same projected points on both): log-odds
    bit-equal, octree search / is_blocked / segment_free answers equal in
    both semantics, the RRT over each octree within 1e-6 m with equal
    lengths and successes."""
    import torch
    from intent_mpc_torch.benchmark.capture import small_frames
    from intent_mpc_torch.models import global_planner as gp
    from intent_mpc_torch.models import mapping as mp
    from intent_mpc_torch.models import octo
    from intent_mpc_torch.utils import prng
    fr = small_frames(device="cpu")
    cfg = mp.MappingConfig(resolution=0.2)
    g = torch.Generator().manual_seed(0)
    q = torch.rand((2, 512, 3), generator=g) * torch.tensor([11.0, 7.0, 4.0]) \
        - 0.5
    a = torch.rand((2, 256, 3), generator=g) * torch.tensor([9.6, 5.6, 2.6]) \
        + 0.2
    b = torch.rand((2, 256, 3), generator=g) * torch.tensor([9.6, 5.6, 2.6]) \
        + 0.2
    start = torch.tensor([[2.0, 3.0, 1.5]] * 2)
    goal = torch.tensor([[9.5, 3.0, 1.5]] * 2)
    lo, hi = torch.tensor([[0.2, 0.2, 0.4]] * 2), torch.tensor([[9.8, 5.8, 2.6]] * 2)
    rcfg = gp.RRTConfig(max_iters=600, incremental_dist=0.5)
    out, succ = {}, []
    for where in (dev, "cpu"):
        m = mp.init_map((0.0, 0.0, 0.0), (10.0, 6.0, 3.0), cfg, batch=2,
                        device=where)
        for f in range(fr.pts.shape[0]):
            m = mp.integrate_cloud(cfg, m, fr.cam_pos[f].to(where),
                                   fr.pts[f].to(where), fr.valid[f].to(where))
        exact, paths = [m.log_odds], []
        for ign in (True, False):
            o = octo.from_log_odds(m, cfg, levels=3, ignore_unknown=ign)
            for lvl in range(3):
                exact += list(octo.search(o, q.to(where), lvl))
            exact += [octo.is_blocked(o, q.to(where)),
                      octo.segment_free(o, a.to(where), b.to(where))]
            r = gp.rrt_plan(o, start.to(where), goal.to(where), lo.to(where),
                            hi.to(where), prng.prng_key(torch.tensor([3, 4]),
                                                        where), rcfg)
            exact += [r.length, r.success]
            paths.append(r.path)
            succ.append(int(r.success.sum()))
        out[str(where)] = ([t.cpu() for t in exact], [t.cpu() for t in paths])
    (card, card_p), (cpu, cpu_p) = out[str(dev)], out["cpu"]
    equal = all(torch.equal(x, y) for x, y in zip(card, cpu))
    path_diff = max(float((x - y).abs().max()) for x, y in zip(card_p, cpu_p))
    check(equal, "mapping_small: log-odds or octree answers differ")
    check(path_diff <= 1e-6, ("mapping_small: RRT paths", path_diff))
    return dict(config="mapping_small", scenarios=2, frames=6,
                log_odds_bit_equal=torch.equal(card[0], cpu[0]),
                answers_equal=equal, rrt_path_max_diff_m=path_diff,
                rrt_tol_m=1e-6,
                rrt_successes={"ignore_unknown": succ[2],
                               "conservative": succ[3]},
                occupied_voxels=int((cpu[0] >= cfg.l_occ).sum()))


def uv_world_boxes(rd, bird, uboxes, cam_pos, rot):
    """Bird's-eye rects [x_left, y_near, w, d] (S, B, 4) in the camera's
    ground frame and their U-map boxes -> world AABBs (pos, size) (S, B,
    3): centered at the camera's height, as tall as the box's pixel height
    at its depth."""
    import torch
    from intent_mpc_torch.utils.device import f32
    from intent_mpc_torch.utils.rounding import matmul3
    x = bird[..., 0] + bird[..., 2] / 2
    z = bird[..., 1] + bird[..., 3] / 2
    h = uboxes[..., 3] * uboxes[..., 2] / f32(rd.fy, bird.device)
    c_opt = torch.stack([x, torch.zeros_like(x), z], dim=-1)
    s_opt = torch.stack([bird[..., 2], h, bird[..., 3]], dim=-1)
    # rounded alike on the card and the CPU (a matmul is not)
    pos = cam_pos[:, None] + matmul3(c_opt, rot.transpose(-1, -2))
    size = matmul3(s_opt, rot.abs().transpose(-1, -2))
    return pos, size


BIRD_TRACKS = 16        # bird's-eye track slots per scenario
YOLO_CONF = 0.15        # decode threshold under the seeded parameters


def check_perception_fusion(fr, dev):
    """The perception-fusion stack at S scenarios on the camera frames fr:
    per frame u_map_detect, bird_view_boxes, bird_track_step, the DBSCAN
    detection stage of models/real_detector and fuse_mutual_best of the
    U-V boxes (as world boxes) against its detections; the YOLO network
    on a seeded (S, 3, 352, 352) batch with seeded parameters, decode and
    person_rects; project_box_to_image and fuse_external_2d of the last
    frame's fused boxes against the person rects. Device ms per frame of
    each stage and kernel launches of one frame's, ms per YOLO forward of
    the batch, live bird's-eye tracks, peak memory."""
    import torch
    from intent_mpc_torch.benchmark.capture import (cuda_time_ms,
                                                    real_dynus_config)
    from intent_mpc_torch.models import perception as pc
    from intent_mpc_torch.models import real_detector as rdet
    from intent_mpc_torch.models import yolo
    from intent_mpc_torch.models.clustering import dbscan
    from intent_mpc_torch.utils.convert import yolo_state_dict
    rd = real_dynus_config().real_detector
    intr = rdet.intrinsics(rd)
    F, S = fr.pts.shape[:2]
    dt = 1.0 / 30.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracks = pc.init_bird_tracks(S, BIRD_TRACKS, dev)

    def run_frame(f, tracks, clock):
        """Frame f's stages in order, each run as clock(stage, fn)."""
        u = clock("u_map", lambda: pc.u_map_detect(intr, fr.depth[f]))
        bv = clock("bird_view", lambda: pc.bird_view_boxes(intr, *u))
        tracks = clock("bird_track", lambda: pc.bird_track_step(
            tracks, bv, u[1], dt))
        db = clock("dbscan_detect", lambda: rdet.extract_detections(
            rd, fr.pts[f], dbscan(fr.pts[f], fr.valid[f], eps=rd.dbscan_eps,
                                  min_pts=rd.dbscan_min_pts)))
        fused = clock("fuse_mutual_best", lambda: pc.fuse_mutual_best(
            *uv_world_boxes(rd, bv, u[0], fr.cam_pos[f], fr.rot), u[1], *db))
        return tracks, db, fused

    ms = {}

    def timing(stage, fn):
        out, t = timed(fn)
        ms[stage] = ms.get(stage, 0.0) + t
        return out

    launches = {}

    def counting(stage, fn):
        out = []
        launches[stage] = kernel_launches(lambda: out.append(fn()))
        return out[0]

    run_frame(0, tracks, lambda stage, fn: fn())     # warm-up, not timed
    for f in range(F):
        tracks, db, fused = run_frame(f, tracks, timing)
    run_frame(F - 1, tracks, counting)
    live = int(tracks.live.sum())
    check(bool(torch.isfinite(tracks.box).all())
          and bool(torch.isfinite(tracks.vel).all()), "bird tracks finite")

    params = yolo.random_params(0)
    # the seeded stand-in for the checkpoint, with the person class's
    # logit raised so the person branch has detections to fuse
    params["detect_head.cls_layers.conv5x5.4.bias"][yolo.PERSON_CLASS] += 3.0
    net = yolo.build_detector(yolo_state_dict(params), device=dev)
    gen = torch.Generator().manual_seed(0)
    img = torch.rand((S, 3, yolo.INPUT_SIZE, yolo.INPUT_SIZE),
                     generator=gen).to(dev)
    with torch.no_grad():
        preds = net(img)
        yolo_ms = cuda_time_ms(lambda: net(img), reps=10)
    check(tuple(preds.shape) == (S, 85, 22, 22)
          and bool(torch.isfinite(preds).all()), ("yolo preds", preds.shape))
    pos, size, fvalid = fused
    yolo.decode(preds, conf_thresh=YOLO_CONF)       # warm-ups, not timed
    pc.fuse_external_2d(intr, pos, size, fvalid, fr.cam_pos[-1], fr.rot,
                        *yolo.person_rects(yolo.decode(preds), rd.im_w,
                                           rd.im_h))
    det, decode_ms = timed(lambda: yolo.decode(preds, conf_thresh=YOLO_CONF))
    (rects, ok), rect_ms = timed(lambda: yolo.person_rects(det, rd.im_w,
                                                           rd.im_h))
    check(bool(det.valid.any()), "yolo: no valid detection")
    (dyn, human), ext_ms = timed(lambda: pc.fuse_external_2d(
        intr, pos, size, fvalid, fr.cam_pos[-1], fr.rot, rects, ok))
    peak = torch.cuda.max_memory_allocated() / 1e9
    return dict(
        scenarios=S, frames=F, max_tracks=BIRD_TRACKS,
        stage_ms_per_frame={k: v / F for k, v in ms.items()},
        stage_launches_one_frame=launches,
        live_bird_tracks=live,
        bird_track_age_max=int(tracks.age.max()),
        fused_boxes_last_frame=int(fvalid.sum()),
        dbscan_detections_last_frame=int(db[2].sum()),
        yolo_batch=list(img.shape), yolo_forward_ms=yolo_ms,
        yolo_decode_ms=decode_ms, person_rects_ms=rect_ms,
        yolo_conf_thresh=YOLO_CONF,
        yolo_valid_detections=int(det.valid.sum()),
        person_detections=int(ok.sum()),
        fuse_external_2d_ms=ext_ms, dynamic_flags=int(dyn.sum()),
        peak_memory_gb=peak)


def check_fusion_small(dev):
    """The perception-fusion stack on the card against the CPU on small
    inputs: the U-V branch and bird's-eye tracker over the small world's 6
    frames (capture.small_frames, depth from the CPU on both) with equal
    track tables and U-map boxes; fuse_mutual_best against the DBSCAN
    detections with equal flags and boxes; the YOLO network at (2, 3, 352,
    352) with seeded parameters within 1e-4 of the CPU (TF32 off, through
    resolve_device); decode of the CPU's predictions on both devices with
    equal valid flags and classes and boxes within 1e-6; fuse_external_2d
    flags equal."""
    import torch
    from intent_mpc_torch.benchmark.capture import small_frames
    from intent_mpc_torch.models import perception as pc
    from intent_mpc_torch.models import real_detector as rdet
    from intent_mpc_torch.models import yolo
    from intent_mpc_torch.models.clustering import dbscan
    from intent_mpc_torch.utils.config import RealDetectorConfig
    from intent_mpc_torch.utils.convert import yolo_state_dict
    from intent_mpc_torch.utils.device import resolve_device
    resolve_device(dev)
    fr = small_frames(device="cpu")
    rd = RealDetectorConfig()
    intr = rdet.intrinsics(rd)
    sd = yolo_state_dict(yolo.random_params(1))
    img = torch.rand((2, 3, yolo.INPUT_SIZE, yolo.INPUT_SIZE),
                     generator=torch.Generator().manual_seed(1))
    out = {}
    for where in (dev, "cpu"):
        tr = pc.init_bird_tracks(2, 4, where)
        umaps = []
        for f in range(fr.depth.shape[0]):
            u = pc.u_map_detect(intr, fr.depth[f].to(where), min_hits=4)
            bv = pc.bird_view_boxes(intr, *u)
            tr = pc.bird_track_step(tr, bv, u[1], 1.0 / 30.0)
            umaps += list(u)
            pts, valid = fr.pts[f].to(where), fr.valid[f].to(where)
            db = rdet.extract_detections(rd, pts, dbscan(
                pts, valid, eps=rd.dbscan_eps, min_pts=rd.dbscan_min_pts))
            fused = pc.fuse_mutual_best(
                *uv_world_boxes(rd, bv, u[0], fr.cam_pos[f].to(where),
                                fr.rot.to(where)), u[1], *db,
                iou_thresh=0.1)
        net = yolo.build_detector(sd, device=where)
        with torch.no_grad():
            preds = net(img.to(where))
        out[str(where)] = dict(tracks=[t.cpu() for t in tr],
                               umaps=[t.cpu() for t in umaps],
                               db=[t.cpu() for t in db],
                               fused=[t.cpu() for t in fused],
                               preds=preds.cpu())
    card, cpu = out[str(dev)], out["cpu"]
    tracks_equal = all(torch.equal(a, b)
                       for a, b in zip(card["tracks"], cpu["tracks"]))
    umap_equal = all(torch.equal(a, b)
                     for a, b in zip(card["umaps"], cpu["umaps"]))
    db_equal = all(torch.equal(a, b) for a, b in zip(card["db"], cpu["db"]))
    fused_equal = all(torch.equal(a, b)
                      for a, b in zip(card["fused"], cpu["fused"]))
    net_diff = float((card["preds"] - cpu["preds"]).abs().max())
    check(tracks_equal and umap_equal, "fusion_small: U-V tables differ")
    check(db_equal, "fusion_small: DBSCAN detections differ")
    check(fused_equal, "fusion_small: fused boxes or flags differ")
    check(net_diff <= 1e-4, ("fusion_small: yolo outputs", net_diff))
    dets = {}
    for where in (dev, "cpu"):
        d = yolo.decode(cpu["preds"].to(where), conf_thresh=0.12)
        r, _ = yolo.person_rects(d, rd.im_w, rd.im_h)
        c = torch.tensor([[[0.0, 0.0, 3.0], [1.0, 0.2, 4.0],
                           [-1.0, -0.3, 2.5]]] * 2, device=where)
        s = torch.full_like(c, 0.8)
        flags = pc.fuse_external_2d(intr, c, s, torch.ones(
            (2, 3), dtype=torch.bool, device=where), torch.zeros(
            (2, 3), device=where), torch.eye(3, device=where).expand(2, 3, 3),
            r, d.valid, iou_thresh=0.05)[0]
        dets[str(where)] = [t.cpu() for t in (d.valid, d.classes, d.boxes,
                                              flags)]
    dc, dp = dets[str(dev)], dets["cpu"]
    decode_equal = torch.equal(dc[0], dp[0]) and torch.equal(dc[1], dp[1]) \
        and torch.equal(dc[3], dp[3])
    box_diff = float((dc[2] - dp[2]).abs().max())
    check(decode_equal and box_diff <= 1e-6,
          ("fusion_small: decode or fuse_external_2d", box_diff))
    return dict(config="fusion_small", scenarios=2, frames=6,
                tracks_equal=tracks_equal, umap_equal=umap_equal,
                detections_equal=db_equal, fused_equal=fused_equal,
                fused_boxes=int(cpu["fused"][2].sum()),
                live_tracks=int(cpu["tracks"][3].sum()),
                yolo_max_abs_diff=net_diff, yolo_tol=1e-4,
                decode_equal=decode_equal, decode_box_max_diff=box_diff,
                decode_valid=int(dp[0].sum()),
                external_flags=int(dp[3].sum()))


# the exploration phase: DEP cycles, the RRT* of the routes, the wavefront
# maps and iterations, the dynamic obstacles' frames of the B-spline cost,
# the samples of each spline for the divider and TOPP
EXPLORE_CYCLES = 3
RRT_STAR = dict(max_iters=1024, incremental_dist=2.5, neighborhood_radius=3.0,
                goal_reach_dist=2.5)
WAVEFRONT_MAPS = 8
WAVEFRONT_ITERS = 200
OBSTACLE_FRAMES = 30
# TOPP's chord speeds may exceed the larger limit of their two samples by
# this factor (tests/test_traj_divider.py's margin)
CHORD_SPEED_TOL = 1.05
# the card-against-CPU checks: tests/test_dep.py's small map, and the
# DYNUS scenarios held at full width
DEP_SMALL_DIMS = (24, 16, 6)
FULL_CHECK_SCENARIOS = 2
SPLINE_SAMPLE_DT = 0.1
FAR = 1e4      # where a static obstacle is put out of the dynamic term


def route_bounds(start, goal):
    """The goal-mode RRT's sampling box of the routes start -> goal (S, 3):
    the real-perception config's margin beyond both, floored at its z."""
    import torch
    from intent_mpc_torch.benchmark.capture import real_dynus_config
    e = real_dynus_config().engine
    b_lo = torch.minimum(start, goal) - e.ref_bounds_margin
    b_lo[:, 2] = torch.clamp(b_lo[:, 2], min=e.ref_z_min)
    return b_lo, torch.maximum(start, goal) + e.ref_bounds_margin


def dep_stage_sites():
    """dep_step's stages for StageTimer: sampling (frontier and free-voxel
    draws, spacing, insertion), prune, gains (the windowed per-yaw
    counts), bellman_ford (adjacency with line-of-sight edges and the
    relaxations) and scoring (candidates, path walks, findBestPath)."""
    from intent_mpc_torch.models import dep
    return [("sampling", dep, "grow_roadmap"), ("prune", dep, "prune"),
            ("gains", dep, "node_gains"),
            ("bellman_ford", dep, "roadmap_paths"),
            ("scoring", dep, "score_views")]


def chord_speeds_within(path, res, vlim):
    """TOPP's per-axis limits held on its samples as tests/
    test_traj_divider.py holds them: each chord's per-axis velocity within
    CHORD_SPEED_TOL x the larger of its two samples' limits, plus 1e-3.
    Returns (all held, the largest ratio of a chord's velocity to that
    limit)."""
    import torch
    dt = torch.diff(res.times, dim=1)
    vel = torch.abs(torch.diff(path, dim=1)) \
        / torch.clamp(dt, min=1e-9)[..., None]
    lim = torch.maximum(vlim[:, :-1], vlim[:, 1:])[..., None]
    ok = bool((vel <= lim * CHORD_SPEED_TOL + 1e-3).all())
    return ok, float((vel / lim).max())


def check_exploration(seeds, fr, m, g, dev):
    """The exploration and trajectory-optimisation stack at the DYNUS width
    on the mapping phase's S maps (log-odds m, inflated grids g), from
    each scenario's last camera position: EXPLORE_CYCLES dep_step cycles
    at DEPConfig() (device ms per stage, live nodes, successes, launches of
    one more cycle), plan_next_view at ExplorationConfig() and
    PRMConfig(), RRT* (RRT_STAR) and the PRM on the inflated grids to 20 m
    ahead (successes, launches, their CUDA-event interval: the host's
    launch time of eager loops), the grid wavefront on WAVEFRONT_MAPS grids
    toward the voxel 20 m ahead (integer costs and 1e9), the ESDF of every
    inflated grid, the B-spline optimiser from each RRT* path (100 Adam
    steps with the ESDF and the dynamic obstacles of the last
    OBSTACLE_FRAMES frames), each spline sampled every SPLINE_SAMPLE_DT s,
    divided against the inflated grid and time-parameterized at the
    planner's max_vel and max_acc (sampled speeds within the limits); peak
    memory. Returns (the phase's fields, the last roadmap and the inputs
    the full-width card-against-CPU check reuses)."""
    import torch
    from intent_mpc_torch.models import bspline_traj as bs
    from intent_mpc_torch.models import dep
    from intent_mpc_torch.models import exploration as ex
    from intent_mpc_torch.models import global_planner as gp
    from intent_mpc_torch.models import mapping as mp
    from intent_mpc_torch.models import time_optimizer as to
    from intent_mpc_torch.models import traj_divider as td
    from intent_mpc_torch.utils import prng
    from intent_mpc_torch.utils.config import PlannerConfig
    S = len(seeds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lo, origin, res = m.log_odds, m.origin, m.resolution
    start = fr.cam_pos[-1]
    yaw = torch.zeros((S,), device=dev)
    keys = prng.prng_key(torch.tensor([2000 + int(s) for s in seeds]), dev)
    cfg = dep.DEPConfig()

    # ---- DEP: the persistent roadmap over EXPLORE_CYCLES cycles ----
    st = dep.dep_init(cfg, start, device=dev)
    cycle_ms = []
    with StageTimer(dep_stage_sites()) as timer:
        for c in range(EXPLORE_CYCLES):
            (st, plan), ms = timed(lambda st=st, c=c: dep.dep_step(
                cfg, lo, origin, res, st, start, yaw, prng.fold_in(keys, c)))
            cycle_ms.append(ms)
    stage_ms = {k: v / EXPLORE_CYCLES for k, v in timer.ms().items()}
    dep_launches = kernel_launches(lambda: dep.dep_step(
        cfg, lo, origin, res, st, start, yaw,
        prng.fold_in(keys, EXPLORE_CYCLES)))
    check(bool(torch.isfinite(plan.path).all())
          and bool(torch.isfinite(st.gain).all()), "exploration: DEP plan")
    live = st.valid.sum(dim=-1)

    # ---- the next-best view and its PRM path ----
    goal = start + torch.tensor([20.0, 0.0, 0.0], device=dev)
    b_lo, b_hi = route_bounds(start, goal)
    view, view_ms = timed(lambda: ex.plan_next_view(
        lo, origin, res, start, b_lo, b_hi, keys))
    check(bool(torch.isfinite(view.path).all()), "exploration: view path")

    # ---- RRT* and PRM on the inflated grids ----
    star_cfg = gp.RRTStarConfig(**RRT_STAR)
    star, star_ms = timed(lambda: gp.rrt_star_plan(g, start, goal, b_lo, b_hi,
                                                   keys, star_cfg))
    star_launches = kernel_launches(lambda: gp.rrt_star_plan(
        g, start, goal, b_lo, b_hi, keys, star_cfg))
    prm, prm_ms = timed(lambda: gp.prm_plan(g, start, goal, b_lo, b_hi, keys))
    prm_launches = kernel_launches(lambda: gp.prm_plan(
        g, start, goal, b_lo, b_hi, keys))
    check(bool(torch.isfinite(star.path).all())
          and bool(torch.isfinite(prm.path).all()), "exploration: routes")

    # ---- the grid wavefront toward the voxel 20 m ahead ----
    W = min(WAVEFRONT_MAPS, S)
    dims = torch.tensor(lo.shape[1:], device=dev)
    gv = torch.clamp(torch.floor((goal[:W] - origin) / g.resolution).long(),
                     torch.zeros_like(dims), dims - 1)
    cost, wave_ms = timed(lambda: gp.grid_wavefront(g.grid[:W], gv,
                                                    WAVEFRONT_ITERS))
    ar = torch.arange(W, device=dev)
    check(bool(((cost == 1e9) | ((cost == torch.round(cost))
                                & (cost <= WAVEFRONT_ITERS))).all())
          and bool((cost[ar, gv[:, 0], gv[:, 1], gv[:, 2]] == 0).all()),
          "exploration: wavefront costs are not integers and 1e9")
    sv = torch.floor((start[:W] - origin) / g.resolution).long()
    start_cost = cost[ar, sv[:, 0], sv[:, 1], sv[:, 2]]

    # ---- the B-spline optimiser from each RRT* path ----
    esdf, esdf_ms = timed(lambda: mp.esdf(g.grid, res))
    ctrl0 = bs.fit_control_points(star.path)
    obs = fr.obs_pos[-OBSTACLE_FRAMES:].permute(1, 2, 0, 3)      # (S, O, P, 3)
    obs = torch.where(fr.dynamic[:, :, None, None], obs,
                      torch.full_like(obs, FAR))
    size = fr.obs_size[:, :, None].expand(obs.shape).contiguous()
    bcfg = bs.BsplineConfig()
    traj, bs_ms = timed(lambda: bs.optimize(bcfg, ctrl0, esdf, origin, res,
                                            obs, size))
    bs_launches = kernel_launches(lambda: bs.optimize(
        bcfg, ctrl0, esdf, origin, res, obs, size))
    check(bool(torch.isfinite(traj.ctrl).all())
          and torch.equal(traj.ctrl[:, :3], ctrl0[:, :3])
          and torch.equal(traj.ctrl[:, -3:], ctrl0[:, -3:]),
          "exploration: B-spline control points or pinned ends")

    # ---- the divider and TOPP on the splines' samples ----
    M = traj.ctrl.shape[1]
    n_t = int(round((M - 3) * bcfg.dt / SPLINE_SAMPLE_DT)) + 1
    t = (torch.arange(n_t, device=dev) * SPLINE_SAMPLE_DT).expand(S, n_t)
    t = t.contiguous()
    path = bs.evaluate(traj, t)
    params = td.DividerParams()
    div, div_ms = timed(lambda: td.divide(path, t, g, params))
    pc = PlannerConfig()
    vlim = td.zone_velocity_limits(div, pc.max_vel, params.safe_dist)
    topp, topp_ms = timed(lambda: to.parameterize(path, vlim, pc.max_acc))
    topp_launches = kernel_launches(lambda: to.parameterize(path, vlim,
                                                            pc.max_acc))
    held, ratio = chord_speeds_within(path, topp, vlim)
    check(held and bool(torch.isfinite(topp.times).all()),
          ("exploration: TOPP speeds beyond the limits", ratio))
    pos_s, vel_s = to.sample_state(path, topp, topp.total_time * 0.5)
    check(bool(torch.isfinite(pos_s).all() and torch.isfinite(vel_s).all()),
          "exploration: sampled state")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 40.0, ("exploration peak memory", peak))
    out = dict(
        scenarios=S, map_dims=list(lo.shape[1:]), resolution=res,
        dep_cycles=EXPLORE_CYCLES, dep_ms_each=[round(x, 3) for x in cycle_ms],
        dep_ms_per_cycle=sum(cycle_ms) / EXPLORE_CYCLES,
        dep_stage_ms_per_cycle=stage_ms, dep_launches_one_cycle=dep_launches,
        dep_live_nodes_mean=float(live.float().mean()),
        dep_live_nodes_max=int(live.max()),
        dep_successes=int(plan.success.sum()),
        dep_path_len_mean=float(plan.path_len.float().mean()),
        view_ms=view_ms, view_successes=int(view.success.sum()),
        view_gain_mean=float(view.gain.mean()),
        rrt_star_launch_bound_ms=star_ms, rrt_star_launches=star_launches,
        rrt_star_successes=int(star.success.sum()),
        rrt_star_iters=star_cfg.max_iters,
        prm_launch_bound_ms=prm_ms, prm_launches=prm_launches,
        prm_successes=int(prm.success.sum()),
        wavefront_maps=W, wavefront_iters=WAVEFRONT_ITERS,
        wavefront_ms=wave_ms,
        wavefront_reached_voxels=int((cost < 1e9).sum()),
        wavefront_start_cost=[float(x) for x in start_cost],
        esdf_ms=esdf_ms, esdf_maps=S,
        bspline_ms=bs_ms, bspline_launches=bs_launches,
        bspline_iters=bcfg.iters,
        bspline_cost_mean=float(traj.cost.mean()),
        spline_samples=n_t, divider_ms=div_ms,
        zones=int(div.zone_valid.sum()),
        samples_in_zones=int(div.in_zone.sum()),
        topp_ms=topp_ms, topp_launches=topp_launches,
        total_time_s=[round(float(x), 4) for x in topp.total_time],
        chord_speed_over_limit_max=ratio,
        peak_memory_gb=peak)
    return out, dict(state=st, start=start, yaw=yaw, keys=keys, path=path,
                     vlim=vlim)


def _dep_small_map(wall=False):
    """tests/test_dep.py's half-explored map at 0.5 m: x below half
    observed free, the rest unobserved; with `wall` an occupied slab at
    x in [4.5, 5.5) m."""
    import torch
    lo = torch.zeros(DEP_SMALL_DIMS)
    lo[: DEP_SMALL_DIMS[0] // 2] = -2.0
    if wall:
        lo[9:11, 2:12, :4] = 3.0
    return lo


def _small_cfg(**kw):
    """tests/test_dep.py's small DEPConfig."""
    from intent_mpc_torch.models import dep
    base = dict(capacity=48, samples_per_step=12, dist_thresh=0.6,
                sensor_range=3.0, connect_radius=3.0, max_path_len=10,
                max_candidates=4, yaw_bins=16)
    base.update(kw)
    return dep.DEPConfig(**base)


def exploration_small(where):
    """The exploration stack on small inputs on one device: 4 dep_step
    cycles of two explorers on the half-explored map and one with
    los_samples=3 on it with a wall; plan_next_view on
    tests/test_exploration.py's half-observed map; RRT* (128 iterations,
    step 1.5) and the PRM on tests/test_global_planner.py's walled map
    (0.25 m) for three keys; the grid wavefront there; 30 B-spline Adam
    steps from seeded paths with an ESDF and a dynamic obstacle; the
    divider and TOPP on a pass by a pillar (0.1 m). Returns {name: (exact
    tensors, tensors held absolutely, tensors held relatively)} on the
    CPU."""
    import numpy as np
    import torch
    from intent_mpc_torch.models import bspline_traj as bs
    from intent_mpc_torch.models import dep
    from intent_mpc_torch.models import exploration as ex
    from intent_mpc_torch.models import global_planner as gp
    from intent_mpc_torch.models import mapping as mp
    from intent_mpc_torch.models import time_optimizer as to
    from intent_mpc_torch.models import traj_divider as td
    from intent_mpc_torch.models.occupancy import build_from_static_obstacles
    from intent_mpc_torch.utils import prng
    out = {}

    def cpu(ts):
        return [t.detach().cpu() for t in ts]

    start = torch.tensor([[1.0, 4.0, 1.5], [2.0, 6.0, 1.0]], device=where)
    keys = prng.prng_key(torch.tensor([0, 5]), where)
    for name, cfg, wall, cycles in (("dep", _small_cfg(), False, 4),
                                    ("dep_los", _small_cfg(los_samples=3),
                                     True, 1)):
        lo = _dep_small_map(wall)[None].expand(2, -1, -1, -1).to(where)
        st = dep.dep_init(cfg, start, device=where)
        for c in range(cycles):
            st, plan = dep.dep_step(cfg, lo, (0.0, 0.0, 0.0), 0.5, st, start,
                                    torch.zeros(2, device=where),
                                    prng.fold_in(keys, c))
        out[name] = (cpu([st.valid, st.gain, st.yaw_gain, plan.path_len,
                          plan.success]),
                     cpu([st.pos, plan.path, plan.viewpoint]),
                     cpu([plan.score]))

    lo = torch.zeros((2, 24, 24, 8), device=where)
    lo[:, :12] = -1.0
    view = ex.plan_next_view(
        lo, (0.0, 0.0, 0.0), 0.5, torch.tensor([[1.0, 6.0, 2.0]] * 2,
                                               device=where),
        torch.tensor([[0.5] * 3] * 2, device=where),
        torch.tensor([[11.5, 11.5, 3.5]] * 2, device=where), keys,
        ex.ExplorationConfig(sensor_range=2.0, num_candidates=256))
    out["view"] = (cpu([view.path_len, view.success, view.gain]),
                   cpu([view.viewpoint, view.path]), [])

    g = build_from_static_obstacles(
        (0, 0, 0), (10, 10, 3), 0.25, [[5.0, 3.5, 1.5]], [[0.5, 7.0, 3.0]],
        [0.2, 0.2, 0.2], device=where)
    rows = lambda v: torch.tensor([v] * 3, device=where)   # noqa: E731
    args = (g, rows([1.0, 2.0, 1.5]), rows([9.0, 2.0, 1.5]),
            rows([0.3, 0.3, 0.5]), rows([9.7, 9.7, 2.5]),
            prng.prng_key(torch.tensor([0, 1, 3]), where))
    for name, r in (("rrt_star", gp.rrt_star_plan(*args, gp.RRTStarConfig(
            max_iters=128, incremental_dist=1.5, neighborhood_radius=2.5,
            goal_reach_dist=1.0))), ("prm", gp.prm_plan(*args))):
        out[name] = (cpu([r.length, r.success]), cpu([r.path]), [])
    goal_vox = torch.tensor([[36, 8, 6]] * 2, device=where)
    out["wavefront"] = (cpu([gp.grid_wavefront(
        g.grid[None].expand(2, -1, -1, -1), goal_vox, 120)]), [], [])

    rng = np.random.default_rng(0)
    xs = np.linspace(0, 8, 20)
    base = np.stack([xs, np.full(20, 0.1), np.full(20, 1.5)], -1)
    paths = torch.tensor(np.stack([base + rng.normal(0, 0.3, base.shape)
                                   for _ in range(2)]), dtype=torch.float32,
                         device=where)
    ctrl0 = bs.fit_control_points(paths)
    P = ctrl0.shape[1]
    gb = build_from_static_obstacles(
        (-1, -3, 0), (10, 6, 3), 0.2, [[4.0, 0.0, 1.5]], [[1.0, 1.0, 3.0]],
        [0.2, 0.2, 0.2], device=where)
    esdf = mp.esdf(gb.grid[None].expand(2, -1, -1, -1), 0.2)
    obs = torch.tensor([4.0, 0.0, 1.5], device=where).expand(2, 1, P, 3)
    traj = bs.optimize(bs.BsplineConfig(iters=30, clearance=0.6), ctrl0,
                       esdf, (-1.0, -3.0, 0.0), 0.2, obs,
                       torch.ones_like(obs))
    out["bspline"] = ([], cpu([traj.ctrl]), cpu([traj.cost]))

    ts = torch.linspace(0.0, 6.0, 120, device=where)
    traj = torch.stack([ts * 2.0, torch.zeros_like(ts), torch.ones_like(ts)],
                       dim=-1)
    gp_ = build_from_static_obstacles(
        (-1.0, -4.0, 0.0), (14.0, 8.0, 4.0), 0.1, [[6.0, 0.6, 1.0]],
        [[0.4, 0.4, 3.0]], 0.3, device=where)
    div = td.divide(traj[None], ts[None], gp_)
    vlim = td.zone_velocity_limits(div, 5.0, 1.0)
    topp = to.parameterize(traj[None], vlim, 10.0)
    out["divider_topp"] = (cpu([div.in_zone, div.zone_valid]),
                           cpu([div.t_lo, div.t_hi]),
                           cpu([topp.b, topp.times]))
    return out


def check_exploration_small(dev):
    """exploration_small on the card against the CPU: masks, counts,
    lengths and successes equal; positions, paths, B-spline control points
    and zone times within 1e-5 (m, s; DEP node positions 1e-6 m); scores,
    B-spline costs and TOPP's b and times within 1e-5 relative."""
    import torch
    card, cpu = exploration_small(dev), exploration_small("cpu")

    def worst(xs, ys, rel):
        """The largest difference, NaN if any is NaN; equal values
        (infinite scores of no view included) differ by 0."""
        return nan_max(float(torch.where(a == b, 0.0, (a - b).abs() / (
            b.abs().clamp(min=1e-6) if rel else 1.0)).max())
            for a, b in zip(xs, ys))
    equal, diffs, rel_diffs = True, {}, {}
    for name in cpu:
        (ec, ac, rc), (ep, ap, rp) = card[name], cpu[name]
        equal = equal and all(torch.equal(a, b) for a, b in zip(ec, ep))
        diffs[name] = worst(ac, ap, False)
        rel_diffs[name] = worst(rc, rp, True)
    check(equal, "exploration_small: masks, counts or lengths differ")
    pos_diff = float((card["dep"][1][0] - cpu["dep"][1][0]).abs().max())
    check(pos_diff <= 1e-6 and all(v <= 1e-5 for v in diffs.values())
          and all(v <= 1e-5 for v in rel_diffs.values()),
          ("exploration_small: card against CPU", pos_diff, diffs,
           rel_diffs))
    return dict(config="exploration_small", exact_equal=equal,
                max_abs_diff=diffs, max_rel_diff=rel_diffs, tol=1e-5,
                dep_pos_tol=1e-6)


def check_exploration_full(ctx, m, dev):
    """The full-width DYNUS maps of the first FULL_CHECK_SCENARIOS
    scenarios on the card against the CPU: one dep_step from the phase's
    last roadmap (node positions within 1e-6 m, valid, gains and per-yaw
    gains equal) and one TOPP on the phase's spline samples (b and times
    within 1e-5 relative)."""
    import torch
    from intent_mpc_torch.models import dep
    from intent_mpc_torch.models import time_optimizer as to
    from intent_mpc_torch.utils import prng
    from intent_mpc_torch.utils.config import PlannerConfig
    n = FULL_CHECK_SCENARIOS
    cfg = dep.DEPConfig()
    key = prng.fold_in(ctx["keys"][:n], EXPLORE_CYCLES + 1)
    runs = {}
    for where in (dev, "cpu"):
        st = dep.RoadmapState(*(t[:n].to(where) for t in ctx["state"]))
        t0 = time.perf_counter()
        st2, plan = dep.dep_step(cfg, m.log_odds[:n].to(where),
                                 m.origin.to(where), m.resolution, st,
                                 ctx["start"][:n].to(where),
                                 ctx["yaw"][:n].to(where), key.to(where))
        topp = to.parameterize(ctx["path"][:n].to(where),
                               ctx["vlim"][:n].to(where),
                               PlannerConfig().max_acc)
        runs[str(where)] = ([t.cpu() for t in st2] + [plan.success.cpu()],
                            [topp.b.cpu(), topp.times.cpu()],
                            time.perf_counter() - t0)
    (c_st, c_tp, c_s), (p_st, p_tp, p_s) = runs[str(dev)], runs["cpu"]
    pos_diff = float((c_st[0] - p_st[0]).abs().max())
    counts_equal = all(torch.equal(a, b) for a, b in zip(c_st[1:], p_st[1:]))
    rel = nan_max(float(torch.where(a == b, 0.0, (a - b).abs()
                                    / b.abs().clamp(min=1e-6)).max())
                  for a, b in zip(c_tp, p_tp))
    check(counts_equal and pos_diff <= 1e-6,
          ("exploration_full: DEP card against CPU", pos_diff))
    check(rel <= 1e-5, ("exploration_full: TOPP card against CPU", rel))
    return dict(config="exploration_full", scenarios=n,
                dep_counts_equal=counts_equal, dep_pos_max_diff=pos_diff,
                gains_sum=float(p_st[2].sum()), topp_rel_diff=rel,
                tol_rel=1e-5, cpu_s=p_s, card_s=c_s)


# ---- the port's tools (phase 28) ----
SUMMARY_KEYS = HARNESS_KEYS[4:] + ["traj_collision_cycles", "stop_replans"]
ORACLE_SEEDS = (0, 1)
ORACLE_CYCLES = 5
# Oracle loop, card against CPU. Cycle 0 has no obstacle rows (a feasible
# QP the oracle converges on): 1e-4 m. Later cycles: the infeasible DYNUS
# QPs make the 150-iteration f64 oracle amplify its inputs' rounding: a
# relative 2^-24 nudge of A, l, u and q parts the positions by up to
# 0.233 m within 5 cycles (`python -m intent_mpc_torch.benchmark.
# sensitivity --oracle --device cpu`, 4 seeded nudges), so 1.0 m.
ORACLE_TOL_FIRST = 1e-4
ORACLE_TOL = 1.0
DEMO_TIMEOUT = 2.0


# the TPU-tuned solver options (ROADMAP queue 1 item 6) as SolverConfig
# fields; the phase runs each on the production config and on the small
# one, card against CPU
KNOBS = (("woodbury_candidates", dict(woodbury_candidates=True)),
         ("block_refine", dict(block_refine=True)),
         ("folded_refine", dict(folded_refine=True)),
         ("minv_bf16", dict(minv_dtype="bf16")),
         ("warm_frac", dict(shared_refine_warm_frac=0.5)))
# card against CPU on the small config (m): 1e-4 as the other options; the
# Woodbury x-update has no refinement step, so each device's float32
# factor rounding reaches x directly (tests/test_torch_solver_knobs.py,
# JAX against the port: 3.0e-4), and the bf16 preconditioner makes the
# iteration unstable (the JAX package's measured negative)
KNOB_TOL = {"woodbury_candidates": 1e-3, "block_refine": 1e-4,
            "folded_refine": 1e-4, "minv_bf16": 1e-3, "warm_frac": 1e-4}


def check_solver_knobs(cfg, S, cycles, dev):
    """Each TPU-tuned solver option on cfg's default path from a fresh
    carry (run_path): ms per cycle, the exact kernel launches
    (expected_launches: ew_chain 100 per cycle under block, folded and
    bf16, 0 under Woodbury and the two phases), rejected solves and the
    primal residual (mean and largest of the executed candidates). The
    bf16 factor's residuals may be non-finite (its measured negative);
    the others keep every metric finite."""
    lines = []
    for name, kw in KNOBS:
        c = with_solver(cfg, **kw)
        out, carry, _, _ = run_path(c, S, cycles, dev)
        check(name == "minv_bf16" or not out["non_finite_metrics"],
              (name, out["non_finite_metrics"]))
        exp = expected_launches(c, cycles)
        check(out["launches"] == exp, (name, "launches", out["launches"],
                                       exp))
        m = carry.metrics
        out.update(
            option=name, ew_chain_launches=out["launches"]["ew_chain"],
            launches_per_cycle={k: v / cycles
                                for k, v in out["launches"].items()},
            rejected_solves=int((m.solve_attempts
                                 - m.solve_successes).sum()),
            prim_res_mean=float(m.prim_res_sum.sum()
                                / m.solve_attempts.sum()),
            prim_res_max=float(m.prim_res_max.max()),
            fac_minv_dtype=str(carry.planner.fac_minv.dtype))
        lines.append(out)
    return lines


def check_knobs_small(dev):
    """Each solver option on the small config for 4 cycles of 2
    scenarios, card against CPU: positions within KNOB_TOL, equal solve
    counts, finite carries."""
    import torch
    from intent_mpc_torch.benchmark.capture import run_loop
    from intent_mpc_torch.entry import tiny_config
    lines = []
    for name, kw in KNOBS:
        c = with_solver(tiny_config(), **kw)
        cc, _, pg = run_loop(c, 2, 4, dev)
        cc_cpu, _, pc = run_loop(c, 2, 4, "cpu")
        diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
        check(nan_max(diffs) <= KNOB_TOL[name], (name, diffs))
        check(finite_carry(cc) and finite_carry(cc_cpu), "non-finite carry")
        check(torch.equal(cc.metrics.solve_successes.cpu(),
                          cc_cpu.metrics.solve_successes),
              ("solve counts differ", name))
        lines.append(dict(config="small", solve=name, scenarios=2, cycles=4,
                          max_pos_diff_per_cycle=diffs, held_cycles=4,
                          tol=KNOB_TOL[name]))
    return lines


def check_fleet(cfg, S, cycles, fleet):
    """The fleet's main path at world size fleet.world: batch_rollout with
    the mesh on the default and the fused path, S scenarios, `cycles`
    cycles, against the one-device batch_rollout of the same seeds in
    this process (per-scenario metrics and the aggregate bit-equal), the
    kernel launches of the fleet run (expected_launches), and the
    collective inventory of the same program over 2 cycles: exactly two
    all-reduces, 32 bytes."""
    import time
    import torch
    import torch.distributed as dist
    from intent_mpc_torch.benchmark.capture import fused
    from intent_mpc_torch.models.world import straight_line_ref_traj
    from intent_mpc_torch.parallel import sharding as sh
    dev = fleet.device
    lines = []
    for solve, c in (("default", cfg), ("fused", fused(cfg))):
        scen = sh.stack_scenarios_global(c, range(S), fleet)
        ref = straight_line_ref_traj(c.start, c.goal, spacing=2.5,
                                     device=dev)
        L = ref.shape[0]
        sh.batch_rollout(c, scen, ref, L, num_cycles=1, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        m, agg = sh.batch_rollout(c, scen, ref, L, mesh=fleet,
                                  num_cycles=cycles)
        secs = time.perf_counter() - t0
        launches = launch_counts()
        check(launches == expected_launches(c, cycles),
              ("fleet launches", solve, launches))
        m1, agg1 = sh.batch_rollout(c, scen, ref, L, num_cycles=cycles,
                                    device=dev)
        same = [f for f, a, b in zip(m._fields, m, m1)
                if not torch.equal(a, b)]
        check(not same and agg == agg1, ("fleet differs from the one-device"
                                         " rollout", solve, same, agg, agg1))
        _, rep = sh.collective_report(c, scen, ref, L, fleet, num_cycles=2)
        check(rep["counts"] == {"all-reduce": 2}
              and rep["total_bytes"] == 32, ("fleet inventory", rep))
        lines.append(dict(
            solve=solve, scenarios=S, cycles=cycles, world=fleet.world,
            backend=dist.get_backend(), device=str(dev), launches=launches,
            cycle_ms=secs / cycles * 1e3, bit_equal=True, aggregate=agg,
            collectives=rep["counts"], collective_bytes=rep["total_bytes"],
            collective_ops=rep["ops"]))
    return lines


def check_entry(dev):
    """entry()'s cycle on the card against entry("cpu"), held to 1e-4 m
    and m/s; exactly SOLVER_ITERS ew_chain launches."""
    import torch
    from intent_mpc_torch.entry import SOLVER_ITERS, entry
    fn, args = entry()
    reset_launch_counts()
    pos, vel = fn(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == {"ew_chain": SOLVER_ITERS, "fleet_admm": 0,
                     "dense_loop": 0}, ("entry launches", counts))
    fn_c, args_c = entry("cpu")
    pos_c, vel_c = fn_c(*args_c)
    dp = float((pos.cpu() - pos_c).abs().max())
    dv = float((vel.cpu() - vel_c).abs().max())
    check(dp <= 1e-4 and dv <= 1e-4, ("entry: card against CPU", dp, dv))
    return dict(fn="entry", scenarios=1, solver_iters=SOLVER_ITERS,
                launches=counts, pos_max_diff=dp, vel_max_diff=dv, tol=1e-4)


def check_stage_profile(dev):
    """benchmark/stage_profile at 32 scenarios of the production config,
    5 reps: every stage finite with positive wall ms, busy ms and
    launches."""
    from intent_mpc_torch.benchmark.stage_profile import profile_stages
    from intent_mpc_torch.utils.config import IntentMPCConfig
    reset_launch_counts()
    t0 = time.perf_counter()
    r = profile_stages(IntentMPCConfig(), 32, None, 5, dev)
    r["seconds"] = time.perf_counter() - t0
    r["launches"] = launch_counts()
    *timed, refine = r["stages"]
    for st in timed:
        check(math.isfinite(st["wall_ms"]) and st["wall_ms"] > 0
              and st["busy_ms"] > 0 and st["launches"] > 0,
              ("stage_profile", st))
    check(math.isfinite(refine["wall_ms"]), ("stage_profile", refine))
    return r


def check_roofline(cfg, loop, dev):
    """benchmark/roofline at 128 and 32 scenarios against phase 4's cycle
    times: no stated share above 1."""
    from intent_mpc_torch.benchmark import roofline
    out = []
    for S in (128, 32):
        reset_launch_counts()
        r = roofline.analyze(cfg, S, cfg.planner.solver.max_iter,
                             loop[S]["cycle_ms"] / 1e3, dev)
        r["launches"] = launch_counts()
        shares = [r[k] for k in ("apply_hbm_share", "fp32_share",
                                 "hbm_share") if r[k] is not None]
        check(math.isfinite(r["apply_us"]) and r["apply_us"] > 0
              and all(0 < x <= 1 for x in shares), ("roofline", r))
        out.append(r)
    return out


def check_oracle(dev):
    """The oracle loop (benchmark/oracle_loop: the CLI's config, 32 QP
    slots) for ORACLE_CYCLES cycles of ORACLE_SEEDS on the card and on the
    CPU: no kernel launches on the card, the host round trip's ms per
    cycle (timed after a synchronize), positions held to ORACLE_TOL_FIRST
    at cycle 0 and ORACLE_TOL after, equal solve counts."""
    import torch
    from intent_mpc_torch.benchmark import oracle_loop as ol
    from intent_mpc_torch.engine import closed_loop as cl
    from intent_mpc_torch.models.occupancy import empty_grid
    from intent_mpc_torch.models.world import straight_line_ref_traj
    from intent_mpc_torch.parallel import sharding as sh
    cfg = ol.build_cfg(ol.parse_args([]))

    def fly(where):
        scen = sh.stack_scenarios(cfg, list(ORACLE_SEEDS), device=where)
        ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device=where)
        occ = empty_grid(where)
        over = ol.make_oracle_override(cfg.planner)
        host_ms = []

        def timed(qps, warm6):
            if qps.q.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = over(qps, warm6)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            return res
        carry = cl.init_carry(cfg, scen, device=where)
        pos = []
        for i in range(ORACLE_CYCLES):
            carry, p = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                       carry, i, solve_override=timed)
            pos.append(p.cpu())
        return carry, pos, host_ms

    reset_launch_counts()
    t0 = time.perf_counter()
    cg, pg, host_ms = fly(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    check(not any(counts.values()), ("oracle cycles launched a kernel",
                                     counts))
    t0 = time.perf_counter()
    cc, pc, _ = fly("cpu")
    cpu_s = time.perf_counter() - t0
    diffs = [float((a - b).abs().max()) for a, b in zip(pg, pc)]
    check(diffs[0] <= ORACLE_TOL_FIRST and nan_max(diffs[1:]) <= ORACLE_TOL,
          ("oracle loop: card against CPU", diffs))
    check(finite_carry(cg) and finite_carry(cc), "oracle: non-finite carry")
    for f in ("solve_attempts", "solve_successes"):
        check(torch.equal(getattr(cg.metrics, f).cpu(),
                          getattr(cc.metrics, f)), ("oracle: differ", f))
    return dict(config="oracle_loop", scenarios=len(ORACLE_SEEDS),
                cycles=ORACLE_CYCLES, max_obstacles=cfg.planner.max_obstacles,
                launches=counts, host_ms_per_cycle=host_ms,
                card_s=card_s, cpu_s=cpu_s, max_pos_diff_per_cycle=diffs,
                tol_first=ORACLE_TOL_FIRST, tol=ORACLE_TOL,
                solve_successes=cg.metrics.solve_successes.cpu().tolist())


def check_demo(dev):
    """benchmark/demo.run_demo(seed=0) on the production DYNUS world for
    DEMO_TIMEOUT s: summarize's keys, finite values, a finite (C, 3) path,
    and the default path's launches."""
    import torch
    from intent_mpc_torch.benchmark.demo import run_demo
    reset_launch_counts()
    t0 = time.perf_counter()
    d = run_demo(seed=0, timeout=DEMO_TIMEOUT, device=dev,
                 out=os.path.join(HERE, "build", "chip_smoke", "demo"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    cycles = d.cfg.engine.num_cycles
    check(counts == expected_launches(d.cfg, cycles), ("demo launches",
                                                       counts))
    check(list(d.row) == SUMMARY_KEYS, ("demo row keys", list(d.row)))
    check(all(math.isfinite(float(v)) for v in d.row.values()),
          ("demo row", d.row))
    check(tuple(d.path.shape) == (cycles, 3)
          and bool(torch.isfinite(d.path).all()), "demo path")
    return dict(seed=0, cycles=cycles, launches=counts, seconds=seconds,
                ms_per_cycle=seconds / cycles * 1e3, row=d.row)


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
        check(nan_max(diffs[:held]) <= 1e-3, (name, diffs))
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
    check(nan_max(diffs) <= 1e-3, ("fused small", diffs))
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
        lat = bench.latency(32, cycles=20, fused=f, device=dev)
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
        check(nan_max(diffs) <= 1e-4, (name, diffs))
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

    # ---- 24-25. mapping and perception fusion at the DYNUS width: S = 32
    # scenarios on 60 camera frames; card against CPU on the small world;
    # none of the three kernels runs here ----
    t_map = time.perf_counter()
    from intent_mpc_torch.benchmark.capture import dynus_frames
    reset_launch_counts()
    map_seeds = list(range(32))
    frames = dynus_frames(map_seeds, 60, dev)
    mapping, maps, grids = check_mapping(map_seeds, frames, dev)
    phase("mapping", nvidia_smi=smi, **mapping)
    phase("card_vs_cpu", **check_mapping_small(dev))
    fusion = check_perception_fusion(frames, dev)
    phase("perception_fusion", nvidia_smi=smi, **fusion)
    phase("card_vs_cpu", **check_fusion_small(dev))
    map_launches = launch_counts()
    check(not any(map_launches.values()),
          ("mapping phases launched a kernel", map_launches))
    phase("mapping_phases", seconds=time.perf_counter() - t_map,
          launches=map_launches)

    # ---- 26. exploration and trajectory optimisation on the mapping
    # phase's 32 maps; card against CPU on small inputs and at full width
    # for 2 scenarios; none of the three kernels runs here ----
    t_exp = time.perf_counter()
    reset_launch_counts()
    explore, ctx = check_exploration(map_seeds, frames, maps, grids, dev)
    exp_launches = launch_counts()
    check(not any(exp_launches.values()),
          ("exploration phase launched a kernel", exp_launches))
    phase("exploration", nvidia_smi=smi, launches=exp_launches, **explore)
    phase("card_vs_cpu", **check_exploration_small(dev))
    phase("card_vs_cpu", **check_exploration_full(ctx, maps, dev))
    phase("exploration_phases", seconds=time.perf_counter() - t_exp,
          launches=exp_launches)
    del ctx, maps, grids, frames
    torch.cuda.empty_cache()

    # ---- 28. the port's tools: the entry, the stage profile and the
    # roofline, the f64 oracle in the loop, the demo ----
    t_tools = time.perf_counter()
    tools = {}
    for name, fn in (("entry", lambda: check_entry(dev)),
                     ("stage_profile", lambda: check_stage_profile(dev)),
                     ("roofline", lambda: check_roofline(cfg, loop, dev)),
                     ("oracle", lambda: check_oracle(dev)),
                     ("demo", lambda: check_demo(dev))):
        tools[name] = fn()
        phase("tools", tool=name, nvidia_smi=smi, result=tools[name])
    tool_launches = {k: sum(r["launches"][k] for r in
                            [tools["entry"], tools["stage_profile"],
                             tools["oracle"], tools["demo"]]
                            + tools["roofline"])
                     for k in ("ew_chain", "fleet_admm", "dense_loop")}
    phase("tools_phases", seconds=time.perf_counter() - t_tools,
          launches=tool_launches)

    # ---- 30-33. the fleet over torch.distributed: its main path at world
    # size 1 over NCCL (the one card; NCCL refuses two ranks of one
    # communicator on one GPU), the multi-device dry run and the scaling
    # study in processes of their own; the TPU-tuned solver options ----
    from intent_mpc_torch import entry as port_entry
    from intent_mpc_torch.benchmark import scaling
    from intent_mpc_torch.parallel import launch
    from intent_mpc_torch.parallel import sharding as sh
    t_fleet = time.perf_counter()
    sh.init_distributed("tcp://127.0.0.1:%d" % launch.free_port(), 1, 0,
                        backend="nccl")
    try:
        fleet_lines = check_fleet(cfg, 128, 8, sh.make_mesh(1))
    finally:
        torch.distributed.destroy_process_group()
    for line in fleet_lines:
        phase("fleet", nvidia_smi=smi, **line)
    fleet_runs = {line["solve"]: line for line in fleet_lines}
    t0 = time.perf_counter()
    dry = port_entry.dryrun_multichip(1, backend="nccl")
    phase("dryrun_multichip", seconds=time.perf_counter() - t0,
          nvidia_smi=smi, **dry)
    rows, rep = scaling.run_study([1], backend="nccl")
    phase("scaling", nvidia_smi=smi, rows=rows, **rep)
    knobs = check_solver_knobs(cfg, 32, 6, dev)
    for line in knobs:
        phase("solver_knobs", nvidia_smi=smi, **line)
    for line in check_knobs_small(dev):
        phase("card_vs_cpu", **line)
    phase("fleet_phases", seconds=time.perf_counter() - t_fleet)

    # ---- 29. clean modules ----
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
            "mapping_perception_fusion_32": map_launches["ew_chain"],
            "exploration_32": exp_launches["ew_chain"],
            "tools_entry_1": tools["entry"]["launches"]["ew_chain"],
            "tools_stage_profile_32":
                tools["stage_profile"]["launches"]["ew_chain"],
            "tools_oracle_loop_2": tools["oracle"]["launches"]["ew_chain"],
            "tools_demo_1": tools["demo"]["launches"]["ew_chain"],
            "fleet_nccl_world1_128":
                fleet_runs["default"]["launches"]["ew_chain"],
            **{"solver_knob_%s_32" % k["option"]: k["launches"]["ew_chain"]
               for k in knobs},
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
            "mapping_perception_fusion_32": map_launches["fleet_admm"],
            "exploration_32": exp_launches["fleet_admm"],
            "tools": tool_launches["fleet_admm"],
            "fleet_nccl_world1_fused_128":
                fleet_runs["fused"]["launches"]["fleet_admm"],
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
        "launches_of_other_paths": {
            "mapping_perception_fusion_32": map_launches["dense_loop"],
            "exploration_32": exp_launches["dense_loop"],
            "tools": tool_launches["dense_loop"]},
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
