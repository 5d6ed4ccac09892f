"""Run benchmark trials on the native C++ closed-loop runtime.

The all-C++ counterpart of `benchmark.harness`: every stage of the trial
(world, detector, predictor, candidate QPs, scoring, controller,
monitor) runs inside native/closed_loop.cpp with converged f64 solves —
the system-level oracle, on the host. Use it to cross-validate the
port's fleet statistics (the harness's aggregates) against an
implementation that shares none of its code.

Usage:
  python -m intent_mpc_torch.benchmark.native_loop --seeds 0 1 2 3 \
      --obstacles 200 --timeout 60 --out results/native_loop
"""

from __future__ import annotations

import argparse
import json
import os
import time


def aggregate(rows):
    n = len(rows)
    goals = sum(r["goal_reached"] for r in rows)
    return {
        "num_trials": n,
        "success_rate": goals / n,
        "collision_rate": sum(r["collision"] for r in rows) / n,
        "avg_travel_time": (sum(r["travel_time"] for r in rows
                                if r["goal_reached"]) / max(goals, 1)),
        "avg_path_length": (sum(r["path_length"] for r in rows
                                if r["goal_reached"]) / max(goals, 1)),
        "avg_min_obstacle_distance":
            sum(r["min_obstacle_distance"] for r in rows) / n,
        "vel_violation_rate": (sum(r["vel_violations"] for r in rows)
                               / max(sum(r["samples"] for r in rows), 1)),
        "acc_violation_rate": (sum(r["acc_violations"] for r in rows)
                               / max(sum(r["samples"] for r in rows), 1)),
        "jerk_violation_rate": (
            sum(r["jerk_violations"] for r in rows)
            / max(sum(r["jerk_samples"] for r in rows), 1)),
        "avg_max_velocity": sum(r["max_velocity"] for r in rows) / n,
        "solver_success_rate": (
            sum(r["solve_successes"] for r in rows)
            / max(sum(r["solve_attempts"] for r in rows), 1)),
    }


def main(argv=None) -> dict:
    from intent_mpc_torch.oracle import native
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--obstacles", type=int, default=200)
    ap.add_argument("--dynamic-ratio", type=float, default=0.65)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--max-obstacles", type=int, default=64)
    ap.add_argument("--max-iter", type=int, default=150)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--out", type=str, default="results/native_loop")
    args = ap.parse_args(argv)
    if not native.available():
        raise SystemExit(f"native runtime unavailable: {native.build_error()}")

    rows = []
    for seed in args.seeds:
        t0 = time.time()
        d = native.run_native_episode(
            seed=seed, num_obstacles=args.obstacles,
            dynamic_ratio=args.dynamic_ratio, timeout=args.timeout,
            max_obstacles=args.max_obstacles, max_iter=args.max_iter,
            eps=args.eps, nthreads=args.threads)
        d["seed"] = seed
        d["wall_s"] = round(time.time() - t0, 1)
        rows.append(d)
        print(f"[native seed {seed}] goal={d['goal_reached']} "
              f"col={d['collision']} maxv={d['max_velocity']:.2f} "
              f"velviol={int(d['vel_violations'])}/{int(d['samples'])} "
              f"({d['wall_s']}s)", flush=True)

    out = {"aggregate": aggregate(rows), "rows": rows,
           "config": vars(args)}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "summary.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps(out["aggregate"], indent=1))
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
