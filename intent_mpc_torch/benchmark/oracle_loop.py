"""Oracle-in-the-loop validation: fly the closed loop on the f64 oracle.

The DYNUS benchmark's commanded-limit violation rates are claimed to be a
property of the FORMULATION (chronically infeasible candidate QPs whose
compromise iterates the reference executes without checking OSQP status,
mpcPlanner.cpp:513-526), not an artifact of the float32 solver. This
script tests that claim on the port: it runs the exact same closed loop
(same world, detector, predictor, candidate construction, scoring,
controller) but solves every candidate QP with the native f64 oracle
(native/qp_solver.cpp: Ruiz scaling, in-solve adaptive rho with
refactorization, warm start) through the planner's `solve_override`
hook, then compares violation statistics side by side with the float32
runtime on the same seeds.

The override is a host round trip: each cycle it copies the dense
problems of all S x 6 candidates to the host as float64, solves them in
one threaded native call, and puts x, y and the primal residual back on
the scenarios' device as float32. It is a validation tool, off the main
path; no `ew_chain` launches on a cycle it solves.

Usage (the GPU by default; `--device cpu` runs the plain versions):
  python -m intent_mpc_torch.benchmark.oracle_loop --seeds 0 1 2 3 \
      --obstacles 200 --max-obstacles 32 --timeout 60 \
      --oracle-iters 150 --out results/oracle_loop

`--solver osqp` flies the reference's own libosqp.so (oracle/osqp_ref.py),
which loads only where the reference's vendored tree is in the
repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from intent_mpc_torch.ops import qp as qplib
from intent_mpc_torch.ops.admm import ADMMResult
from intent_mpc_torch.utils.config import IntentMPCConfig, PlannerConfig
from intent_mpc_torch.utils.device import resolve_device

SOLVED_PRIM_RES = 5e-2       # the runtime solver's feasibility tolerance


def host_problems(cfg: PlannerConfig, qps: qplib.QPData,
                  warm6: torch.Tensor):
    """The candidate QPs (S, 6, ...) as P = S x 6 dense float64 problems on
    the host: A (P, m, n), l, u (P, m), q, warm (P, n)."""
    A = qplib.dense_a_matrix(cfg, qps)
    parts = (A, qplib.con_to_flat(qps.l), qplib.con_to_flat(qps.u), qps.q,
             warm6)
    return [t.detach().cpu().numpy().astype(np.float64)
            .reshape((-1,) + tuple(t.shape[2:])) for t in parts]


def primal_residual(A, l, u, x) -> np.ndarray:
    """||Ax - clip(Ax, l, u)||_inf per problem, in float64, as float32."""
    ax = np.einsum("cmn,cn->cm", A, x)
    return np.abs(ax - np.clip(ax, l, u)).max(axis=-1).astype(np.float32)


def device_result(cfg: PlannerConfig, qps: qplib.QPData, x, y, prim,
                  solved_all: bool) -> ADMMResult:
    """The host solution as the planner's ADMMResult on the QPs' device:
    x, y, the primal residual in float32, NaN dual residuals; solved is
    prim < SOLVED_PRIM_RES, or everywhere with `solved_all`."""
    S, C = qps.q.shape[:2]
    dev = qps.q.device
    K = qps.G.shape[-2]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
            .reshape((S, C) + a.shape[1:]).to(dev)
    p = put(prim)
    return ADMMResult(
        x=put(x), y=qplib.flat_to_con(put(y), cfg, K), prim_res=p,
        dual_res=torch.full_like(p, float("nan")),
        solved=(torch.ones_like(p, dtype=torch.bool) if solved_all
                else p < SOLVED_PRIM_RES),
        rho_suggest=torch.full_like(p, cfg.solver.rho))


def make_oracle_override(cfg: PlannerConfig, max_iter: int = 150,
                         eps: float = 1e-3, adapt_interval: int = 50):
    """A make_plan_with_pred solve_override that solves the S x 6
    candidate QPs with the native f64 oracle in one threaded call.

    The dense problem data and the reference-style primal warm start go
    to the host; primal, duals and the primal residual come back, so the
    engine's acceptance and scoring path is identical. A zero warm row is
    a cold start inside the solver. Raises RuntimeError, with the
    compiler's error, when the native library is unavailable."""
    from intent_mpc_torch.oracle import native
    if not native.available():
        raise RuntimeError("native f64 oracle unavailable: %s"
                           % native.build_error())
    hdiag = qplib.hessian_diag(cfg).double().numpy()

    def override(qps, warm6):
        A, l, u, q, warm = host_problems(cfg, qps, warm6)
        xs, ys, _status, _iters = native.solve_qp_batch(
            hdiag, q, A, l, u, max_iter=max_iter, eps=eps,
            adapt_interval=adapt_interval, x0=warm)
        return device_result(cfg, qps, xs, ys, primal_residual(A, l, u, xs),
                             solved_all=False)

    return override


def make_osqp_override(cfg: PlannerConfig, time_limit: float = 0.05,
                       eps_abs: float = 1e-3, eps_rel: float = 1e-3,
                       max_iter: int = 4000):
    """solve_override that flies the closed loop on the reference's ACTUAL
    vendored libosqp.so (oracle/osqp_ref.py) at the reference's exact
    runtime protocol (mpcPlanner.cpp:439-527):

      - OSQP 0.6.2 defaults (eps 1e-3, adaptive rho, check_termination 25,
        polish OFF — constants.h POLISH(0), never overridden)
      - verbose off, warm_start on
      - fresh osqp_setup per candidate solve (the reference constructs a
        new OsqpEigen::Solver inside solveTraj every call)
      - warm primal = previous best solution, warm dual = zeros
        (setWarmStart at mpcPlanner.cpp:489-509; zeros on firstTime)
      - time_limit = solver_time_limit (0.05 s) EXCEPT on the first solve
        (firstTime_ gate at :442-444). A zero warm row marks first-time:
        the engine feeds zeros until a solution exists, and a real
        solution is never exactly all-zero.
      - any non-error exit is accepted and executed (the reference only
        checks the OsqpEigen error flag, :512-520 — time-limit/max-iter
        iterates fly)
    """
    from intent_mpc_torch.oracle import osqp_ref
    if not osqp_ref.available():
        raise RuntimeError("vendored libosqp.so unavailable at %s"
                           % osqp_ref._LIB_PATH)
    P = np.diag(qplib.hessian_diag(cfg).double().numpy())

    def override(qps, warm6):
        A, l, u, q, warm = host_problems(cfg, qps, warm6)
        xs = np.zeros((A.shape[0], A.shape[2]))
        ys = np.zeros(A.shape[:2])
        for c in range(A.shape[0]):
            first = not np.any(warm[c])
            r = osqp_ref.solve(
                P, q[c], A[c], l[c], u[c], eps_abs=eps_abs,
                eps_rel=eps_rel, max_iter=max_iter,
                time_limit=0.0 if first else time_limit, warm_x=warm[c])
            xs[c] = r["x"]
            ys[c] = r["y"]
        # accept-any-iterate: the reference executes whatever OSQP
        # returns on a non-error exit, including time-limit iterates
        return device_result(cfg, qps, xs, ys, primal_residual(A, l, u, xs),
                             solved_all=True)

    return override


def run_divergence(cfg: IntentMPCConfig, seed: int, override,
                   runtime_iters=None, truncation: str = None,
                   device=None) -> dict:
    """Per-cycle control divergence over a LOCKSTEP episode: each replan
    cycle, solve the same carry TWICE — once with the override (which
    flies the episode) and once with the float32 runtime solver — and
    record the inf-norm distance between the two CHOSEN control solutions
    (each side's own candidate scoring, i.e. the command stream each
    solver would execute). Reported per cycle:
      du_full  = ||controls_override - controls_f32||_inf over the horizon
      du_first = same over the FIRST control step (the executed 100 ms)
    """
    from intent_mpc_torch.engine import closed_loop as cl
    from intent_mpc_torch.models.occupancy import empty_grid
    from intent_mpc_torch.models.world import straight_line_ref_traj
    from intent_mpc_torch.parallel import sharding as sh

    dev = resolve_device(device)
    if truncation:
        cfg = cfg.replace(planner=dataclasses.replace(
            cfg.planner, solver=dataclasses.replace(
                cfg.planner.solver, truncation=truncation)))
    scen = sh.stack_scenarios(cfg, [seed], device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5, device=dev)
    L = ref.shape[0]
    occ = empty_grid(dev)
    W = cfg.planner.mpc_window

    carry = cl.init_carry(cfg, scen, device=dev)
    c_over = carry
    du_full, du_first = [], []
    for i in range(cfg.engine.num_cycles):
        c_over = cl.episode_step(cfg, scen, ref, L, occ, carry, i,
                                 solve_override=override)[0]
        c_f32 = cl.episode_step(cfg, scen, ref, L, occ, carry, i,
                                runtime_iters)[0]
        if bool(c_over.done[0]) and bool(carry.done[0]):
            break
        if bool(c_over.traj_ready[0]) and bool(c_f32.traj_ready[0]):
            uo = c_over.planner.controls_sol[0].cpu().numpy() \
                .reshape(W, 5)[:, :3]
            uf = c_f32.planner.controls_sol[0].cpu().numpy() \
                .reshape(W, 5)[:, :3]
            du_full.append(float(np.abs(uo - uf).max()))
            du_first.append(float(np.abs(uo[0] - uf[0]).max()))
        carry = c_over      # the override's solution flies the episode
    row = {"seed": seed, "cycles_compared": len(du_full),
           "goal_reached": bool(c_over.metrics.goal_reached[0])}
    for name, a in (("du_full", np.array(du_full)),
                    ("du_first", np.array(du_first))):
        # no cycle had both trajectories ready: null stats
        row[f"{name}_mean"] = float(a.mean()) if a.size else None
        row[f"{name}_p95"] = float(np.percentile(a, 95)) if a.size else None
        row[f"{name}_max"] = float(a.max()) if a.size else None
    return row


def build_cfg(args) -> IntentMPCConfig:
    cfg = IntentMPCConfig()
    planner = dataclasses.replace(cfg.planner,
                                  max_obstacles=args.max_obstacles)
    return cfg.replace(
        planner=planner,
        world=dataclasses.replace(cfg.world, num_obstacles=args.obstacles,
                                  dynamic_ratio=args.dynamic_ratio),
        engine=dataclasses.replace(cfg.engine, timeout=args.timeout))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=list(range(8)))
    ap.add_argument("--obstacles", type=int, default=200)
    ap.add_argument("--dynamic-ratio", type=float, default=0.65)
    ap.add_argument("--max-obstacles", type=int, default=32,
                    help="QP obstacle slots (reduced from the production "
                         "64 to keep the f64 dense solves tractable; the "
                         "float32 comparison rows use the SAME value)")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--oracle-iters", type=int, default=150)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--runtime-iters", type=int, default=None,
                    help="float32 runtime ADMM iterations (default: config)")
    ap.add_argument("--skip-runtime", action="store_true")
    ap.add_argument("--solver", choices=["native", "osqp"],
                    default="native",
                    help="'native' = self-built f64 oracle; 'osqp' = the "
                         "reference's vendored libosqp.so at the "
                         "reference's runtime settings (warm start, "
                         "0.05 s time limit, OSQP defaults)")
    ap.add_argument("--time-limit", type=float, default=0.05,
                    help="per-candidate OSQP time limit (planner_param."
                         "yaml solver_time_limit; 0 disables)")
    ap.add_argument("--divergence", action="store_true",
                    help="per-cycle lockstep control-divergence mode "
                         "(run_divergence): fly each seed on the chosen "
                         "solver, solving every cycle's carry with BOTH "
                         "that solver and the float32 runtime; report "
                         "du_full/du_first stats instead of fleet rows")
    ap.add_argument("--runtime-truncation", type=str, default=None,
                    choices=["fixed", "osqp"],
                    help="float32-runtime truncation mode for --divergence")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    ap.add_argument("--out", type=str, default="results/oracle_loop")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from intent_mpc_torch.benchmark import harness as H
    from intent_mpc_torch.engine.closed_loop import run_episode, summarize
    from intent_mpc_torch.models.world import straight_line_ref_traj
    from intent_mpc_torch.parallel import sharding as sh

    cfg = build_cfg(args)
    if args.solver == "osqp":
        override = make_osqp_override(cfg.planner,
                                      time_limit=args.time_limit)
    else:
        override = make_oracle_override(cfg.planner,
                                        max_iter=args.oracle_iters,
                                        eps=args.eps)

    os.makedirs(args.out, exist_ok=True)
    if args.divergence:
        rows = []
        for seed in args.seeds:
            t0 = time.time()
            row = run_divergence(cfg, seed, override,
                                 runtime_iters=args.runtime_iters,
                                 truncation=args.runtime_truncation,
                                 device=dev)
            row["wall_s"] = round(time.time() - t0, 1)
            rows.append(row)
            if row["cycles_compared"]:
                print(f"[div seed {seed}] cycles={row['cycles_compared']} "
                      f"du_first mean={row['du_first_mean']:.3f} "
                      f"p95={row['du_first_p95']:.3f} "
                      f"max={row['du_first_max']:.3f} ({row['wall_s']}s)",
                      flush=True)
            else:
                print(f"[div seed {seed}] cycles=0 (no comparable cycles) "
                      f"({row['wall_s']}s)", flush=True)
        path = os.path.join(args.out, "divergence.json")
        out = {"config": vars(args), "rows": rows}
        with open(path, "w") as f:
            json.dump(out, f, indent=1, default=float)
        print("wrote", path)
        return out

    # every seed flies in one batch: the override solves all S x 6
    # candidate QPs of a cycle in one native call
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5, device=dev)
    scen = sh.stack_scenarios(cfg, args.seeds, device=dev)
    t0 = time.time()
    carry, _ = run_episode(cfg, scen, ref, ref.shape[0], device=dev,
                           solve_override=override)
    oracle_rows = summarize(cfg, carry)
    wall = round(time.time() - t0, 1)
    for seed, row in zip(args.seeds, oracle_rows):
        row["seed"] = seed
        print(f"[oracle seed {seed}] goal={row['goal_reached']} "
              f"col={row['collision']} maxv={row['max_velocity']:.2f} "
              f"velviol={row['vel_violation_count']}/"
              f"{row['vel_total_samples']}", flush=True)

    out = {"config": {"obstacles": args.obstacles,
                      "max_obstacles": args.max_obstacles,
                      "timeout": args.timeout,
                      "oracle_iters": args.oracle_iters,
                      "eps": args.eps, "seeds": args.seeds,
                      "solver": args.solver,
                      "time_limit": args.time_limit,
                      "device": str(dev)},
           "oracle": H.aggregate(oracle_rows),
           "oracle_rows": oracle_rows, "oracle_wall_s": wall}

    if not args.skip_runtime:
        t0 = time.time()
        rt_rows = H.run_trials(cfg, args.seeds,
                               solver_iters=args.runtime_iters, device=dev)
        for seed, row in zip(args.seeds, rt_rows):
            row["seed"] = seed
        out["runtime"] = H.aggregate(rt_rows)
        out["runtime_rows"] = rt_rows
        out["runtime_wall_s"] = round(time.time() - t0, 1)

    path = os.path.join(args.out, "summary.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({k: out[k] for k in ("oracle", "runtime")
                      if k in out}, indent=1, default=float))
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
