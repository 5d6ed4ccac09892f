"""Stage profile of the replan cycle on the GPU.

    python -m intent_mpc_torch.benchmark.stage_profile [--batch 32]
        [--iters N] [--reps 20] [--device cuda]

Advances the production DYNUS fleet (`IntentMPCConfig()`) 5 cycles to a
mid-flight state, freezes every stage's inputs there, and times each
stage of the cycle on them: the full `episode_step`; the predictor;
assembly (prediction, the 6 candidate QP builds, scoring and selection,
with the solve replaced by the frozen state's result); the shared
factor; the 100-iteration solve with the factor held, at CG refinement
3, 0 and 1; and the refinement cost (3 against 0).

Each stage runs once to warm up, then `reps` times between CUDA events,
each rep's output threaded into the next rep's input as the JAX
package's scanned bodies thread theirs. Eager PyTorch launches
asynchronously and the cycle is host-bound, so the events time the
wall of the whole launch sequence: "wall_ms" per call. One more rep runs
under torch.profiler (benchmark/profile_cycle.profiled, the CUDA
activity only) for the summed kernel time ("busy_ms") and the kernel
launches of the call. Prints a
line per stage and one JSON line with the card's name and power limit.
On the CPU (tests) the stages are timed with the host clock and busy_ms
and launches are not measured (null).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity

from intent_mpc_torch.benchmark.profile_cycle import profiled
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models import detector as det
from intent_mpc_torch.models import mpc as mpclib
from intent_mpc_torch.models import predictor as predlib
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import (obstacle_state,
                                           straight_line_ref_traj)
from intent_mpc_torch.ops.admm import (admm_factor, admm_solve,
                                       candidate_mean)
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device

ADVANCE = 5            # cycles flown before the stages are frozen
REFINES = (3, 0, 1)


def _threaded(dev, body, x, reps: int):
    """x after `reps` calls x = body(x), and the ms per call: between CUDA
    events on the card, by the host clock elsewhere."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            x = body(x)
        return x, (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        x = body(x)
    b.record()
    b.synchronize()
    return x, a.elapsed_time(b) / reps


def profile_stages(cfg: IntentMPCConfig, batch: int, iters=None,
                   reps: int = 20, device=None) -> dict:
    """Time every stage of cfg's cycle at `batch` scenarios (see the
    module docstring); returns {"stages": [{name, wall_ms, busy_ms,
    launches}], ...}."""
    dev = resolve_device(device)
    pcfg = cfg.planner
    iters = iters or pcfg.solver.max_iter
    scen = sh.stack_scenarios(cfg, range(batch), device=dev)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5, device=dev)
    L = ref.shape[0]
    occ = empty_grid(dev)
    carry = cl.init_carry(cfg, scen, device=dev)
    for i in range(ADVANCE):
        carry, _ = cl.episode_step(cfg, scen, ref, L, occ, carry, i)

    # ---- the frozen stage inputs: the detector query of cycle ADVANCE ----
    cycle_dt = cfg.engine.control_dt * cfg.engine.ticks_per_cycle
    t0 = torch.full((), float(ADVANCE), device=dev) * cycle_dt
    obs_pos0, _ = obstacle_state(scen, t0)
    d = det.hist_push(det.fd_update(cfg.detector, carry.detector, obs_pos0,
                                    t0), obs_pos0)
    pos_h, vel_h, acc_h, size_h, hist_len, visible = det.query_history(
        cfg.detector, d, scen.bbox, carry.pos)
    rho = carry.planner.rho

    def predict(c):
        return predlib.predict(cfg.predictor, pos_h + c * 1e-30, vel_h, acc_h,
                               size_h, hist_len, occ)

    def factor(qps, c=0.0):
        qp_mean = candidate_mean(qps)
        return admm_factor(pcfg, qp_mean._replace(q=qp_mean.q + c * 1e-30),
                           rho_override=rho)

    def plan(c, override):
        return mpclib.make_plan_with_pred(
            pcfg, carry.planner, carry.pos, carry.vel, ref, L, predict(c),
            visible, iters, cycle_idx=ADVANCE, solve_override=override)

    # the candidate QPs and warm starts of the frozen state, solved once as
    # the main path solves a factor-refresh cycle
    seen = []

    def record(qps, warm6):
        res = admm_solve(pcfg, qps, warm6, iters, rho_override=rho[:, None],
                         factor=factor(qps))
        seen.append((qps, warm6, res))
        return res
    plan(0.0, record)
    qps, warm6, res0 = seen[0]
    fac = factor(qps)
    zero = torch.zeros((), device=dev)

    def episode(c):
        return cl.episode_step(cfg, scen, ref, L, occ, c, ADVANCE, iters)[0]

    def solve(refine):
        rcfg = dataclasses.replace(pcfg, solver=dataclasses.replace(
            pcfg.solver, shared_refine_iters=refine))

        def body(w):
            res = admm_solve(rcfg, qps, w, iters, rho_override=rho[:, None],
                             factor=fac)
            return w * 0.999 + res.x * 1e-3
        return body

    stages = [
        ("episode_step (full cycle)", episode, carry),
        ("predictor", lambda c: c + predict(c).pos.flatten()[0] * 0.0, zero),
        ("assembly (pred+QP build+scoring)",
         lambda c: c + plan(c, lambda q, w: res0).state.states_sol
         .flatten()[0] * 0.0, zero),
        ("shared factor (structured)",
         lambda c: c + factor(qps, c).Minv.flatten()[0] * 0.0, zero),
    ] + [("solve %dit, %d refine" % (iters, r), solve(r), warm6)
         for r in REFINES]

    out = []
    for name, body, x in stages:
        x, wall = _threaded(dev, body, body(x), reps)     # after a warm-up
        busy = launches = None
        if dev.type == "cuda":
            _, _, by_name, launches, _ = profiled(
                lambda c, i: body(c), x, [0],
                activities=(ProfilerActivity.CUDA,))
            busy = sum(t for _, t in by_name.values()) / 1e3
        out.append({"stage": name, "wall_ms": wall, "busy_ms": busy,
                    "launches": launches})
    by = {s["stage"]: s["wall_ms"] for s in out}
    out.append({"stage": "refinement cost (3 vs 0)",
                "wall_ms": by["solve %dit, 3 refine" % iters]
                - by["solve %dit, 0 refine" % iters],
                "busy_ms": None, "launches": None})
    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
            "scenarios": batch, "iters": iters, "reps": reps,
            "advanced_cycles": ADVANCE, "stages": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    r = profile_stages(IntentMPCConfig(), args.batch, args.iters, args.reps,
                       args.device)
    print_stages(r)
    if r["device"] != "cpu":
        from intent_mpc_torch.benchmark.bench import card_power
        r["nvidia_smi"] = card_power()
    print(json.dumps(r))
    return r


def print_stages(r: dict) -> None:
    for s in r["stages"]:
        busy = ("" if s["busy_ms"] is None else
                "  busy %8.2f ms  %6d launches" % (s["busy_ms"],
                                                   s["launches"]))
        print("%-34s %9.2f ms/cycle%s" % (s["stage"], s["wall_ms"], busy))


if __name__ == "__main__":
    main()
