"""The plan: predictor, the six candidate QPs on the perception stage's
obstacle input, the shared factor in force (the factor stage's), the
100-iteration ADMM, scoring and choice, against the states the program
committed, by each world-cycle's largest gap in position and velocity."""

from __future__ import annotations

import numpy as np

from mpcbench.reference import cycle as refc
from mpcbench.reference.solve import Precision

READS = dict(pos="pos", vel="vel", states_sol="planner.states_sol",
             controls_sol="planner.controls_sol",
             first_time="planner.first_time",
             has_solution="planner.has_solution",
             last_ref_start="planner.last_ref_start", xref="planner.xref",
             rho="planner.rho", done="done", stopping="stopping",
             traj_age="traj_age", traj_ready="traj_ready",
             stop_pos="stop_pos", tracking_start="tracking_start",
             solve_attempts="metrics.solve_attempts",
             solve_successes="metrics.solve_successes")
NUMBERS = ("plan_state_p50", "plan_state_p90", "plan_state_p99",
           "plan_state_max")


def _plan(c, prec):
    p = refc.plan(c.cfg, c.ref, c.st, c.obstacles(c.st, c.cycle),
                  c.out.get("factor"), prec)
    c.out["plan"] = p
    return p


def gaps(c, prog: dict) -> dict:
    p = _plan(c, Precision("float64"))
    gap = (p["states_sol"][..., 0:6] - prog["states_sol"][..., 0:6]).abs()
    return {"plan_state": gap.flatten(1).amax(1).tolist()}


def control(c) -> dict:
    p = _plan(c, c.prec)
    st = c.st
    bk = refc.bookkeeping(c.cfg, st, p["valid"], c.cycle)
    c.out["bookkeeping"] = bk
    return {"planner.states_sol": p["states_sol"],
            "planner.controls_sol": p["controls_sol"],
            "traj_age": bk["traj_age"], "traj_ready": bk["traj_ready"],
            "stopping": bk["stopping"], "stop_pos": bk["stop_pos"],
            "metrics.solve_attempts": st["solve_attempts"] + bk["run"].to(
                st["solve_attempts"].dtype),
            "metrics.solve_successes": st["solve_successes"] + bk["valid"].to(
                st["solve_successes"].dtype)}


def numbers(gaps: list) -> dict:
    """The median and the 90th percentile over all sampled scenario-cycles,
    the 99th percentile and the largest over the settled ones."""
    plan = np.asarray([v for g in gaps for v in g["plan_state"]])
    out = {"plan_state_p50": float(np.percentile(plan, 50)),
           "plan_state_p90": float(np.percentile(plan, 90))}
    settled = np.asarray([v for g in gaps if g["settled"] for v in g["plan_state"]])
    if settled.size:
        out["plan_state_p99"] = float(np.percentile(settled, 99))
        out["plan_state_max"] = float(settled.max())
    return out
