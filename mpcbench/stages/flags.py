"""Acceptance, bookkeeping and collision flags, exactly: whether a
candidate was accepted, the run flag, trajectory age and readiness, the
goal stop and a new collision, each against what the program set."""

from __future__ import annotations

from mpcbench.reference import cycle as refc

READS = dict(pos="pos", done="done", stopping="stopping", stop_pos="stop_pos",
             traj_age="traj_age", traj_ready="traj_ready",
             tracking_start="tracking_start", collision="metrics.collision",
             solve_attempts="metrics.solve_attempts",
             solve_successes="metrics.solve_successes")
NUMBERS = ("flag_mismatches",)


def gaps(c, prog: dict) -> dict:
    st, p, tk = c.st, c.out["plan"], c.out["ticks"]
    valid_p = (prog["solve_successes"] - st["solve_successes"]) > 0
    mism = int((p["valid"] & ~st["done"] & ~st["stopping"] != valid_p).sum())
    bk = refc.bookkeeping(c.cfg, st, valid_p, c.cycle)
    for k in ("traj_age", "traj_ready", "stopping"):
        mism += int((bk[k] != prog[k]).sum())
    mism += int(((prog["solve_attempts"] - st["solve_attempts"]) > 0).ne(bk["run"]).sum())
    hit_p = prog["collision"] & ~st["collision"]
    mism += int(((tk["collision"] & ~st["collision"]) != hit_p).sum())
    return {"flag_mismatches": mism}


def control(c) -> dict:
    return {}
