"""The controller and the plant over the cycle's ticks along the plan the
program committed (the reference follows the program's plan, so the
plant is held by itself), against the program's positions, velocities
and controller; a control follows its own plan."""

from __future__ import annotations

import torch

from mpcbench.reference import cycle as refc

READS = dict(pos="pos", vel="vel", states_sol="planner.states_sol",
             controls_sol="planner.controls_sol", traj_age="traj_age",
             traj_ready="traj_ready", stopping="stopping", stop_pos="stop_pos",
             done="done", collision="metrics.collision",
             pos_err_int="controller.pos_err_int",
             vel_err_int="controller.vel_err_int",
             prev_pos_err="controller.prev_pos_err",
             prev_vel_err="controller.prev_vel_err",
             ctrl_first="controller.first")
NUMBERS = ("plant_m",)
STEP = ("states_sol", "controls_sol", "traj_age", "traj_ready", "stopping",
        "stop_pos")


def _ticks(c, step: dict) -> dict:
    tk = refc.ticks(c.cfg, c.sc, c.st, step, c.cycle)
    c.out["ticks"] = tk
    return tk


def gaps(c, prog: dict) -> dict:
    tk = _ticks(c, {k: prog[k] for k in STEP})
    return {"plant_m": torch.stack([
        (tk["pos"] - prog["pos"]).abs().amax(1),
        (tk["vel"] - prog["vel"]).abs().amax(1),
        (tk["pos_err_int"] - prog["pos_err_int"]).abs().amax(1)]).amax(0).tolist()}


def control(c) -> dict:
    p, bk = c.out["plan"], c.out["bookkeeping"]
    tk = _ticks(c, dict(states_sol=p["states_sol"], controls_sol=p["controls_sol"],
                        traj_age=bk["traj_age"], traj_ready=bk["traj_ready"],
                        stopping=bk["stopping"], stop_pos=bk["stop_pos"]))
    return {"pos": tk["pos"], "vel": tk["vel"],
            "metrics.collision": c.st["collision"] | tk["collision"],
            "controller.pos_err_int": tk["pos_err_int"]}
