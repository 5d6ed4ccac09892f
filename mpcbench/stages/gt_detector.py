"""The ground-truth detector (fake_detector_param.yaml): the world and
the detector over the cycle, against the program's detector state after
it; and, as the configuration's perception stage, the obstacle input of
a cycle's plan (the detector's cycle-start update and its query)."""

from __future__ import annotations

import torch

from mpcbench.reference import cycle as refc

KEYS = ("pos_hist", "vel_hist", "acc_hist", "hist_len", "last_pos", "vel",
        "acc", "last_fd_time")
READS = dict({"det_" + k: "detector." + k for k in KEYS}, pos="pos")
NUMBERS = ("detector_pos_m", "detector_vel_mps", "flag_mismatches")


def detector(st: dict) -> dict:
    return {k: st["det_" + k] for k in KEYS}


def gaps(c, prog: dict) -> dict:
    det = refc.detector_cycle(c.cfg, c.sc, detector(c.st), c.cycle)
    pd = detector(prog)

    def worst(hist, now):
        return torch.maximum(
            (det[hist] - pd[hist]).abs().flatten(1).amax(1),
            (det[now] - pd[now]).abs().flatten(1).amax(1)).tolist()
    return {"detector_pos_m": worst("pos_hist", "last_pos"),
            "detector_vel_mps": worst("vel_hist", "vel"),
            "flag_mismatches": int((det["hist_len"] != pd["hist_len"]).sum())
            + int((det["last_fd_time"] != pd["last_fd_time"]).sum())}


def control(c) -> dict:
    det = refc.detector_cycle(c.cfg, c.sc, detector(c.st), c.cycle)
    return {"detector." + k: det[k] for k in KEYS}


def obstacles(c, st: dict, cycle: int) -> dict:
    d = refc.detector_start(c.cfg, c.sc, detector(st), cycle)
    ph, vh, size, hl, vis = refc.query(c.cfg["detector"], d, c.sc["bbox"], st["pos"])
    return dict(pos_hist=ph, vel_hist=vh, size_hist=size, hist_len=hl, visible=vis)
