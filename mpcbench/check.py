"""What decides `correct`: the program's cycles held against the plain
reference (mpcbench/reference), stage by stage.

The timed window keeps the program's carries of a sample of its cycles,
drawn from the seed (`Sampler`). Once the window has closed, each sample
(cycle i; its factor-refresh cycle r <= i; the carries before r, before
i and after i) is moved to the host and the reference recomputes, from
the program's state before the cycle:

  detector   the world and the ground-truth detector over the cycle,
             against the program's detector state after it;
  factor     the shared factor of the refresh cycle's candidate-mean QP
             (the default path carries it), against the program's;
  plan       predictor, the six candidate QPs, the shared factor, the
             solves, the scoring and the choice, against the states the
             program committed: the median over all sampled world-cycles,
             the tail over the settled ones (`settled_from`);
  plant      the controller and the plant over the cycle's ticks along
             the plan the program committed (the reference follows the
             program's plan, so the plant is held by itself), against
             the program's positions, velocities and controller;
  flags      acceptance, bookkeeping and collision flags, exactly.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import numpy as np
import torch

from mpcbench.reference import cycle as refc
from mpcbench.reference.solve import Precision

DET_KEYS = ("pos_hist", "vel_hist", "acc_hist", "hist_len", "last_pos", "vel",
            "acc", "last_fd_time")


def snapshot(carry) -> Dict[str, torch.Tensor]:
    """The program's state (an EngineCarry) as a flat dict of host
    tensors, under the reference's key names."""
    pl, d, c, m = carry.planner, carry.detector, carry.controller, carry.metrics
    out = dict(pos=carry.pos, vel=carry.vel,
               states_sol=pl.states_sol, controls_sol=pl.controls_sol,
               first_time=pl.first_time, has_solution=pl.has_solution,
               last_ref_start=pl.last_ref_start, xref=pl.xref, rho=pl.rho,
               pos_err_int=c.pos_err_int, vel_err_int=c.vel_err_int,
               prev_pos_err=c.prev_pos_err, prev_vel_err=c.prev_vel_err,
               ctrl_first=c.first, traj_age=carry.traj_age,
               traj_ready=carry.traj_ready, stopping=carry.stopping,
               stop_pos=carry.stop_pos, tracking_start=carry.tracking_start,
               done=carry.done, solve_attempts=m.solve_attempts,
               solve_successes=m.solve_successes, collision=m.collision,
               min_obstacle_dist=m.min_obstacle_dist)
    for k in DET_KEYS:
        out["det_" + k] = getattr(d, k)
    if pl.fac_minv is not None:
        out.update(fac_d=pl.fac_d, fac_c=pl.fac_c, fac_minv=pl.fac_minv,
                   fac_e=torch.cat([pl.fac_e.eq.flatten(1), pl.fac_e.sb.flatten(1),
                                    pl.fac_e.cb.flatten(1), pl.fac_e.obs.flatten(1)],
                                   dim=1))
    return {k: v.detach().to("cpu", copy=True) for k, v in out.items()}


def settled_from(cfg: dict) -> int:
    """The first cycle of a flight whose plan runs on a factor formed with
    the obstacle rows. The default path forms its shared factor at cycle
    0, before the detector holds any obstacle, and reuses it through cycle
    factor_reuse_cycles - 1; the fused path forms one every cycle."""
    s = cfg["planner"]["solver"]
    return 0 if s["fused_solve"] else s["factor_reuse_cycles"]


class Sampler:
    """A reservoir sample of `k` cycles of the window, drawn from the seed,
    holding references to the program's carries (never copies: a cycle
    returns a new carry and leaves its input as it was). Where none of
    the `k` is a settled cycle (see `settled_from`) and the window ran
    one, one drawn from those takes the place of the last."""

    def __init__(self, seed: int, k: int, refresh_every: int, settled: int):
        self.rng = random.Random(seed)
        self.k, self.every, self.settled = k, refresh_every, settled
        self.seen = self.seen_settled = 0
        self.kept: List[dict] = []
        self.spare = None       # one of the settled cycles
        self.refresh = None     # (cycle, carry) of the flight's last refresh

    def before(self, block: int, cycle: int, carry) -> None:
        if cycle % self.every == 0:
            self.refresh = (cycle, carry)

    def after(self, block: int, cycle: int, before, after) -> None:
        self.seen += 1
        item = dict(block=block, cycle=cycle, refresh_cycle=self.refresh[0],
                    at_refresh=self.refresh[1], before=before, after=after)
        if cycle >= self.settled:
            self.seen_settled += 1
            if self.rng.randrange(self.seen_settled) == 0:
                self.spare = item
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item

    def take(self) -> List[dict]:
        """The samples, their carries moved to the host, oldest first."""
        kept = self.kept
        if self.spare is not None and \
                all(s["cycle"] < self.settled for s in kept):
            kept = kept[:-1] + [self.spare]
        out = []
        for it in sorted(kept, key=lambda s: (s["block"], s["cycle"])):
            out.append(dict(block=it["block"], cycle=it["cycle"],
                            refresh_cycle=it["refresh_cycle"],
                            at_refresh=snapshot(it["at_refresh"]),
                            before=snapshot(it["before"]),
                            after=snapshot(it["after"])))
        self.kept, self.spare, self.refresh = [], None, None
        return out


def _state(s: dict, sl, dt, dev) -> dict:
    """The reference's view of a snapshot, scenarios `sl`."""
    st = {}
    for k, v in s.items():
        if k.startswith("det_"):
            continue
        v = v[sl].to(dev)
        st[k] = v.to(dt) if v.is_floating_point() else v
    det = {}
    for k in DET_KEYS:
        v = s["det_" + k][sl].to(dev)
        det[k] = v.to(dt) if v.is_floating_point() else v
    st["detector"] = det
    return st


def _scen(sc: dict, sl, dt, dev) -> dict:
    return {k: (v[sl].to(dev).to(dt) if v.is_floating_point() else v[sl].to(dev))
            for k, v in sc.items()}


def _rel(a, b):
    """Per scenario max |a - b| over max |b|."""
    a, b = a.flatten(1), b.flatten(1)
    return ((a - b).abs().amax(1) / torch.clamp(b.abs().amax(1), min=1e-300))


def stage_gaps(cfg: dict, blocks, ref_traj, sample: dict, chunk: int, device,
               program: dict = None) -> dict:
    """Per-scenario gaps of one sampled cycle (lists of floats, exact
    mismatch counts, and whether the cycle is settled). `program` replaces
    the program's committed outputs (the control: a lower-precision
    reference in its place)."""
    dt = torch.float64
    sc_all = blocks[sample["block"]]
    S = sc_all["origin"].shape[0]
    i, r = sample["cycle"], sample["refresh_cycle"]
    fused = cfg["planner"]["solver"]["fused_solve"]
    ref = ref_traj.to(device).to(dt)
    prog = sample["after"] if program is None else program
    out = {k: [] for k in ("detector_pos", "detector_vel", "factor_minv",
                           "factor_scale", "plan_state", "plant")}
    mism = 0
    for a in range(0, S, chunk):
        sl = slice(a, min(S, a + chunk))
        sc = _scen(sc_all, sl, dt, device)
        st = _state(sample["before"], sl, dt, device)
        pg = _state(prog, sl, dt, device)
        # detector over the cycle
        det = refc.detector_cycle(cfg, sc, st["detector"], i)
        pd = pg["detector"]
        out["detector_pos"] += torch.maximum(
            (det["pos_hist"] - pd["pos_hist"]).abs().flatten(1).amax(1),
            (det["last_pos"] - pd["last_pos"]).abs().flatten(1).amax(1)).tolist()
        out["detector_vel"] += torch.maximum(
            (det["vel_hist"] - pd["vel_hist"]).abs().flatten(1).amax(1),
            (det["vel"] - pd["vel"]).abs().flatten(1).amax(1)).tolist()
        mism += int((det["hist_len"] != pd["hist_len"]).sum())
        mism += int((det["last_fd_time"] != pd["last_fd_time"]).sum())
        # the shared factor in force
        if fused:
            fac = None
        else:
            st_r = _state(sample["at_refresh"], sl, dt, device)
            asm = refc.assemble(cfg, sc, ref, st_r, r)
            fac = refc.factor(cfg, asm["qps"], st_r["rho"], Precision("float64"))
            if "fac_minv" in pg:
                out["factor_minv"] += _rel(pg["fac_minv"], fac[3]).tolist()
                out["factor_scale"] += torch.stack(
                    [_rel(pg["fac_d"], fac[0]), _rel(pg["fac_e"], fac[1]),
                     _rel(pg["fac_c"][:, None], fac[2][:, None])]).amax(0).tolist()
        p = refc.plan(cfg, sc, ref, st, i, fac, Precision("float64"))
        gap = (p["states_sol"][..., 0:6] - pg["states_sol"][..., 0:6]).abs()
        out["plan_state"] += gap.flatten(1).amax(1).tolist()
        # flags
        valid_p = (pg["solve_successes"] - st["solve_successes"]) > 0
        mism += int((p["valid"] & ~st["done"] & ~st["stopping"] != valid_p).sum())
        bk = refc.bookkeeping(cfg, st, valid_p, i)
        for k in ("traj_age", "traj_ready", "stopping"):
            mism += int((bk[k] != pg[k]).sum())
        mism += int(((pg["solve_attempts"] - st["solve_attempts"]) > 0).ne(bk["run"]).sum())
        # plant along the program's committed plan
        step = dict(states_sol=pg["states_sol"], controls_sol=pg["controls_sol"],
                    traj_age=pg["traj_age"], traj_ready=pg["traj_ready"],
                    stopping=pg["stopping"], stop_pos=pg["stop_pos"])
        tk = refc.ticks(cfg, sc, st, step, i)
        out["plant"] += torch.stack([
            (tk["pos"] - pg["pos"]).abs().amax(1),
            (tk["vel"] - pg["vel"]).abs().amax(1),
            (tk["pos_err_int"] - pg["pos_err_int"]).abs().amax(1)]).amax(0).tolist()
        hit_p = pg["collision"] & ~st["collision"]
        mism += int(((tk["collision"] & ~st["collision"]) != hit_p).sum())
    out["mismatches"] = mism
    out["settled"] = i >= settled_from(cfg)
    return out


def numbers(gaps: List[dict]) -> Dict[str, float]:
    """The compared numbers of a run from its samples' gaps: the largest
    gap of every stage but the plan; of the plan, the median and the 90th
    percentile over all sampled scenario-cycles, and the 99th percentile
    and the largest over the settled ones; and the count of flag
    mismatches."""
    def cat(key):
        return [v for g in gaps for v in g[key]]
    out = {}
    for key, name in (("detector_pos", "detector_pos_m"),
                      ("detector_vel", "detector_vel_mps"),
                      ("factor_minv", "factor_minv_rel"),
                      ("factor_scale", "factor_scale_rel"),
                      ("plant", "plant_m")):
        v = cat(key)
        if v:
            out[name] = max(v)
    plan = np.asarray(cat("plan_state"))
    out["plan_state_p50"] = float(np.percentile(plan, 50))
    out["plan_state_p90"] = float(np.percentile(plan, 90))
    settled = np.asarray([v for g in gaps if g["settled"] for v in g["plan_state"]])
    if settled.size:
        out["plan_state_p99"] = float(np.percentile(settled, 99))
        out["plan_state_max"] = float(settled.max())
    out["flag_mismatches"] = float(sum(g["mismatches"] for g in gaps))
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every limited number at or
    under its limit; a number that is missing (value None) or not finite
    fails."""
    rows = []
    ok = True
    for name, lim in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows


def control_after(cfg: dict, blocks, ref_traj, sample: dict, prec: Precision,
                  chunk: int, device) -> dict:
    """The control: the reference in the program's place, computed in
    `prec` (and its state stored in it), from the program's state before
    the sampled cycle. Returns a snapshot-like dict of what it committed,
    as `stage_gaps` reads a program's."""
    dt = prec.dtype
    sc_all = blocks[sample["block"]]
    S = sc_all["origin"].shape[0]
    i, r = sample["cycle"], sample["refresh_cycle"]
    fused = cfg["planner"]["solver"]["fused_solve"]
    ref = ref_traj.to(device).to(dt)
    parts = []
    for a in range(0, S, chunk):
        sl = slice(a, min(S, a + chunk))
        sc = _scen(sc_all, sl, dt, device)
        st = _state(sample["before"], sl, dt, device)
        det = refc.detector_cycle(cfg, sc, st["detector"], i)
        fac = None
        if not fused:
            st_r = _state(sample["at_refresh"], sl, dt, device)
            fac = refc.factor(cfg, refc.assemble(cfg, sc, ref, st_r, r)["qps"],
                              st_r["rho"], prec)
        p = refc.plan(cfg, sc, ref, st, i, fac, prec)
        bk = refc.bookkeeping(cfg, st, p["valid"], i)
        step = dict(states_sol=p["states_sol"], controls_sol=p["controls_sol"],
                    traj_age=bk["traj_age"], traj_ready=bk["traj_ready"],
                    stopping=bk["stopping"], stop_pos=bk["stop_pos"])
        tk = refc.ticks(cfg, sc, st, step, i)
        out = dict(pos=tk["pos"], vel=tk["vel"], states_sol=p["states_sol"],
                   controls_sol=p["controls_sol"], traj_age=bk["traj_age"],
                   traj_ready=bk["traj_ready"], stopping=bk["stopping"],
                   stop_pos=bk["stop_pos"],
                   solve_attempts=st["solve_attempts"] + bk["run"].to(torch.int32),
                   solve_successes=st["solve_successes"] + bk["valid"].to(torch.int32),
                   collision=st["collision"] | tk["collision"],
                   pos_err_int=tk["pos_err_int"])
        if not fused:
            out.update(fac_d=p["factor"][0], fac_e=p["factor"][1],
                       fac_c=p["factor"][2], fac_minv=p["factor"][3])
        for k in DET_KEYS:
            out["det_" + k] = det[k]
        parts.append({k: prec.store(v).detach().cpu() for k, v in out.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
