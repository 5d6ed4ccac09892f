"""What decides `correct`: the program's cycles held against the plain
reference (mpcbench/reference), stage by stage.

The timed window keeps the program's carries of a sample of its cycles,
drawn from the seed (`Sampler`). Once the window has closed, each sample
(cycle i; its factor-refresh cycle r <= i; the carries before r, before
i and after i) is moved to the host, the whole carry by path
(`snapshot`), and each stage that the configuration file lists under
"stages" (default `GT_STAGES`) recomputes its part of the cycle from the
program's state before it, in blocks of scenarios, and holds it against
what the program committed after it.

A stage is the file mpcbench/stages/<name>.py, found by name. It holds

  READS          {name: carry path}: what it reads of the snapshots, under
                 the names its reference takes ("detector.pos_hist" ...)
  gaps(c, prog)  the reference in float64 from the state before the cycle
                 (c, a `Cycle`) against `prog`, the view of what the
                 program (or a control in its place) committed: {compared
                 number's name: per-scenario gaps (a list) or an exact
                 mismatch count (an int)}
  control(c)     the same reference computed in c.prec, the control:
                 {carry path: tensor} of what the stage commits, so that
                 a control is held by `gaps` as the program is
  NUMBERS        the names of the numbers it gives, each the largest gap
                 over the samples (a count: the sum), or numbers(gaps) of
                 its own
  obstacles(c, st, cycle)  (a perception stage) the cycle's obstacle input
                 of the plan, as reference/cycle.assemble takes it

Stages run in the listed order and hand on what later ones read in
`Cycle.out`.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List

import torch

from mpcbench.reference.solve import Precision

GT_STAGES = ("gt_detector", "factor", "plan", "plant", "flags")


def stages(cfg: dict) -> list:
    """The configuration's stage modules, in order."""
    from mpcbench import harness as hz
    return [hz.load_module("stages", n) for n in cfg.get("stages", GT_STAGES)]


def snapshot(carry) -> Dict[str, torch.Tensor]:
    """The program's state (an EngineCarry) as a flat dict of host
    tensors, each under its path of field names ("planner.states_sol",
    "real_det.tracks.P"); None fields are left out."""
    out = {}

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, torch.Tensor):
            out[path] = x.detach().to("cpu", copy=True)
            return
        if dataclasses.is_dataclass(x):
            items = [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            items = zip(x._fields, x)
        else:
            raise TypeError("carry field %s holds a %s" % (path, type(x).__name__))
        for k, v in items:
            walk(v, path + "." + k if path else k)
    walk(carry, "")
    return out


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


def reads(mods) -> Dict[str, str]:
    """The stages' READS together; one name read from two paths is an
    error."""
    out = {}
    for m in mods:
        for name, path in m.READS.items():
            if out.setdefault(name, path) != path:
                raise ValueError("stage %s reads %s from %s, another from %s"
                                 % (m.__name__, name, path, out[name]))
    return out


def view(snap: dict, names: Dict[str, str], sl, dt, dev) -> dict:
    """The reference's view of a snapshot (or of a control's commits):
    scenarios `sl` of each path it holds, under the stages' names, on
    `dev`, floating point in `dt`."""
    out = {}
    for name, path in names.items():
        if path in snap:
            v = snap[path][sl].to(dev)
            out[name] = v.to(dt) if v.is_floating_point() else v
    return out


def _scen(sc: dict, sl, dt, dev) -> dict:
    return {k: (v[sl].to(dev).to(dt) if v.is_floating_point() else v[sl].to(dev))
            for k, v in sc.items()}


def rel(a, b):
    """Per scenario max |a - b| over max |b|."""
    a, b = a.flatten(1), b.flatten(1)
    return ((a - b).abs().amax(1) / torch.clamp(b.abs().amax(1), min=1e-300))


class Cycle:
    """One sampled cycle in one block of scenarios, as the stages see it:
    the configuration, the worlds `sc`, the reference trajectory, the
    cycle i and its refresh cycle r, the precision, the stages' READS
    `names`, the state before the cycle `st` and before r `at_refresh`,
    and `out`, what earlier stages computed."""

    def __init__(self, cfg, mods, names, sc_all, ref, sample, sl, prec, dev):
        self.cfg, self.prec, self.dev, self.names = cfg, prec, dev, names
        self.cycle, self.refresh = sample["cycle"], sample["refresh_cycle"]
        self.sc = _scen(sc_all, sl, prec.dtype, dev)
        self.ref = ref
        self.st = view(sample["before"], names, sl, prec.dtype, dev)
        self.at_refresh = view(sample["at_refresh"], names, sl, prec.dtype, dev)
        self.perception = next((m for m in mods if hasattr(m, "obstacles")), None)
        self.out = {}

    def obstacles(self, st: dict, cycle: int) -> dict:
        """The perception stage's obstacle input of cycle `cycle` from
        state `st`."""
        if self.perception is None:
            raise ValueError("the configuration's stages hold no perception "
                             "stage (one with obstacles())")
        return self.perception.obstacles(self, st, cycle)


def _blocks(cfg, mods, blocks, ref_traj, sample, prec, chunk, device):
    """The sample's `Cycle`s, one per block of `chunk` scenarios."""
    sc_all = blocks[sample["block"]]
    S = sc_all["origin"].shape[0]
    ref = ref_traj.to(device).to(prec.dtype)
    names = reads(mods)
    for a in range(0, S, chunk):
        sl = slice(a, min(S, a + chunk))
        yield sl, Cycle(cfg, mods, names, sc_all, ref, sample, sl, prec, device)


def stage_gaps(cfg: dict, mods, blocks, ref_traj, sample: dict, chunk: int,
               device, program: dict = None) -> dict:
    """Per-scenario gaps of one sampled cycle, stage by stage (lists of
    floats and exact mismatch counts under the compared numbers' names),
    and whether the cycle is settled. `program` replaces the program's
    committed outputs (the control: a lower-precision reference in its
    place)."""
    prog = sample["after"] if program is None else program
    out = {}
    for sl, c in _blocks(cfg, mods, blocks, ref_traj, sample,
                         Precision("float64"), chunk, device):
        pg = view(prog, c.names, sl, torch.float64, device)
        for m in mods:
            for k, v in m.gaps(c, pg).items():
                if isinstance(v, list):
                    out[k] = out.get(k, []) + v
                else:
                    out[k] = out.get(k, 0) + int(v)
    out["settled"] = sample["cycle"] >= settled_from(cfg)
    return out


def control_after(cfg: dict, mods, blocks, ref_traj, sample: dict,
                  prec: Precision, chunk: int, device) -> dict:
    """The control: the reference in the program's place, computed in
    `prec` (and its state stored in it), from the program's state before
    the sampled cycle. Returns a snapshot-like dict of what it committed,
    as `stage_gaps` reads a program's."""
    parts = []
    for _, c in _blocks(cfg, mods, blocks, ref_traj, sample, prec, chunk, device):
        got = {}
        for m in mods:
            got.update(m.control(c))
        parts.append({k: prec.store(v).detach().cpu() for k, v in got.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def largest(gaps: List[dict], names) -> Dict[str, float]:
    """The largest gap of each name over the samples' gaps, or the sum of
    its counts; a name no sample gave is left out."""
    out = {}
    for name in names:
        vs = [g[name] for g in gaps if name in g]
        if vs and isinstance(vs[0], list):
            flat = [v for x in vs for v in x]
            if flat:
                out[name] = max(flat)
        elif vs:
            out[name] = float(sum(vs))
    return out


def numbers(gaps: List[dict], mods) -> Dict[str, float]:
    """The compared numbers of a run from its samples' gaps, stage by
    stage."""
    out = {}
    for m in mods:
        out.update(m.numbers(gaps) if hasattr(m, "numbers")
                   else largest(gaps, m.NUMBERS))
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
