"""The shared factor of the refresh cycle's candidate-mean QP (the
default path carries it; the fused path forms its own every cycle and
carries none), against the program's: Minv, and the Ruiz scales D, E and
the cost scale c."""

from __future__ import annotations

import torch

from mpcbench import check
from mpcbench.reference import cycle as refc

E_GROUPS = ("eq", "sb", "cb", "obs")
READS = dict({"fac_e_" + g: "planner.fac_e." + g for g in E_GROUPS},
             fac_d="planner.fac_d", fac_c="planner.fac_c",
             fac_minv="planner.fac_minv", rho="planner.rho", pos="pos",
             vel="vel", states_sol="planner.states_sol",
             first_time="planner.first_time",
             has_solution="planner.has_solution",
             last_ref_start="planner.last_ref_start")
NUMBERS = ("factor_minv_rel", "factor_scale_rel")


def _factor(c):
    """The factor in force in c.prec (None on the fused path), for the
    plan stage."""
    if c.cfg["planner"]["solver"]["fused_solve"]:
        fac = None
    else:
        st = c.at_refresh
        qps = refc.assemble(c.cfg, c.ref, st, c.obstacles(st, c.refresh))["qps"]
        fac = refc.factor(c.cfg, qps, st["rho"], c.prec)
    c.out["factor"] = fac
    return fac


def gaps(c, prog: dict) -> dict:
    fac = _factor(c)
    if fac is None or "fac_minv" not in prog:
        return {}
    e = torch.cat([prog["fac_e_" + g].flatten(1) for g in E_GROUPS], dim=1)
    return {"factor_minv_rel": check.rel(prog["fac_minv"], fac[3]).tolist(),
            "factor_scale_rel": torch.stack(
                [check.rel(prog["fac_d"], fac[0]), check.rel(e, fac[1]),
                 check.rel(prog["fac_c"][:, None], fac[2][:, None])]).amax(0).tolist()}


def control(c) -> dict:
    fac = _factor(c)
    if fac is None:
        return {}
    sizes = [c.st["fac_e_" + g].flatten(1).shape[1] for g in E_GROUPS]
    out = {"planner.fac_e." + g: e
           for g, e in zip(E_GROUPS, torch.split(fac[1], sizes, dim=1))}
    out.update({"planner.fac_d": fac[0], "planner.fac_c": fac[2],
                "planner.fac_minv": fac[3]})
    return out
