"""Carry state between numpy trees and the port's tensor tuples.

The system has no weights: its state is the scenario, the reference
trajectory and the engine carry. These functions read any object with
the port's field names whose leaves are numpy arrays (for example the
JAX package's NamedTuples after mapping `np.asarray` over them; fields
the port does not carry are ignored) and build the port's NamedTuples
on a device, so that both implementations can start from identical
state, including the carried shared factor and the real detector's
track table; `grid_from_numpy` carries static occupancy maps. `fleet_problem_from_lanes`
and `fleet_outputs_to_lanes` carry the fleet solve's packed problem and
its outputs between the TPU lane layout and the port's layout;
`dense_problem_from_numpy` carries the dense-A path's problem.
`map_from_numpy` and `octo_from_numpy` carry log-odds maps and octree
pyramids, `roadmap_from_numpy` the exploration planner's persistent
roadmap, and `yolo_state_dict` turns the person detector's parameters in
the JAX package's layout into the port module's state_dict.
"""

from __future__ import annotations

import numpy as np
import torch

from intent_mpc_torch.engine.closed_loop import EngineCarry, Metrics
from intent_mpc_torch.models.dep import RoadmapState
from intent_mpc_torch.models.controller import ControllerState
from intent_mpc_torch.models.detector import DetectorState
from intent_mpc_torch.models.mapping import LogOddsMap
from intent_mpc_torch.models.mpc import PlannerState
from intent_mpc_torch.models.occupancy import OccupancyGrid
from intent_mpc_torch.models.octo import OctoMap
from intent_mpc_torch.models.perception import Tracks
from intent_mpc_torch.models.quad_plant import PIDState, QuadState
from intent_mpc_torch.models.real_detector import (PerceptionStats,
                                                   RealDetectorState)
from intent_mpc_torch.models.world import Scenario
from intent_mpc_torch.ops.dense_loop import DenseScaledProblem
from intent_mpc_torch.ops.fleet import LANES, FleetProblem
from intent_mpc_torch.ops.qp import ConVec, QPData
from intent_mpc_torch.utils.device import resolve_device

# NamedTuple fields that hold another NamedTuple
_NESTED = {
    (EngineCarry, "detector"): DetectorState,
    (EngineCarry, "planner"): PlannerState,
    (EngineCarry, "controller"): ControllerState,
    (EngineCarry, "metrics"): Metrics,
    (EngineCarry, "quad"): QuadState,
    (EngineCarry, "real_det"): RealDetectorState,
    (RealDetectorState, "tracks"): Tracks,
    (RealDetectorState, "stats"): PerceptionStats,
    (PlannerState, "fac_e"): ConVec,
    (QPData, "l"): ConVec,
    (QPData, "u"): ConVec,
    **{(QuadState, f): PIDState for f in QuadState._fields
       if f.startswith("pid_")},
}


def _from(tree, typ, leaf):
    vals = {}
    for f in typ._fields:
        v = getattr(tree, f, None)
        if v is None:
            vals[f] = None
            continue
        sub = _NESTED.get((typ, f))
        vals[f] = _from(v, sub, leaf) if sub is not None else leaf(v)
    return typ(**vals)


def _to_tensor(device, add_batch_axis):
    def leaf(v):
        t = torch.as_tensor(np.array(v, copy=True), device=device)
        return t[None] if add_batch_axis else t
    return leaf


def from_numpy(tree, typ, device="cpu", add_batch_axis=False):
    """Any of the port's NamedTuples (EngineCarry, PlannerState, QPData,
    ConVec, ...) from an object with its field names and numpy leaves."""
    return _from(tree, typ, _to_tensor(device, add_batch_axis))


def scenario_from_numpy(tree, device="cpu", add_batch_axis=False) -> Scenario:
    """A Scenario from numpy leaves (origin, scale, offset, slower, bbox,
    is_static)."""
    return _from(tree, Scenario, _to_tensor(device, add_batch_axis))


def carry_from_numpy(tree, device="cpu", add_batch_axis=False) -> EngineCarry:
    """The port's EngineCarry from numpy leaves. The engine steps a
    scenario batch, so a carry of one scenario needs add_batch_axis=True;
    a batched carry (leading axis S on every leaf) converts as it is."""
    return _from(tree, EngineCarry, _to_tensor(device, add_batch_axis))


def grid_from_numpy(grids, device="cpu") -> OccupancyGrid:
    """A per-scenario OccupancyGrid (S, nx, ny, nz) from S grids with numpy
    leaves of one shape, origin and resolution (such as the JAX package's
    `static_grid_for` of each seed); one grid gives S = 1."""
    if hasattr(grids, "grid"):
        grids = [grids]
    origin = np.array(grids[0].origin, np.float32)
    res = np.array(grids[0].resolution, np.float32)
    for g in grids[1:]:
        if (not np.array_equal(np.asarray(g.origin), origin)
                or np.asarray(g.resolution) != res):
            raise ValueError("grids of one origin and resolution only")
    return OccupancyGrid(
        grid=torch.as_tensor(np.stack([np.asarray(g.grid) for g in grids]),
                             device=device),
        origin=torch.as_tensor(origin, device=device),
        resolution=torch.as_tensor(res, device=device))


def carry_to_numpy(carry: EngineCarry) -> EngineCarry:
    """The same NamedTuple structure with numpy leaves on the host."""
    return _from(carry, EngineCarry, lambda t: t.detach().cpu().numpy())


def _from_lanes(a: np.ndarray) -> np.ndarray:
    """(rows..., 8 S) -> (S, 8, rows...)."""
    a = np.asarray(a)
    a = a.reshape(a.shape[:-1] + (a.shape[-1] // LANES, LANES))
    return np.moveaxis(np.moveaxis(a, -2, 0), -1, 1)


def _to_lanes(a: np.ndarray) -> np.ndarray:
    """(S, 8, rows...) -> (rows..., 8 S)."""
    a = np.moveaxis(np.moveaxis(np.asarray(a), 1, -1), 0, -2)
    return a.reshape(a.shape[:-2] + (-1,))


def fleet_problem_from_lanes(tree, device="cpu") -> FleetProblem:
    """The port's FleetProblem from one in the TPU lane layout (problems on
    the last axis, P = 8 S: (rows, P) and (W, K, P) leaves; a_ext and minv
    as they are), given with numpy leaves, such as the JAX package's
    pack_fleet output after mapping np.asarray over it."""
    def leaf(f):
        v = np.asarray(getattr(tree, f))
        if f not in ("a_ext", "minv"):
            v = _from_lanes(v)
        return torch.as_tensor(np.array(v, order="C"), device=device)
    return FleetProblem(*(leaf(f) for f in FleetProblem._fields))


def fleet_outputs_to_lanes(*outs):
    """The fleet solve's outputs ((S, 8, rows) and (S, 8, W, K) tensors) as
    numpy arrays in the TPU lane layout ((rows, P) and (W, K, P))."""
    return tuple(_to_lanes(t.detach().cpu().numpy()) for t in outs)


def dense_problem_from_numpy(tree, device="cpu") -> DenseScaledProblem:
    """The port's DenseScaledProblem from one with numpy leaves and the
    JAX package's (C, rows, 1) vector columns, such as
    `_dense_scaled_problem`'s output after mapping np.asarray over it: the
    trailing column of q, x0, rho, lo and hi is dropped."""
    def leaf(f):
        v = np.asarray(getattr(tree, f))
        if f not in ("minv", "mmat", "amat"):
            v = v[..., 0]
        return torch.as_tensor(np.array(v, order="C"), device=device)
    return DenseScaledProblem(*(leaf(f) for f in DenseScaledProblem._fields))


def _same_frame(trees):
    """A list of trees from one tree or a list, and the first's origin and
    resolution, which every tree must share."""
    if hasattr(trees, "origin"):
        trees = [trees]
    origin = np.array(trees[0].origin, np.float32)
    res = np.float32(trees[0].resolution)
    for t in trees[1:]:
        if (not np.array_equal(np.asarray(t.origin), origin)
                or np.float32(t.resolution) != res):
            raise ValueError("maps of one origin and resolution only")
    return trees, origin, float(res)


def map_from_numpy(maps, device="cpu") -> LogOddsMap:
    """The port's LogOddsMap (S, nx, ny, nz) from S maps with numpy leaves
    (log_odds (nx, ny, nz), origin, resolution), such as the JAX package's
    LogOddsMap after mapping np.asarray over it; one map gives S = 1."""
    maps, origin, res = _same_frame(maps)
    return LogOddsMap(
        log_odds=torch.as_tensor(np.stack([np.asarray(m.log_odds, np.float32)
                                           for m in maps]), device=device),
        origin=torch.as_tensor(origin, device=device), resolution=res)


def octo_from_numpy(octos, device="cpu") -> OctoMap:
    """The port's OctoMap (levels (S, ...)) from S octree pyramids with
    numpy leaves of one shape, origin, resolution and ignore_unknown, such
    as the JAX package's OctoMap after mapping np.asarray over its arrays."""
    octos, origin, res = _same_frame(octos)

    def levels(field):
        n = len(getattr(octos[0], field))
        return tuple(torch.as_tensor(np.stack([np.asarray(getattr(o, field)[l])
                                               for o in octos]),
                                     device=device) for l in range(n))
    return OctoMap(levels_occ=levels("levels_occ"),
                   levels_unk=levels("levels_unk"),
                   origin=torch.as_tensor(origin, device=device),
                   resolution=res,
                   ignore_unknown=bool(octos[0].ignore_unknown))


def roadmap_from_numpy(tree, device=None) -> RoadmapState:
    """The port's RoadmapState (S, N, ...) from a roadmap with numpy leaves
    (pos, valid, gain, yaw_gain), such as the JAX package's RoadmapState
    after mapping np.asarray over it; a roadmap without the scenario axis
    (pos (N, 3)) gives S = 1. On the card unless `device` names another."""
    dev = resolve_device(device)
    one = np.ndim(tree.pos) == 2
    return RoadmapState(*(
        torch.as_tensor(np.array(getattr(tree, f))[None] if one
                        else np.array(getattr(tree, f)), device=dev)
        for f in RoadmapState._fields))


def yolo_state_dict(params) -> dict:
    """The port's FastestDet state_dict from the person detector's
    parameters in the JAX package's layout (the reference checkpoint's key
    names with numpy values, num_batches_tracked dropped, as
    params_from_torch_state_dict makes them): each batch norm gets its
    num_batches_tracked back as 0 (eval mode does not read it)."""
    sd = {}
    for k, v in params.items():
        sd[k] = torch.as_tensor(np.array(v, np.float32, copy=True))
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return sd
