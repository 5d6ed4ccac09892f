"""Carry state between numpy trees and the port's tensor tuples.

The system has no weights: its state is the scenario, the reference
trajectory and the engine carry. These functions read any object with
the port's field names whose leaves are numpy arrays (for example the
JAX package's NamedTuples after mapping `np.asarray` over them; fields
the port does not carry are ignored) and build the port's NamedTuples
on a device, so that both implementations can start from identical
state, including the carried shared factor. `fleet_problem_from_lanes`
and `fleet_outputs_to_lanes` carry the fleet solve's packed problem and
its outputs between the TPU lane layout and the port's layout;
`dense_problem_from_numpy` carries the dense-A path's problem.
"""

from __future__ import annotations

import numpy as np
import torch

from intent_mpc_torch.engine.closed_loop import EngineCarry, Metrics
from intent_mpc_torch.models.controller import ControllerState
from intent_mpc_torch.models.detector import DetectorState
from intent_mpc_torch.models.mpc import PlannerState
from intent_mpc_torch.models.world import Scenario
from intent_mpc_torch.ops.dense_loop import DenseScaledProblem
from intent_mpc_torch.ops.fleet import LANES, FleetProblem
from intent_mpc_torch.ops.qp import ConVec, QPData

# NamedTuple fields that hold another NamedTuple
_NESTED = {
    (EngineCarry, "detector"): DetectorState,
    (EngineCarry, "planner"): PlannerState,
    (EngineCarry, "controller"): ControllerState,
    (EngineCarry, "metrics"): Metrics,
    (PlannerState, "fac_e"): ConVec,
    (QPData, "l"): ConVec,
    (QPData, "u"): ConVec,
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
