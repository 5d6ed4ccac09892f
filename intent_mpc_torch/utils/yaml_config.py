"""YAML config loading: the reference's per-module yaml surface (the
port's copy of the JAX package's loader, on the port's config tree).

The reference loads ROS params from autonomous_flight/cfg/mpc_navigation/
*.yaml with per-key defaulting (the `[hint]` echo pattern, e.g.
mpcPlanner.cpp:19-172). Here the same keys map onto the frozen dataclass
tree: unknown keys raise (no silent typos), missing keys keep dataclass
defaults — which are themselves the reference yaml values.

Supported layout (one file, sections optional):

    planner:   {horizon: 30, y_range: [-5, 5], ...}
    predictor: {num_pred: 30, ...}
    detector:  {history_size: 100, ...}
    real_detector: {im_h: 64, max_tracks: 8, ...}  # dynamic_detector_param
    world:     {num_obstacles: 200, ...}
    engine:    {timeout: 100.0, ...}
    control:   {position_p: [2, 2, 1.8], ...}
    solver:    {max_iter: 100, ...}      # nested under planner.solver
    start: [0, 0, 2]
    goal: [105, 0, 2]
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from intent_mpc_torch.utils.config import IntentMPCConfig


def _replace_section(obj, updates: Mapping[str, Any]):
    fields = {f.name for f in dataclasses.fields(obj)}
    bad = set(updates) - fields
    if bad:
        raise KeyError(f"unknown config keys for {type(obj).__name__}: "
                       f"{sorted(bad)}")
    coerced = {}
    for k, v in updates.items():
        cur = getattr(obj, k)
        if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            coerced[k] = tuple(v)
        else:
            coerced[k] = v
    return dataclasses.replace(obj, **coerced)


def from_dict(d: Mapping[str, Any],
              base: IntentMPCConfig | None = None) -> IntentMPCConfig:
    cfg = base or IntentMPCConfig()
    sections = dict(d)
    solver_upd = sections.pop("solver", None)
    out = {}
    for name in ("world", "detector", "real_detector", "predictor",
                 "planner", "control", "engine"):
        if name in sections:
            out[name] = _replace_section(getattr(cfg, name),
                                         sections.pop(name))
    for name in ("start", "goal"):
        if name in sections:
            out[name] = tuple(sections.pop(name))
    if sections:
        raise KeyError(f"unknown config sections: {sorted(sections)}")
    cfg = dataclasses.replace(cfg, **out)
    if solver_upd is not None:
        planner = dataclasses.replace(
            cfg.planner, solver=_replace_section(cfg.planner.solver,
                                                 solver_upd))
        cfg = dataclasses.replace(cfg, planner=planner)
    return cfg


def load_yaml(path: str,
              base: IntentMPCConfig | None = None) -> IntentMPCConfig:
    import yaml          # PyYAML: optional, so the package imports without it
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return from_dict(d, base)
