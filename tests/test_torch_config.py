"""The port's copy of the configuration (intent_mpc_torch/utils/config.py)
against the JAX package's: both dataclass trees of IntentMPCConfig() and of
small_config() walked field by field, names, nesting and defaults. The
one allowed difference is SolverConfig.ew_kernel, the port's own default
(the elementwise kernel is on by default on the card)."""

import dataclasses

import pytest

from intent_mpc_tpu.utils import config as jconfig
from intent_mpc_torch.utils import config as tconfig

ALLOWED = {("planner", "solver", "ew_kernel")}


def _walk(j, t, path=()):
    """Every (path, JAX value, port value) pair that differs, and every
    field present in only one tree."""
    if dataclasses.is_dataclass(j) or dataclasses.is_dataclass(t):
        assert dataclasses.is_dataclass(j) and dataclasses.is_dataclass(t), path
        assert type(j).__name__ == type(t).__name__, path
        jf = [f.name for f in dataclasses.fields(j)]
        tf = [f.name for f in dataclasses.fields(t)]
        assert jf == tf, (path, sorted(set(jf) ^ set(tf)))
        out = []
        for name in jf:
            out += _walk(getattr(j, name), getattr(t, name), path + (name,))
        return out
    return [] if j == t else [(path, j, t)]


@pytest.mark.parametrize("make", ["IntentMPCConfig", "small_config"])
def test_config_trees_equal_but_for_ew_kernel(make):
    diffs = _walk(getattr(jconfig, make)(), getattr(tconfig, make)())
    assert {d[0] for d in diffs} == ALLOWED, diffs
    (_, jv, tv), = diffs
    assert (jv, tv) == (False, True)
