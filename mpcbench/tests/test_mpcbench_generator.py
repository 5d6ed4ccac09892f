"""The benchmark's frozen copy of the DYNUS world generator gives the
program's worlds, seed for seed, and the same run seed the same inputs."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from mpcbench import generator as gen


@pytest.mark.parametrize("seed", [0, 5, 123456, 2 ** 31 + 7, 2 ** 32 - 1])
def test_worlds_equal_the_programs(seed):
    from intent_mpc_torch.models.world import generate_scenario_numpy
    from intent_mpc_torch.utils.config import WorldConfig
    wc = WorldConfig()
    w = {f.name: getattr(wc, f.name) for f in dataclasses.fields(wc)}
    ours = gen.worlds([seed, seed + 1], w)
    for j, s in enumerate((seed, seed + 1)):
        ref = generate_scenario_numpy(s % 2 ** 32, wc)
        for k in ref:
            assert np.array_equal(ours[k][j], ref[k]), k


def test_same_seed_same_inputs():
    import json
    import os
    from mpcbench_cells import ROOT
    cfg = json.load(open(os.path.join(ROOT, "mpcbench/configs/dynus200-fused.json")))
    tr = json.load(open(os.path.join(ROOT, "mpcbench/traffic/rt32.json")))
    a, ra = gen.make(cfg, tr, 2 ** 31 + 99)
    b, rb = gen.make(cfg, tr, 2 ** 31 + 99)
    c, _ = gen.make(cfg, tr, 2 ** 31 + 98)
    assert len(a) == tr["blocks"] and a[0]["origin"].shape == (32, 200, 3)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert np.array_equal(ra, rb)
    assert not np.array_equal(a[0]["origin"], c[0]["origin"])
    assert not np.array_equal(a[0]["origin"], a[1]["origin"])
