"""Port parity: the port's tools (entry.py, utils/yaml_config.py,
benchmark/roofline.py, stage_profile.py, viz.py, demo.py) against the
JAX package's.

Configs, the roofline model and the summary keys are held exactly; the
entry's cycle within 1e-4 m and m/s (float32 ADMM iterates that the two
packages round differently, as tests/test_torch_closed_loop.py holds its
cycles)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from intent_mpc_tpu.benchmark import roofline as jroof
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.utils import config as jconfig
from intent_mpc_tpu.utils import yaml_config as jyaml
from intent_mpc_torch import entry as tentry
from intent_mpc_torch.benchmark import demo, roofline, stage_profile, viz
from intent_mpc_torch.models.world import generate_scenario
from intent_mpc_torch.utils import config as tconfig
from intent_mpc_torch.utils import yaml_config as tyaml
from tests.test_torch_config import ALLOWED, _walk

torch.set_num_threads(1)

# tests/test_config_viz.py's dicts, and one per remaining section
DICTS = {
    "overrides": {"planner": {"horizon": 20, "y_range": [-3, 3]},
                  "solver": {"max_iter": 42},
                  "world": {"num_obstacles": 50}, "goal": [50, 0, 2]},
    "sections": {"predictor": {"num_pred": 12}, "detector":
                 {"history_size": 40}, "real_detector": {"max_tracks": 4},
                 "control": {"position_p": [1, 1, 1]},
                 "engine": {"timeout": 7.5}, "start": [1, 0, 2]},
    "empty": {},
}
BAD = [{"planner": {"horizzon": 30}}, {"plannner": {}},
       {"solver": {"max_iters": 3}}]


def _equal_trees(j, t):
    diffs = _walk(j, t)
    assert {d[0] for d in diffs} <= ALLOWED, diffs


@pytest.mark.parametrize("name", list(DICTS))
def test_from_dict_equals_jax(name):
    """Field for field equal to the JAX from_dict's tree (but for the
    port's own ew_kernel default), on the default base and on
    small_config()."""
    d = DICTS[name]
    _equal_trees(jyaml.from_dict(d), tyaml.from_dict(d))
    _equal_trees(jyaml.from_dict(d, jconfig.small_config()),
                 tyaml.from_dict(d, tconfig.small_config()))


@pytest.mark.parametrize("bad", BAD, ids=["key", "section", "solver_key"])
def test_from_dict_rejects_unknown_keys_as_jax(bad):
    with pytest.raises(KeyError) as je:
        jyaml.from_dict(bad)
    with pytest.raises(KeyError) as te:
        tyaml.from_dict(bad)
    assert str(te.value) == str(je.value)


def test_load_yaml_roundtrip(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("planner:\n  horizon: 12\n  y_range: [-4, 4]\n"
                 "engine:\n  timeout: 7.5\nsolver:\n  max_iter: 60\n")
    cfg = tyaml.load_yaml(str(p))
    assert cfg.planner.horizon == 12 and cfg.engine.timeout == 7.5
    assert cfg.planner.y_range == (-4, 4)
    assert cfg.planner.solver.max_iter == 60
    _equal_trees(jyaml.load_yaml(str(p)), cfg)


def test_entry_matches_jax():
    """entry("cpu")'s cycle against the JAX entry() jitted on the CPU:
    pos and vel within 1e-4 after one cycle (S = 1)."""
    jfn, jargs = __graft_entry__.entry()
    jpos, jvel = jax.jit(jfn)(*jargs)
    fn, args = tentry.entry("cpu")
    pos, vel = fn(*args)
    assert pos.shape == (1, 3) and vel.shape == (1, 3)
    np.testing.assert_allclose(pos[0].numpy(), np.asarray(jpos), atol=1e-4)
    np.testing.assert_allclose(vel[0].numpy(), np.asarray(jvel), atol=1e-4)
    assert float(pos[0, 0]) > 0.0           # the cycle flew toward the goal


@pytest.mark.parametrize("batch", [32, 128])
def test_cycle_model_equals_jax(batch):
    cfg = tconfig.IntentMPCConfig()
    iters = cfg.planner.solver.max_iter
    got = roofline.cycle_model(cfg, batch, iters)
    want = jroof.cycle_model(jconfig.IntentMPCConfig(), batch, iters)
    for k in got:
        assert got[k] == want[k], k


def test_roofline_peaks_and_devices():
    """The H100's float32 and HBM peaks; an unknown card raises with its
    name; the measurement refuses the CPU."""
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    with pytest.raises(KeyError, match="Some Card"):
        roofline.peaks("Some Card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline.analyze(tconfig.IntentMPCConfig(), 1, 1, device="cpu")


def test_profile_stages_prints_every_stage(capsys):
    """A small config, 1 rep on the CPU: every stage timed (finite, > 0),
    device-busy ms and launches not measured there."""
    cfg = tconfig.small_config(num_obstacles=4, horizon=8, max_obstacles=4,
                               hist=8)
    r = stage_profile.profile_stages(cfg, 2, 10, 1, "cpu")
    stage_profile.print_stages(r)
    names = [s["stage"] for s in r["stages"]]
    assert names == ["episode_step (full cycle)", "predictor",
                     "assembly (pred+QP build+scoring)",
                     "shared factor (structured)", "solve 10it, 3 refine",
                     "solve 10it, 0 refine", "solve 10it, 1 refine",
                     "refinement cost (3 vs 0)"]
    printed = capsys.readouterr().out
    for s in r["stages"]:
        assert s["stage"] in printed
        assert s["busy_ms"] is None and s["launches"] is None
        if s["stage"] != "refinement cost (3 vs 0)":
            assert np.isfinite(s["wall_ms"]) and s["wall_ms"] > 0.0


def test_plot_episode_writes_png(tmp_path):
    cfg = tconfig.small_config(num_obstacles=8)
    sc = generate_scenario(0, cfg.world)
    path = np.stack([np.linspace(0, 8, 30), np.zeros(30),
                     np.full(30, 2.0)], -1)
    out = str(tmp_path / "ep.png")
    viz.plot_episode(cfg, sc, path, out, title="test")
    assert os.path.exists(out) and os.path.getsize(out) > 10000


def test_run_demo_matches_jax(tmp_path):
    """run_demo on the __graft_entry__ config (4 obstacles, 4 s): the
    summary's keys in the JAX summarize's order, goal and collision equal
    to the JAX run_episode's for seed 0, and the metrics file written."""
    base = tentry.tiny_setup("cpu")[0]
    d = demo.run_demo(0, 4, 4.0, None, "cpu", str(tmp_path), base=base)
    jcfg = __graft_entry__._tiny_setup()[0]
    jcfg = jcfg.replace(engine=dataclasses.replace(jcfg.engine, timeout=4.0))
    jsc = jworld.generate_scenario(0, jcfg.world)
    jref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, spacing=2.5)
    jc, _ = jcl.run_episode(jcfg, jsc, jref, jnp.asarray(jref.shape[0]))
    want = jcl.summarize(jcfg, jc)
    assert list(d.row) == list(want)
    assert d.row["goal_reached"] == want["goal_reached"]
    assert d.row["collision"] == want["collision"]
    assert d.path.shape == (40, 3)
    assert os.path.exists(tmp_path / "metrics_seed0.json")
