"""The PyTorch port stands alone: no module of intent_mpc_torch, and not
chip_smoke.py, imports jax, jaxlib or the JAX package, and the entry
points run on the GPU unless told otherwise."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "intent_mpc_tpu")
# the real-perception, goal-mode, exploration and tools slices' modules,
# which both checks must reach
SLICE_MODULES = ("models.clustering", "models.sensor", "models.perception",
                   "models.real_detector", "benchmark.real_loop",
                   "utils.prng", "models.global_planner", "models.pwl_traj",
                   "ops.dense_admm", "models.poly_traj",
                   "models.poly_planner", "engine.ref_builder",
                   "benchmark.ref_modes", "models.exploration",
                   "models.dep", "models.bspline_traj",
                   "models.time_optimizer", "models.traj_divider",
                   "utils.grid", "entry", "utils.yaml_config",
                   "benchmark.roofline", "benchmark.stage_profile",
                   "benchmark.viz", "benchmark.demo",
                   "benchmark.oracle_loop", "benchmark.native_loop",
                   "oracle.native", "oracle.osqp_ref",
                   "parallel.sharding", "parallel.launch",
                   "benchmark.scaling")

torch.set_num_threads(1)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "intent_mpc_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_no_jax_imports_in_port_sources():
    files = _port_files()
    assert len(files) > 15
    for m in SLICE_MODULES:
        assert os.path.join(ROOT, "intent_mpc_torch",
                            *m.split(".")) + ".py" in files, m
    bad = [(os.path.relpath(p, ROOT), n) for p in files for n in _imported(p)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_port_loads_no_jax():
    """Every module of the package, imported in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import intent_mpc_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert len(mods) > 15, mods\n"
        "missing = [m for m in %r if 'intent_mpc_torch.' + m not in mods]\n"
        "assert not missing, missing\n"
        "assert not bad, bad\n" % (FORBIDDEN, SLICE_MODULES))
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def _entry_calls(tmp_path):
    from intent_mpc_torch import entry
    from intent_mpc_torch.benchmark import (demo, harness, oracle_loop,
                                            real_loop, ref_modes, roofline,
                                            scaling, stage_profile)
    from intent_mpc_torch.engine import checkpoint, closed_loop as cl
    from intent_mpc_torch.models.world import (load_ref_traj,
                                               straight_line_ref_traj)
    from intent_mpc_torch.parallel import sharding as sh
    from intent_mpc_torch.utils.config import small_config
    cfg = small_config(num_obstacles=2, horizon=4)
    scen = sh.stack_scenarios(cfg, [0], device="cpu")
    ref = straight_line_ref_traj(cfg.start, cfg.goal)
    return {
        "init_carry": lambda: cl.init_carry(cfg, scen),
        "run_episode": lambda: cl.run_episode(cfg, scen, ref, ref.shape[0],
                                              num_cycles=1),
        "stack_scenarios": lambda: sh.stack_scenarios(cfg, [0]),
        "batch_rollout": lambda: sh.batch_rollout(cfg, scen, ref,
                                                  ref.shape[0], num_cycles=1),
        "run_trials": lambda: harness.run_trials(cfg, [0], num_cycles=1),
        "run_trials_checkpointed": lambda: harness.run_trials_checkpointed(
            cfg, [0], str(tmp_path / "c.npz")),
        "load_checkpoint": lambda: checkpoint.load_checkpoint(
            str(tmp_path / "c.npz"), cfg),
        "load_ref_traj": lambda: load_ref_traj(str(tmp_path / "ref.txt")),
        "real_loop": lambda: real_loop.main(["--seeds", "0", "--out",
                                             str(tmp_path / "rl")]),
        "ref_modes": lambda: ref_modes.run(ref_modes.parse_args(
            ["--seeds", "0", "--out", str(tmp_path / "rm")])),
        "entry": lambda: entry.entry(),
        "stage_profile": lambda: stage_profile.profile_stages(cfg, 1, 1, 1),
        "roofline": lambda: roofline.analyze(cfg, 1, 1),
        "demo": lambda: demo.run_demo(out=str(tmp_path / "demo")),
        "oracle_loop": lambda: oracle_loop.main(
            ["--seeds", "0", "--out", str(tmp_path / "ol")]),
        "run_divergence": lambda: oracle_loop.run_divergence(cfg, 0, None),
        "make_mesh": lambda: sh.make_mesh(),
        "dryrun_multichip": lambda: entry.dryrun_multichip(1),
        "run_study": lambda: scaling.run_study([1]),
    }


@pytest.mark.parametrize("entry", ["init_carry", "run_episode",
                                   "stack_scenarios", "batch_rollout",
                                   "run_trials", "run_trials_checkpointed",
                                   "load_checkpoint", "load_ref_traj",
                                   "real_loop", "ref_modes", "entry",
                                   "stage_profile", "roofline", "demo",
                                   "oracle_loop", "run_divergence",
                                   "make_mesh", "dryrun_multichip",
                                   "run_study"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Without a device argument an entry point runs on CUDA; with no CUDA
    device it raises instead of falling back to the CPU (before it reads
    or writes any file)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_calls(tmp_path)[entry]()
    assert not os.listdir(tmp_path)
