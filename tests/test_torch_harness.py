"""Port parity: intent_mpc_torch.benchmark.harness (run_trials, its rows,
aggregate and the CLI) against the JAX package's harness, at the small
config of tests/test_checkpoint.py; and the host side of
benchmark/bench.py --latency / --load."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from intent_mpc_tpu.benchmark import harness as JH
from intent_mpc_tpu.utils.config import small_config as jsmall_config
from intent_mpc_torch.benchmark import analyze as A
from intent_mpc_torch.benchmark import bench
from intent_mpc_torch.benchmark import harness as H
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import small_config

torch.set_num_threads(1)

SEEDS = [1, 2]


def _small(make, fused=False):
    """tests/test_checkpoint.py's harness config (15 cycles, 6 obstacles),
    from either package's small_config."""
    cfg = make(num_obstacles=6, horizon=10, timeout=1.5, max_obstacles=6,
               hist=12).replace(goal=(8.0, 0.0, 2.0))
    if fused:
        cfg = cfg.replace(planner=dataclasses.replace(
            cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                    fused_solve=True)))
    return cfg


@pytest.fixture(scope="module", params=["default", "fused"])
def both_rows(request):
    """Rows of both harnesses on the same seeds, default and fused path."""
    fused = request.param == "fused"
    jrows = JH.run_trials(_small(jsmall_config, fused), SEEDS,
                          solver_iters=30)
    trows = H.run_trials(_small(small_config, fused), SEEDS, solver_iters=30,
                         device="cpu")
    return jrows, trows


def test_rows_match_jax(both_rows):
    """Same 28 keys in the same order; bools and ints exact; floats to
    rtol 1e-3 (the per-cycle 1e-4 m of test_torch_closed_loop.py over 15
    cycles: the largest relative difference read here is ~1.5e-5, in
    mpc_prim_res_avg and jerk_rms)."""
    jrows, trows = both_rows
    assert len(trows) == len(jrows) == len(SEEDS)
    for jr, tr in zip(jrows, trows):
        assert list(tr.keys()) == list(jr.keys())
        assert len(tr) == 28
        for k, v in jr.items():
            assert type(tr[k]) is type(v), k
            if isinstance(v, float):
                np.testing.assert_allclose(tr[k], v, rtol=1e-3, err_msg=k)
            else:
                assert tr[k] == v, (k, tr[k], v)


def test_aggregate_matches_jax(both_rows):
    """aggregate is host arithmetic on the rows: on the same rows both
    packages give the same dict, exactly."""
    jrows, trows = both_rows
    for rows in (jrows, trows):
        assert H.aggregate(rows) == JH.aggregate(rows)
    assert H.aggregate([]) == {} and len(H.aggregate(trows)) == 14


# the solver options the port ran last (the TPU-tuned ones); the CLI has
# no flag for them, so the test sets them in the config the flags describe
UNPORTED = {"woodbury_candidates": dict(woodbury_candidates=True),
            "block_refine": dict(block_refine=True),
            "folded_refine": dict(folded_refine=True),
            "minv_dtype": dict(minv_dtype="bf16"),
            "shared_refine_warm_frac": dict(shared_refine_warm_frac=0.5)}


def _with_option(cfg, **kw):
    """cfg with one solver, planner or engine field set."""
    (k, v), = kw.items()
    if k in cfg.engine.__dataclass_fields__:
        return cfg.replace(engine=dataclasses.replace(cfg.engine, **kw))
    if k in cfg.planner.__dataclass_fields__:
        return cfg.replace(planner=dataclasses.replace(cfg.planner, **kw))
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver, **kw)))


@pytest.mark.parametrize("flags", list(UNPORTED))
def test_cli_refuses_unported_flags_before_any_work(flags, monkeypatch,
                                                    tmp_path):
    """Every solver option runs now, so the CLI refuses none of them: a
    config naming one reaches the scenario build (the stub that stands
    for the work) on the default and the fused path. A value that names
    no mode is still refused before any work (ValueError)."""
    def no_work(*a, **k):
        raise AssertionError("work started")
    build = H.config_from_args
    monkeypatch.setattr(H.sh, "stack_scenarios", no_work)
    monkeypatch.setattr(H, "config_from_args",
                        lambda args: _with_option(build(args),
                                                  **UNPORTED[flags]))
    for extra in ([], ["--fused"]):
        with pytest.raises(AssertionError, match="work started"):
            H.main(["--device", "cpu", "--trials", "1", "--out",
                    str(tmp_path)] + extra)
    monkeypatch.setattr(H, "config_from_args",
                        lambda args: _with_option(
                            _with_option(build(args), **UNPORTED[flags]),
                            shared_refine_mode="jacobi"))
    with pytest.raises(ValueError, match="shared_refine_mode"):
        H.main(["--device", "cpu", "--trials", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def _goal_config(mode):
    """The harness's DYNUS config at a small map in goal mode."""
    cfg = H.config_from_args(H.parse_args(
        ["--timeout", "0.3", "--obstacles", "6", "--max-obstacles", "6",
         "--iters", "30"]))
    return cfg.replace(engine=dataclasses.replace(cfg.engine, goal_mode=True,
                                                  ref_mode=mode))


def test_run_trials_flies_goal_mode_linspace():
    """The harness runs goal mode with the straight input trajectory: one
    trial of 3 cycles on the CPU writes its row with 3 solves and no
    stop+replan on the open map."""
    rows = H.run_trials(_goal_config("linspace"), [0], device="cpu")
    assert len(rows) == 1 and rows[0]["mpc_solve_count"] == 3
    assert rows[0]["mpc_solve_successes"] == 3


@pytest.mark.parametrize("mode", ["minsnap", "global"])
def test_checkpointed_harness_needs_ref_len_in_composed_goal_mode(
        mode, tmp_path):
    """A composed ref_mode reaches init_carry without the input-trajectory
    allocation on the checkpointed path, as in the JAX harness (whose
    run_trials_checkpointed builds its carries the same way): the same
    ValueError as JAX's init_carry, before any cycle or file."""
    from intent_mpc_tpu.models.world import generate_scenario
    from intent_mpc_tpu.utils.config import IntentMPCConfig as JConfig
    from intent_mpc_tpu.engine import closed_loop as jcl
    jcfg = JConfig()
    jcfg = jcfg.replace(engine=dataclasses.replace(
        jcfg.engine, goal_mode=True, ref_mode=mode))
    with pytest.raises(ValueError) as je:
        jcl.init_carry(jcfg, generate_scenario(0, jcfg.world))
    with pytest.raises(ValueError) as te:
        H.run_trials_checkpointed(_goal_config(mode), [0],
                                  str(tmp_path / "c.npz"), device="cpu")
    assert str(te.value) == str(je.value)
    assert not os.listdir(tmp_path)


# the loop-option flags and the config field each sets (as the JAX CLI)
LOOP_FLAGS = {
    "--goal-relax": (["--goal-relax"], "engine", "goal_relax", True),
    "--predictor-stale": (["--predictor-stale"], "engine",
                          "predictor_stale_hist", True),
    "--plant quadrotor": (["--plant", "quadrotor"], "engine", "plant",
                          "quadrotor"),
    "--drift-refresh": (["--drift-refresh", "0.1"], "solver",
                        "factor_drift_refresh", 0.1),
    "--flat-iter": (["--flat-iter"], "solver", "flat_iter", True),
    "--refine-mode stationary": (["--refine-mode", "stationary"], "solver",
                                 "shared_refine_mode", "stationary"),
}


@pytest.mark.parametrize("case", list(LOOP_FLAGS))
def test_cli_runs_loop_option_flags(case, tmp_path):
    """Each loop-option flag sets the config field the JAX CLI sets and
    runs: one trial of 3 cycles on the CPU at a small map writes its row,
    with 3 solves."""
    flags, where, field, value = LOOP_FLAGS[case]
    cfg = H.config_from_args(H.parse_args(["--out", str(tmp_path)] + flags))
    obj = cfg.engine if where == "engine" else cfg.planner.solver
    assert getattr(obj, field) == value
    agg = H.main(["--device", "cpu", "--trials", "1", "--timeout", "0.3",
                  "--obstacles", "6", "--max-obstacles", "6", "--iters",
                  "30", "--out", str(tmp_path)] + flags)
    assert agg["num_trials"] == 1
    rows = A.load_rows(str(tmp_path / "trials.csv"))
    assert rows[0]["mpc_solve_count"] == 3


@pytest.mark.parametrize("flags", [["--per-candidate-factor"],
                                   ["--truncation", "osqp"]],
                         ids=lambda f: " ".join(f))
def test_cli_runs_ported_solver_flags(flags, tmp_path):
    """--per-candidate-factor and --truncation osqp set the solver options
    the JAX CLI sets and run: one trial of 3 cycles on the CPU at a small
    map writes its row, with 3 solves."""
    args = H.parse_args(["--trials", "1", "--out", str(tmp_path)] + flags)
    sv = H.config_from_args(args).planner.solver
    assert (sv.shared_factor, sv.truncation) == (
        ("--per-candidate-factor" not in flags),
        ("osqp" if "osqp" in flags else "fixed"))
    agg = H.main(["--device", "cpu", "--trials", "1", "--timeout", "0.3",
                  "--obstacles", "6", "--max-obstacles", "6", "--iters",
                  "30", "--out", str(tmp_path)] + flags)
    assert agg["num_trials"] == 1
    rows = A.load_rows(str(tmp_path / "trials.csv"))
    assert rows[0]["mpc_solve_count"] == 3


def test_cli_writes_trials_and_summary(tmp_path, capsys):
    """--device cpu --trials 1 --timeout 0.3 at the full DYNUS config:
    both files, JAX's header, the aggregate printed as JSON."""
    out = tmp_path / "out"
    agg = H.main(["--device", "cpu", "--trials", "1", "--timeout", "0.3",
                  "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == agg and agg["num_trials"] == 1 and "wall_time_s" in agg
    with open(out / "summary.json") as f:
        assert json.load(f) == agg
    with open(out / "trials.csv") as f:
        header = f.readline().strip().split(",")
    assert header[:4] == ["trial_id", "seed", "num_obstacles",
                          "dynamic_ratio"] and len(header) == 28


def test_cli_checkpoint_flags(tmp_path):
    """--checkpoint writes the fleet file; --chunk-cycles without it is an
    argument error (it is only the checkpoint period here)."""
    ck = tmp_path / "fleet"
    H.main(["--device", "cpu", "--trials", "1", "--timeout", "0.2",
            "--obstacles", "6", "--max-obstacles", "6", "--iters", "10",
            "--checkpoint", str(ck), "--chunk-cycles", "1",
            "--out", str(tmp_path / "out")])
    assert os.path.exists(str(ck) + ".npz")
    with pytest.raises(SystemExit):
        H.parse_args(["--chunk-cycles", "5"])


def test_cli_defaults_to_the_card(tmp_path):
    """With no --device the CLI runs on CUDA; without a card it raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.main(["--trials", "1", "--timeout", "0.1", "--out", str(tmp_path)])


def test_blocking_cycles_fetch_each_cycles_command():
    """bench --latency's blocking pattern: cycle i's fetched command is
    that cycle's pos and vel, on the host (the pipelined pattern needs
    pinned memory and CUDA events: a card test holds it to this one)."""
    cfg = _small(small_config)
    scen = sh.stack_scenarios(cfg, SEEDS, device="cpu")
    step = bench.command_step(cfg, scen, iters=10)
    carry = cl.init_carry(cfg, scen, device="cpu")
    out, secs, cmds = bench.blocking_cycles(step, carry, range(3))
    assert len(secs) == len(cmds) == 3 and all(s > 0 for s in secs)
    for i in range(3):
        carry, cmd = step(carry, i)
        assert torch.equal(cmds[i], torch.cat([carry.pos, carry.vel], -1))
    assert cmds[-1].shape == (2, 6) and torch.equal(out.pos, carry.pos)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.latency(2, cycles=1, device="cpu")


def test_load_burners_start_and_stop():
    """--load N: N spawned busy-loop processes that stop when told to."""
    procs = bench.start_burners(2)
    try:
        assert len(procs) == 2 and all(p.is_alive() for p in procs)
    finally:
        bench.stop_burners(procs)
    assert not any(p.is_alive() for p in procs)
    assert bench.start_burners(0) == []


def test_bench_solver_flags_set_the_jax_bench_fields():
    """bench.py's solver-variant flags set the SolverConfig fields JAX's
    bench.py sets (its main, :98-132), on the port's bench config."""
    args = bench.parse_args(["--refine", "3", "--refine-mode", "stationary",
                             "--refine-x0", "minv", "--factor-reuse", "2",
                             "--drift-refresh", "0.1", "--flat-iter",
                             "--per-candidate-factor", "--fused"])
    sv = bench.bench_config(args.obstacles, args.fused,
                            bench.solver_fields(args)).planner.solver
    assert (sv.shared_refine_iters, sv.shared_refine_mode,
            sv.shared_refine_x0, sv.factor_reuse_cycles,
            sv.factor_drift_refresh, sv.flat_iter, sv.shared_factor,
            sv.fused_solve) == (3, "stationary", "minv", 2, 0.1, True,
                                False, True)
    plain = bench.bench_config(solver=bench.solver_fields(
        bench.parse_args([]))).planner.solver
    assert plain == bench.bench_config().planner.solver
