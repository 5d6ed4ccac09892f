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


UNPORTED = [["--goal-relax"], ["--predictor-stale"], ["--plant", "quadrotor"],
            ["--drift-refresh", "0.1"], ["--flat-iter"],
            ["--refine-mode", "stationary"], ["--per-candidate-factor"],
            ["--truncation", "osqp"], ["--fused", "--flat-iter"]]


@pytest.mark.parametrize("flags", UNPORTED, ids=lambda f: " ".join(f))
def test_cli_refuses_unported_flags_before_any_work(flags, monkeypatch,
                                                    tmp_path):
    """Each flag that names an option the port does not run parses, then
    raises NotImplementedError before a scenario is built; with --fused
    too, where the fleet solve would not read the option."""
    def no_work(*a, **k):
        raise AssertionError("work started")
    monkeypatch.setattr(H.sh, "stack_scenarios", no_work)
    with pytest.raises(NotImplementedError):
        H.main(["--device", "cpu", "--trials", "1", "--out",
                str(tmp_path)] + flags)
    assert not os.listdir(tmp_path)


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
