"""Port parity: the torch.distributed fleet (intent_mpc_torch/parallel,
entry.dryrun_multichip, benchmark/scaling.py, the harness's fleet branch)
against the JAX package's mesh (parallel/sharding.py). The multi-rank
cases run gloo ranks on the CPU, each in its own interpreter
(parallel/launch.spawn: init_process_group runs once per process), as
tests/test_multihost.py runs its two JAX processes."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models.world import straight_line_ref_traj as jref_traj
from intent_mpc_tpu.parallel import sharding as jsh
from intent_mpc_tpu.utils.config import small_config as jsmall_config
from intent_mpc_torch import entry
from intent_mpc_torch.benchmark import harness as H
from intent_mpc_torch.benchmark import scaling
from intent_mpc_torch.models.world import Scenario, straight_line_ref_traj
from intent_mpc_torch.parallel import launch
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils import prng
from intent_mpc_torch.utils.config import small_config

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
SEEDS = list(range(16))     # the multihost protocol: 16 seeds of
ITERS, CYCLES = 20, 25      # small_config(num_obstacles=8), 20 iterations,
INVENTORY_CYCLES = 2        # 25 cycles; the inventory over 2 cycles


@pytest.fixture
def worker_path(monkeypatch):
    """Fleet ranks import their tasks from tests/torch_fleet_worker.py."""
    monkeypatch.setenv("PYTHONPATH", TESTS + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))


def _cpu_fleet(rank=0, world=1):
    return sh.Fleet(rank=rank, world=world, device=torch.device("cpu"),
                    group=None)


def test_one_process_fleet_is_bit_equal():
    """Without a process group make_mesh is the one-process fleet (no
    collective is issued), stack_scenarios_global is stack_scenarios,
    and batch_rollout(mesh=...) gives the plain call's per-scenario
    metrics and aggregate exactly (==). init_distributed() with no
    arguments initializes nothing; a fleet of 2 needs a group."""
    assert sh.init_distributed() == 0
    assert not torch.distributed.is_initialized()
    fleet = sh.make_mesh(None, device="cpu")
    assert fleet == _cpu_fleet()
    assert sh.make_mesh(1, device="cpu") == fleet
    with pytest.raises(ValueError, match="world size 1"):
        sh.make_mesh(2, device="cpu")
    cfg = small_config(num_obstacles=4)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5)
    scen = sh.stack_scenarios_global(cfg, [3, 4], fleet)
    plain_scen = sh.stack_scenarios(cfg, [3, 4], device="cpu")
    for a, b in zip(scen, plain_scen):
        assert torch.equal(a, b)
    m, agg = sh.batch_rollout(cfg, scen, ref, ref.shape[0], mesh=fleet,
                              solver_iters=10, num_cycles=4)
    m0, agg0 = sh.batch_rollout(cfg, plain_scen, ref, ref.shape[0],
                                solver_iters=10, num_cycles=4, device="cpu")
    for a, b in zip(m, m0):
        assert torch.equal(a, b)
    assert agg == agg0
    assert list(agg) == list(sh.AGG_KEYS)
    _, rep = sh.collective_report(cfg, scen, ref, ref.shape[0], fleet,
                                  solver_iters=10, num_cycles=1)
    assert rep == {"counts": {}, "total_bytes": 0, "ops": []}


def test_rank_blocks_and_their_errors():
    """Each rank's contiguous block of seeds, keys and stacked tensors,
    with JAX's errors when the trial count does not divide by the world
    size or leaves a process no seed."""
    cfg = small_config(num_obstacles=2)
    seeds = [5, 6, 7, 8, 9, 10]
    for r in range(3):
        f = _cpu_fleet(r, 3)
        got = sh.stack_scenarios_global(cfg, seeds, f)
        want = sh.stack_scenarios(cfg, seeds[2 * r:2 * r + 2], device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        full = sh.stack_scenarios(cfg, seeds, device="cpu")
        assert all(torch.equal(a, b) for a, b in
                   zip(sh.shard_scenarios(full, f), want))
        keys = prng.split(prng.prng_key(7), 6)
        assert torch.equal(sh.shard_scenarios(keys, f), keys[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="trial count 4 must divide process "
                                         "count 3"):
        sh.stack_scenarios_global(cfg, [0, 1, 2, 3], _cpu_fleet(0, 3))
    with pytest.raises(ValueError, match="at least one seed per process"):
        sh.stack_scenarios_global(cfg, [], _cpu_fleet(0, 3))
    ref = straight_line_ref_traj(cfg.start, cfg.goal)
    scen = sh.stack_scenarios(cfg, [0], device="cpu")
    with pytest.raises(ValueError, match="ref_keys"):
        sh.batch_rollout(cfg, scen, ref, ref.shape[0], mesh=_cpu_fleet(0, 2),
                         num_cycles=1, ref_keys=prng.split(prng.prng_key(7),
                                                            3))


def _jax_fleet():
    """JAX's side of the two-rank case: the global scenario feed and the
    batch_rollout aggregate over the 8-device CPU mesh of
    tests/conftest.py, and its HLO inventory over 2 cycles."""
    cfg = jsmall_config(num_obstacles=8)
    ref = jref_traj(cfg.start, cfg.goal, spacing=2.5)
    mesh = jsh.make_mesh(8)
    g = jsh.stack_scenarios_global(cfg, SEEDS, mesh)
    L = jnp.asarray(ref.shape[0])
    _, agg = jsh.batch_rollout(cfg, g, ref, L, mesh=mesh,
                               solver_iters=ITERS, num_cycles=CYCLES)
    rep = jsh.collective_report(cfg, g, ref, L, mesh, solver_iters=ITERS,
                                num_cycles=INVENTORY_CYCLES)
    return jax.tree.map(np.asarray, g), agg, rep


def test_two_gloo_ranks_match_jax_mesh(worker_path):
    """Two gloo ranks on the CPU, the multihost protocol (16 seeds, 20
    iterations, 25 cycles). Each rank's scenarios equal its block of
    JAX's stack_scenarios_global (exactly); each rank's per-scenario
    metrics and aggregate inputs equal the one-process batch_rollout of
    the same seeds (exactly); the fleet aggregate, reduced by the two
    all_reduces, is the sum (and minimum) of the ranks' one-process
    statistics, and matches JAX's over the 8-device mesh: the counts
    exactly, the path and travel-time sums within rtol 2e-5 and the
    smallest distance within 1e-3 m. Those limits are not the reduction's
    but the closed loop's: over 25 cycles of the 20-iteration solve the
    two packages' single-device rollouts of these seeds already part by
    up to 1.2e-3 m in an episode's path length and smallest distance (the
    iterate amplifies float32 rounding), so the path sum reads 1.6e-3
    (7.3e-6 relative) where test_multihost.py, JAX against itself, holds
    1e-3, and the smallest distance 1.0e-4 m. Both inventories are
    {"all-reduce": 2}, 32 bytes."""
    res = launch.spawn("torch_fleet_worker:fleet_rollout", 2, "gloo",
                       kwargs=dict(seeds=SEEDS, iters=ITERS, cycles=CYCLES,
                                   inventory_cycles=INVENTORY_CYCLES),
                       device="cpu", threads=1, timeout=600)
    jg, jagg, jrep = _jax_fleet()
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        blk = slice(8 * r["rank"], 8 * r["rank"] + 8)
        for k in Scenario._fields:
            np.testing.assert_array_equal(
                np.asarray(r["scenarios"][k], getattr(jg, k).dtype),
                getattr(jg, k)[blk], err_msg=k)
        assert r["metrics"] == r["metrics_one_process"]
        assert r["agg"] == res[0]["agg"]
    agg = res[0]["agg"]
    assert set(agg) == set(jagg)     # JAX returns its pytree, keys sorted
    for k in ("episodes", "goals", "collisions", "solve_attempts",
              "solve_successes"):
        assert agg[k] == jagg[k], k
    for k in ("path_length_sum", "travel_time_sum"):
        np.testing.assert_allclose(agg[k], jagg[k], rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(agg["min_dist_min"], jagg["min_dist_min"],
                               atol=1e-3)
    # the fleet's sums are the ranks' one-process sums
    for k in sh.SUM_KEYS:
        np.testing.assert_allclose(
            agg[k], sum(r["agg_one_process"][k] for r in res), rtol=1e-6)
    assert agg["min_dist_min"] == min(r["agg_one_process"]["min_dist_min"]
                                      for r in res)
    want = {"counts": {"all-reduce": 2}, "total_bytes": 32}
    assert {k: jrep[k] for k in want} == want
    for r in res:
        assert r["report"] == want


def test_fleet_harness_rows_merge_to_the_one_process_rows(worker_path,
                                                          tmp_path):
    """run_trials and run_trials_checkpointed with a two-rank gloo fleet:
    each rank returns the rows of its own block of seeds (trial_id the
    seed's index) and snapshots its own carry; the ranks' rows in rank
    order are the one-process run's rows, value for value."""
    seeds, timeout, iters = [0, 1, 2, 3], 0.5, 10
    ck = str(tmp_path / "fleet.npz")
    res = launch.spawn("torch_fleet_worker:harness_rows", 2, "gloo",
                       kwargs=dict(seeds=seeds, timeout=timeout, iters=iters,
                                   checkpoint=ck),
                       device="cpu", threads=1, timeout=600)
    cfg = small_config(num_obstacles=4, horizon=8, timeout=timeout,
                       max_obstacles=4, hist=8)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, timeout=timeout))
    plain = H.run_trials(cfg, seeds, solver_iters=iters, device="cpu")
    merged = [row for r in res for row in r["rows"]]
    assert merged == plain
    assert [row for r in res for row in r["checkpointed"]] == plain
    assert [r["file"] for r in res] == [
        str(tmp_path / "fleet.rank0of2.npz"),
        str(tmp_path / "fleet.rank1of2.npz")]
    assert all(os.path.exists(r["file"]) for r in res)
    assert all(r["threads"] == 1 for r in res)


def test_spawn_reports_the_failed_rank_at_once(worker_path):
    """A rank that fails while its peer waits (as a rank blocked in a
    collective would) ends the fleet at once: spawn stops the peer and
    raises with the failed rank's own traceback, long before the fleet's
    timeout (read: ~5 s on the CPU against 600 s)."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 \\(gloo\\) exited 1"
                       "(.|\\n)*rank 1 fails on purpose"):
        launch.spawn("torch_fleet_worker:fail_on_rank", 2, "gloo",
                     kwargs=dict(rank=1), device="cpu", threads=1,
                     timeout=600)
    assert time.monotonic() - t0 < 120


def test_dryrun_multichip_two_gloo_ranks():
    """The toy flight of entry.dryrun_multichip(2) over gloo on the CPU
    (its ranks, entry.dryrun_rank, spawned as dryrun_multichip spawns
    them, with production=False): 2 scenarios per rank, 3 m clear goal,
    40 cycles, reach the goal in every episode without collision, and its
    inventory is the two all-reduces, 32 bytes. The production
    inventories are the slow test below."""
    out = launch.spawn("intent_mpc_torch.entry:dryrun_rank", 2, "gloo",
                       kwargs=dict(production=False), device="cpu",
                       threads=1, timeout=600)[0]
    assert out["world"] == 2 and out["backend"] == "gloo"
    assert out["num_episodes"] == 4
    assert out["success_rate"] == 1.0 and out["collision_rate"] == 0.0
    assert out["avg_travel_time"] > 0.0
    assert out["collective_ops"] == {"all-reduce": 2}
    assert out["collective_bytes"] == 32


@pytest.mark.slow
def test_dryrun_multichip_production_inventories():
    """The production inventories of dryrun_multichip(2) over gloo on the
    CPU (the base program at IntentMPCConfig(), goal mode "global" over a
    static map, the real detector; 2 cycles each, one scenario per rank):
    each is exactly the two all-reduces, 32 bytes. Slow: the production
    program runs ~50k ops per cycle under the profiler on the CPU."""
    out = entry.dryrun_multichip(2, backend="gloo", device="cpu")
    prod = out["production"]
    assert prod["base"]["episodes"] == 2
    assert prod["base"]["solve_attempts"] > 0
    for name in ("base", "goal_mode_global", "real_detector"):
        assert prod[name]["collectives"] == {"all-reduce": 2}, name
        assert prod[name]["bytes"] == 32, name


def test_scaling_study_rows():
    """benchmark/scaling.run_study over worlds 1 and 2 (gloo CPU ranks,
    2 scenarios per rank, 2 cycles, 10 iterations): one row per world with
    the JAX study's row keys, the batch growing with the world, an
    efficiency of 1 at the first world, and the largest world's inventory
    the two all-reduces, 32 bytes."""
    rows, rep = scaling.run_study([1, 2], per_device=2, cycles=2,
                                  obstacles=4, iters=10, backend="gloo",
                                  device="cpu", threads=1)
    assert [tuple(r) for r in rows] == [scaling.ROW_KEYS] * 2
    assert scaling.ROW_KEYS == ("devices", "batch", "solves_per_sec",
                                "per_device", "weak_scaling_efficiency")
    assert [(r["devices"], r["batch"]) for r in rows] == [(1, 2), (2, 4)]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert all(r["solves_per_sec"] > 0 for r in rows)
    assert rep == {"collectives": {"all-reduce": 2},
                   "collective_bytes_per_fleet_episode": 32}
