"""Port parity: the real-perception closed loop (use_fake_detector=False:
rendered depth -> DBSCAN -> KF tracks -> predictor -> MPC) against the
JAX package, per cycle from identical carries on a micro world and on a
small DYNUS-style world with static clustering of a prebuilt map; batch
independence, the real_loop script's summary.json, a checkpointed resume,
and (slow) per-seed outcomes at the DYNUS protocol configuration."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.benchmark import harness as JH
from intent_mpc_tpu.benchmark import real_loop as jrl
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.utils import config as jconf
from intent_mpc_torch.benchmark import real_loop as trl
from intent_mpc_torch.engine import checkpoint as ckpt
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as tsh
from intent_mpc_torch.utils import config as tconf
from intent_mpc_torch.utils import convert

torch.set_num_threads(1)


def _config(m, world, fused=False):
    """The same small real-perception config from either package's config
    module: "micro" (four dynamic obstacles in a corridor, the real_loop
    script's default world) or "dynus" (24 obstacles, 65% dynamic, statics
    through a prebuilt map and per-cycle clustering rows, as real_loop
    --dynus)."""
    cfg = m.small_config(num_obstacles=24 if world == "dynus" else 4,
                         horizon=8, timeout=0.5, max_obstacles=4, hist=8)
    rd = m.RealDetectorConfig(max_tracks=4, max_detections=4)
    if world == "dynus":
        cfg = cfg.replace(
            world=dataclasses.replace(cfg.world, x_range=(3.0, 14.0),
                                      y_range=(-4.0, 4.0)),
            goal=(12.0, 0.0, 2.0), real_detector=rd,
            planner=dataclasses.replace(cfg.planner, static_clustering=True),
            engine=dataclasses.replace(cfg.engine, use_fake_detector=False,
                                       render_static_grid=False))
    else:
        cfg = cfg.replace(
            world=dataclasses.replace(cfg.world, dynamic_ratio=1.0,
                                      x_range=(3.0, 8.0), y_range=(-2.0, 2.0),
                                      z_range=(1.0, 2.0)),
            real_detector=rd, start=(0.0, 0.0, 1.5), goal=(8.0, 0.0, 1.5),
            engine=dataclasses.replace(cfg.engine, use_fake_detector=False))
    if fused:
        cfg = cfg.replace(planner=dataclasses.replace(
            cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                    fused_solve=True)))
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("fused", [False, True])
def test_card_check_config_is_the_tested_config(fused):
    """chip_smoke's real_small card-against-CPU entries run
    benchmark/capture.real_small_config: the configs held against JAX
    here."""
    from intent_mpc_torch.benchmark.capture import real_small_config
    for world in ("micro", "dynus"):
        assert real_small_config(world, fused) == _config(tconf, world,
                                                          fused)


def _stack(trees):
    return jax.tree.map(lambda *a: jnp.stack(a), *trees)


def _maps(world, seeds, jcfg):
    """Each package's static maps of the seeds: JAX's per-seed grids and
    the port's per-scenario stack of the same arrays."""
    if world != "dynus":
        return [jempty() for _ in seeds], empty_grid()
    grids = [jrl.static_grid_for(jworld.generate_scenario(s, jcfg.world))
             for s in seeds]
    return grids, convert.grid_from_numpy([_np(g) for g in grids])


STAT_INTS = ("err_n", "missed_sum", "gt_in_fov_sum", "spurious_sum",
             "track_ticks_sum", "births_sum")


@pytest.mark.parametrize("world,fused", [("micro", False), ("micro", True),
                                         ("dynus", False), ("dynus", True)],
                         ids=["micro", "micro_fused", "dynus", "dynus_fused"])
def test_real_episode_steps_match_jax(world, fused):
    """3 closed-loop cycles in real mode of two seeds stepped as one batch,
    from the JAX carries converted by carry_from_numpy, on the default and
    the fused path: positions and velocities within 1e-4 m (m/s), the
    track table's live, age and miss and the integer perception stats
    equal every cycle. On the DYNUS-style world the static clustering
    gives active rows."""
    jcfg, tcfg = _config(jconf, world, fused), _config(tconf, world, fused)
    seeds = (0, 1)
    ref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, spacing=0.5)
    L = jnp.asarray(ref.shape[0])
    jscs = [jworld.generate_scenario(s, jcfg.world) for s in seeds]
    jgrids, tocc = _maps(world, seeds, jcfg)
    step = jax.jit(lambda s, g, c, i: jcl.episode_step(jcfg, s, ref, L, g,
                                                       c, i))
    jcs = [jcl.init_carry(jcfg, s) for s in jscs]
    tsc = convert.scenario_from_numpy(_np(_stack(jscs)))
    tc = convert.carry_from_numpy(_np(_stack(jcs)))
    tref = torch.as_tensor(np.array(ref))
    for i in range(3):
        jcs = [step(s, g, c, jnp.asarray(i, jnp.int32))[0]
               for s, g, c in zip(jscs, jgrids, jcs)]
        tc, _ = tcl.episode_step(tcfg, tsc, tref, int(ref.shape[0]), tocc,
                                 tc, i)
        tn = convert.carry_to_numpy(tc)
        for s, jc in enumerate(jcs):
            msg = "seed %d cycle %d" % (seeds[s], i)
            np.testing.assert_allclose(tn.pos[s], np.asarray(jc.pos),
                                       atol=1e-4, err_msg=msg)
            np.testing.assert_allclose(tn.vel[s], np.asarray(jc.vel),
                                       atol=1e-4, err_msg=msg)
            for f in ("live", "age", "miss"):
                np.testing.assert_array_equal(
                    getattr(tn.real_det.tracks, f)[s],
                    np.asarray(getattr(jc.real_det.tracks, f)), err_msg=msg)
            for f in STAT_INTS:
                assert getattr(tn.real_det.stats, f)[s] == int(
                    getattr(jc.real_det.stats, f)), (f, msg)
            assert tn.metrics.solve_successes[s] == int(
                jc.metrics.solve_successes)
    assert int(tc.real_det.tracks.live.sum()) >= 4
    if world == "dynus":
        assert bool(tcl._static_rows(tcfg, tocc, tc.pos)[3].any())


def _run(cfg, seeds, cycles):
    scen = tsh.stack_scenarios(cfg, seeds, device="cpu")
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    occ, veto = trl.static_maps(cfg, seeds, "cpu")
    carry = tcl.init_carry(cfg, scen, device="cpu")
    for i in range(cycles):
        carry, _ = tcl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry,
                                    i, veto_occ=veto)
    return carry


def test_batched_rows_equal_single_seed_rows():
    """Two seeds stepped as one batch give, leaf for leaf, the carries of
    the two seeds stepped alone (the batch runs DBSCAN as many rounds as
    its slowest scenario, past each one's fixed point)."""
    cfg = _config(tconf, "dynus")
    both = ckpt.flatten(_run(cfg, [0, 1], 3))
    for i, seed in enumerate((0, 1)):
        one = ckpt.flatten(_run(cfg, [seed], 3))
        assert len(one) == len(both)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b[0])


def test_checkpointed_resume_is_bit_exact_in_real_mode(tmp_path):
    """A real-mode fleet (the track table, history rings and perception
    stats in the carry) snapshotted after 2 cycles and resumed for 2 more
    equals the uninterrupted 4-cycle run, leaf for leaf."""
    cfg = _config(tconf, "dynus")
    seeds = [0, 1]
    straight = _run(cfg, seeds, 4)
    half = _run(cfg, seeds, 2)
    path = str(tmp_path / "real.npz")
    ckpt.save_checkpoint(path, half, 2, seeds)
    carry, start, got_seeds, scen = ckpt.load_checkpoint(path, cfg,
                                                         device="cpu")
    assert start == 2 and list(got_seeds) == seeds
    assert carry.real_det is not None
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    occ, veto = trl.static_maps(cfg, seeds, "cpu")
    for i in range(start, 4):
        carry, _ = tcl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry,
                                    i, veto_occ=veto)
    for a, b in zip(ckpt.flatten(carry), ckpt.flatten(straight)):
        assert torch.equal(a, b)


def _jax_row_keys(world):
    """The JAX script's row keys, in its order: summarize's, then seed and
    wall_s, then (real mode) tracks_dynamic and perception_summary's."""
    jcfg = _config(jconf, world)
    sc = jworld.generate_scenario(0, jcfg.world)
    c = jcl.init_carry(jcfg, sc)
    keys = list(jcl.summarize(jcfg, c)) + ["seed", "wall_s"]
    return keys, keys + ["tracks_dynamic"] + list(jcl.perception_summary(c))


@pytest.mark.parametrize("world", ["micro", "dynus"])
def test_real_loop_summary_matches_jax_layout(world, tmp_path):
    """python -m intent_mpc_torch.benchmark.real_loop on the CPU writes
    summary.json with the JAX script's layout: config, gt, real and the
    per-seed rows, row keys in JAX's order, the harness aggregate keys and
    the real mode's perception averages."""
    argv = ["--device", "cpu", "--seeds", "0", "1", "--timeout", "0.2",
            "--out", str(tmp_path)]
    if world == "dynus":
        argv += ["--dynus", "--obstacles", "40", "--max-obstacles", "8",
                 "--max-tracks", "4"]
    else:
        argv += ["--obstacles", "3", "--max-tracks", "4"]
    out = trl.main(argv)
    with open(os.path.join(tmp_path, "summary.json")) as f:
        disk = json.load(f)
    assert list(disk) == ["config", "gt", "gt_rows", "real", "real_rows"]
    assert disk["config"] == json.loads(json.dumps(out["config"]))
    gt_keys, real_keys = _jax_row_keys(world)
    for name, keys in (("gt", gt_keys), ("real", real_keys)):
        rows = disk[name + "_rows"]
        assert [r["seed"] for r in rows] == [0, 1]
        for r in rows:
            assert list(r) == keys
    jagg = JH.aggregate(disk["gt_rows"])
    assert list(disk["gt"]) == list(jagg)
    assert list(disk["real"]) == list(jagg) + [
        "avg_" + k for k in trl.PERCEPTION_KEYS]
    assert disk["config"]["dynus"] == (world == "dynus")
    assert disk["real_rows"][0]["mpc_solve_count"] == 2


@pytest.mark.slow
def test_real_dynus_seeds_match_jax():
    """The real_loop --dynus configuration (200 obstacles, 64 + 16 QP
    slots, 16 tracks) on seeds 0-3 at a 30 s timeout: the port on the CPU
    (the CLI's batched run) and the JAX package on the CPU (one episode
    per seed, as its script runs them) end each seed with the same goal
    and collision outcome. Per-cycle states are not compared at this size
    (the infeasible DYNUS QPs amplify rounding, ROADMAP queue 3 item 5)."""
    import argparse
    flags = ["--dynus", "--obstacles", "200", "--timeout", "30",
             "--max-obstacles", "64", "--max-tracks", "16"]
    args = trl.parse_args(flags + ["--device", "cpu"])
    tcfg = trl.real_cfg_of(trl.build_cfg(args), args)
    _, rows, _ = trl.run_mode(tcfg, [0, 1, 2, 3], "cpu")
    jargs = argparse.Namespace(dynus=True, obstacles=200, timeout=30.0,
                               max_obstacles=64, max_tracks=16,
                               dynamic_ratio=0.65, corridor=30.0)
    jcfg = jrl.build_cfg(jargs)
    jcfg = jcfg.replace(
        engine=dataclasses.replace(jcfg.engine, use_fake_detector=False),
        planner=dataclasses.replace(jcfg.planner, static_clustering=True))
    ref = jworld.straight_line_ref_traj(jcfg.start, jcfg.goal, spacing=2.5)
    for seed, row in zip(range(4), rows):
        sc = jworld.generate_scenario(seed, jcfg.world)
        carry, _ = jcl.run_episode(jcfg, sc, ref, jnp.asarray(ref.shape[0]),
                                   occ=jrl.static_grid_for(sc))
        want = jcl.summarize(jcfg, carry)
        print(json.dumps({"seed": seed, "port": {k: row[k] for k in (
            "goal_reached", "collision", "min_distance_to_obstacles")},
            "jax": {k: want[k] for k in ("goal_reached", "collision",
                                         "min_distance_to_obstacles")}}))
        assert row["goal_reached"] == want["goal_reached"], seed
        assert row["collision"] == want["collision"], seed
