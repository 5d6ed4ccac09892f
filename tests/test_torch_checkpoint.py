"""Checkpoint/resume of the port (intent_mpc_torch.engine.checkpoint and
harness.run_trials_checkpointed): a resumed fleet continues bit-exactly,
and checkpointed rows equal run_trials rows exactly."""

import dataclasses
import os

import pytest
import torch

from intent_mpc_torch.benchmark import harness as H
from intent_mpc_torch.engine import checkpoint as ckpt
from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import small_config

torch.set_num_threads(1)

SEEDS = [1, 2]


def _config(timeout=1.5, fused=False, factor_reuse=None, horizon=10):
    cfg = small_config(num_obstacles=6, horizon=horizon, timeout=timeout,
                       max_obstacles=6, hist=12).replace(goal=(8.0, 0.0, 2.0))
    sv = cfg.planner.solver
    sv = dataclasses.replace(
        sv, fused_solve=fused,
        factor_reuse_cycles=(sv.factor_reuse_cycles if factor_reuse is None
                             else factor_reuse))
    return cfg.replace(planner=dataclasses.replace(cfg.planner, solver=sv))


def _run_cycles(cfg, scen, carry, start, n):
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    for i in range(start, start + n):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], empty_grid(),
                                   carry, i, 30)
    return carry


def _assert_same_bits(a, b):
    la, lb = ckpt.flatten(a), ckpt.flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:        # bit patterns, NaN included
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("factor_reuse", [4, 1],
                         ids=["carried_factor", "none_leaves"])
def test_checkpoint_resume_bit_exact(tmp_path, factor_reuse):
    """8 cycles uninterrupted equal 5 cycles, a save/load, and 3 more, on
    every leaf's bits. Cycle 5 is no factor-refresh cycle (refresh every
    4th), so the resumed cycles reuse the carried factor from the file;
    with factor reuse 1 the planner's factor fields are None and stay
    None. Bools and ints keep their dtypes; no .tmp file is left."""
    cfg = _config(factor_reuse=factor_reuse)
    scen = sh.stack_scenarios(cfg, SEEDS, device="cpu")
    carry0 = cl.init_carry(cfg, scen, device="cpu")
    full = _run_cycles(cfg, scen, carry0, 0, 8)
    half = _run_cycles(cfg, scen, carry0, 0, 5)
    path = str(tmp_path / "fleet")
    ckpt.save_checkpoint(path, half, 5, SEEDS)
    assert os.listdir(tmp_path) == ["fleet.npz"]
    carry_r, cyc, seeds_r, scen_r = ckpt.load_checkpoint(path, cfg,
                                                         device="cpu")
    assert cyc == 5 and list(seeds_r) == SEEDS
    _assert_same_bits(scen_r, scen)
    _assert_same_bits(carry_r, half)
    fac = carry_r.planner.fac_minv
    assert (fac is None) == (factor_reuse == 1)
    assert carry_r.traj_ready.dtype == torch.bool
    assert carry_r.metrics.samples.dtype == torch.int32
    resumed = _run_cycles(cfg, scen_r, carry_r, cyc, 3)
    _assert_same_bits(resumed, full)


def test_checkpoint_rejects_mismatched_config(tmp_path):
    """A checkpoint of horizon 10 loaded under horizon 12 raises."""
    cfg = _config()
    scen = sh.stack_scenarios(cfg, [0], device="cpu")
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, cl.init_carry(cfg, scen, device="cpu"), 0, [0])
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(path, _config(horizon=12), device="cpu")
    # the factor fields exist with reuse 4 and not with reuse 1
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(path, _config(factor_reuse=1), device="cpu")


def test_unflatten_keeps_none_and_counts_leaves():
    """flatten then unflatten gives back every leaf's bits exactly, None
    fields stay None, and a surplus leaf raises."""
    cfg = _config(factor_reuse=1)
    scen = sh.stack_scenarios(cfg, [0], device="cpu")
    carry = cl.init_carry(cfg, scen, device="cpu")
    leaves = ckpt.flatten(carry)
    back = ckpt.unflatten(carry, leaves)
    assert back.planner.fac_e is None and back.planner.fac_d is None
    _assert_same_bits(back, carry)
    with pytest.raises(ValueError):
        ckpt.unflatten(carry, leaves + leaves[:1])


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_checkpointed_rows_equal_run_trials(tmp_path, fused):
    """run_trials_checkpointed runs the same operations as run_trials, so
    its rows are identical (==), not merely close. A run cut after its
    first chunk (timeout 0.6 s: 6 cycles) and resumed from its file with
    the full timeout gives rows identical to the uninterrupted run."""
    cfg = _config(fused=fused)
    plain = H.run_trials(cfg, SEEDS, solver_iters=30, device="cpu")
    ck = H.run_trials_checkpointed(cfg, SEEDS, str(tmp_path / "a.npz"),
                                   chunk_cycles=6, solver_iters=30,
                                   device="cpu")
    assert ck == plain
    p2 = str(tmp_path / "b.npz")
    H.run_trials_checkpointed(_config(timeout=0.6, fused=fused), SEEDS, p2,
                              chunk_cycles=6, solver_iters=30, device="cpu")
    resumed = H.run_trials_checkpointed(cfg, SEEDS, p2, chunk_cycles=6,
                                        solver_iters=30, device="cpu")
    assert resumed == ck
    assert sorted(os.listdir(tmp_path)) == ["a.npz", "b.npz"]


def test_checkpoint_with_other_seeds_raises(tmp_path):
    """A checkpoint resumes only the seeds it was written for (exact
    list comparison); others raise ValueError."""
    cfg = _config(timeout=0.2)
    path = str(tmp_path / "c.npz")
    H.run_trials_checkpointed(cfg, SEEDS, path, solver_iters=5, device="cpu")
    with pytest.raises(ValueError, match="seeds differ"):
        H.run_trials_checkpointed(cfg, [3, 4], path, solver_iters=5,
                                  device="cpu")
