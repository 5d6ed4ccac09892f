"""Tests of the PyTorch port that need a CUDA device; they skip elsewhere.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them (pytest's --noconftest skips tests/conftest.py,
which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import small_fleet_qps  # noqa: E402
from intent_mpc_torch.engine import closed_loop as cl  # noqa: E402
from intent_mpc_torch.models.world import straight_line_ref_traj  # noqa: E402
from intent_mpc_torch.ops import ew_chain as ew  # noqa: E402
from intent_mpc_torch.ops import fleet as fl  # noqa: E402
from intent_mpc_torch.ops.qp import ConVec  # noqa: E402
from intent_mpc_torch.parallel import sharding as sh  # noqa: E402
from intent_mpc_torch.utils.config import (IntentMPCConfig,  # noqa: E402
                                           PlannerConfig, SolverConfig,
                                           small_config)

torch.set_num_threads(1)

ALPHA = 1.6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _regime_args(device, batch=(6, 6), H=10, W=9, K=8, n=125):
    """Seeded chain inputs in the production regime: +-inf bounds,
    equality rows, rho = 1e-6 on loose rows, duals of 1e4, a NaN row."""
    g = torch.Generator().manual_seed(0)
    shapes = [(H, 8), (H, 8), (W, 5), (W, K)]

    def grp(scale=1.0, shift=0.0):
        return [torch.randn(batch + s, generator=g) * scale + shift
                for s in shapes]
    z, y, zt = grp(3.0), grp(10.0), grp(3.0)
    rho = [torch.rand(batch + s, generator=g) * 2 + 0.05 for s in shapes]
    lo = grp(1.0, -1.0)
    hi = [l + torch.rand(l.shape, generator=g) * 4 for l in lo]
    for i in range(4):
        loose = torch.rand(lo[i].shape, generator=g) < 0.3
        lo[i][loose] = -float("inf")
        hi[i][loose] = float("inf")
        rho[i][loose] = 1e-6
    hi[0] = lo[0].clone()
    rho[0].fill_(100.0)
    y[3] *= 1e3
    z[3][0, 0] = float("nan")
    x = torch.randn(batch + (n,), generator=g)
    x_t = torch.randn(batch + (n,), generator=g)
    x[1, 1] = float("nan")
    return [x.to(device), x_t.to(device)] + [
        ConVec(*(t.to(device) for t in grp_)) for grp_ in (z, y, zt, rho, lo, hi)]


def _flat(outs):
    x_n, z_n, y_n, rzy = outs
    return [x_n] + list(z_n) + list(y_n) + list(rzy)


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_version(cuda_device):
    """The CUDA kernel against the plain PyTorch version on the card: built
    with -fmad=false, IEEE division and the plain version's operation
    order, the outputs are bit-equal and the NaN masks identical; one
    launch adds one to the count."""
    args = _regime_args(cuda_device)
    before = ew.EW_LAUNCHES
    got = ew.ew_chain(ALPHA, *args)
    want = ew.ew_chain_reference(ALPHA, *args)
    torch.cuda.synchronize()
    assert ew.EW_LAUNCHES == before + 1
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


@pytest.mark.cuda
def test_closed_loop_on_card_matches_cpu(cuda_device):
    """The small closed loop on the card and on the CPU, through the entry
    points with their default device: positions agree to 1e-4 m over 4
    cycles (the iterates of this config are stable; see
    intent_mpc_torch/benchmark/sensitivity.py for the production one),
    and every cycle's solve launched the kernel 30 times."""
    cfg = small_config(num_obstacles=4, horizon=8, timeout=0.5,
                       max_obstacles=4, hist=8).replace(goal=(6.0, 0.0, 2.0))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    ew.EW_LAUNCHES = 0
    gpu, _ = cl.run_episode(cfg, sh.stack_scenarios(cfg, [0, 1]), ref,
                            ref.shape[0], num_cycles=4)
    assert ew.EW_LAUNCHES == 4 * cfg.planner.solver.max_iter
    cpu, _ = cl.run_episode(cfg, sh.stack_scenarios(cfg, [0, 1], device="cpu"),
                            ref, ref.shape[0], num_cycles=4, device="cpu")
    assert gpu.pos.device.type == "cuda"
    assert torch.allclose(gpu.pos.cpu(), cpu.pos, atol=1e-4, rtol=0)
    assert torch.equal(gpu.metrics.solve_successes.cpu(),
                       cpu.metrics.solve_successes)


@pytest.mark.cuda
def test_fleet_kernel_matches_plain_version(cuda_device):
    """csrc/fleet_admm.cu against fleet_solve_reference on the card at the
    fleet parity config (horizon 10, 4 slots, 4 scenarios, stationary
    refinement x3; the QPs chip_smoke.py uses): one launch per solve; after 1 iteration x within 1e-5
    of max|x|, after 60 within 1e-3 (the two sum in different orders);
    the inert slots come back as zeros."""
    pcfg = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
        max_iter=60, shared_refine_mode="stationary", shared_refine_iters=3))
    qps = small_fleet_qps(pcfg, 4, cuda_device)
    warm = torch.zeros((4, 6, pcfg.num_vars), device=cuda_device)
    fp, _ = fl.fleet_setup(pcfg, qps, warm)
    for iters, tol in ((1, 1e-5), (60, 1e-3)):
        before = fl.FLEET_LAUNCHES
        got = fl.fleet_solve(pcfg, fp, iters, 3)
        want = fl.fleet_solve_reference(pcfg, fp, iters, 3)
        torch.cuda.synchronize()
        assert fl.FLEET_LAUNCHES == before + 1
        live = want[0][:, :fl.LIVE]
        err = float((got[0][:, :fl.LIVE] - live).abs().max())
        assert err <= tol * float(live.abs().max()), (iters, err)
        for a, b in zip(got[1:], want[1:]):
            b = b[:, :fl.LIVE]
            assert float((a[:, :fl.LIVE] - b).abs().max()) \
                <= 1e-3 * (float(b.abs().max()) + 1.0)
        for t in got:
            assert not bool(t[:, fl.LIVE:].any())


def _fused(cfg):
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                fused_solve=True)))


@pytest.mark.cuda
def test_fused_loop_on_card_matches_cpu(cuda_device):
    """The small closed loop with fused_solve=True on the card and on the
    CPU: one fleet_admm launch per cycle, no ew_chain launch, positions
    within 1e-3 m over 4 cycles."""
    cfg = _fused(small_config(num_obstacles=4, horizon=8, timeout=0.5,
                              max_obstacles=4, hist=8).replace(
        goal=(6.0, 0.0, 2.0)))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    fl.FLEET_LAUNCHES = ew.EW_LAUNCHES = 0
    gpu, _ = cl.run_episode(cfg, sh.stack_scenarios(cfg, [0, 1]), ref,
                            ref.shape[0], num_cycles=4)
    assert fl.FLEET_LAUNCHES == 4 and ew.EW_LAUNCHES == 0
    cpu, _ = cl.run_episode(cfg, sh.stack_scenarios(cfg, [0, 1], device="cpu"),
                            ref, ref.shape[0], num_cycles=4, device="cpu")
    assert torch.allclose(gpu.pos.cpu(), cpu.pos, atol=1e-3, rtol=0)
    assert torch.equal(gpu.metrics.solve_successes.cpu(),
                       cpu.metrics.solve_successes)


@pytest.mark.cuda
@pytest.mark.slow
def test_fused_dynus_episodes_end_finite(cuda_device):
    """DYNUS seeds 0-7 as one batch at the production config with
    fused_solve=True, to the episode end: every episode ends with a
    finite state. Prints one JSON line with success and collision per
    seed (run with -s to read it)."""
    cfg = _fused(IntentMPCConfig())
    seeds = list(range(8))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5)
    carry, _ = cl.run_episode(cfg, sh.stack_scenarios(cfg, seeds), ref,
                              ref.shape[0])
    m = carry.metrics
    print(json.dumps({
        "fused_dynus_seeds": seeds,
        "goal_reached": m.goal_reached.cpu().tolist(),
        "collision": m.collision.cpu().tolist(),
        "solve_successes": m.solve_successes.cpu().tolist(),
        "solve_attempts": m.solve_attempts.cpu().tolist(),
        "device": torch.cuda.get_device_name(0)}))
    assert bool(torch.isfinite(carry.pos).all())
    assert bool(torch.isfinite(carry.vel).all())
    assert int(m.solve_successes.min()) > 0
