"""Tests of the PyTorch port that need a CUDA device; they skip elsewhere.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them (pytest's --noconftest skips tests/conftest.py,
which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from intent_mpc_torch.engine import closed_loop as cl  # noqa: E402
from intent_mpc_torch.models.world import straight_line_ref_traj  # noqa: E402
from intent_mpc_torch.ops import ew_chain as ew  # noqa: E402
from intent_mpc_torch.ops.qp import ConVec  # noqa: E402
from intent_mpc_torch.parallel import sharding as sh  # noqa: E402
from intent_mpc_torch.utils.config import small_config  # noqa: E402

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
