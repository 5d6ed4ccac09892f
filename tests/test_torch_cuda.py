"""Tests of the PyTorch port that need a CUDA device; they skip elsewhere.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them (pytest's --noconftest skips tests/conftest.py,
which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses
import functools
import json
import os
import re
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (CONSTRAINT_OP_TOL, NORTH_STAR_BOUNDS,  # noqa: E402
                        accepted, check_exploration_small,
                        check_fusion_small, check_knobs_small,
                        check_mapping_small,
                        check_north_star, constraint_op_inputs,
                        small_fleet_qps)
from intent_mpc_torch.benchmark import bench  # noqa: E402
from intent_mpc_torch.benchmark import harness  # noqa: E402
from intent_mpc_torch.benchmark.capture import capture_fused_qps  # noqa: E402
from intent_mpc_torch.engine import closed_loop as cl  # noqa: E402
from intent_mpc_torch.engine import graph  # noqa: E402
from intent_mpc_torch.models.occupancy import empty_grid  # noqa: E402
from intent_mpc_torch.models.world import straight_line_ref_traj  # noqa: E402
from intent_mpc_torch.ops import admm as admmlib  # noqa: E402
from intent_mpc_torch.ops import constraint_op as cop  # noqa: E402
from intent_mpc_torch.ops import dense_loop as dl  # noqa: E402
from intent_mpc_torch.ops import ew_chain as ew  # noqa: E402
from intent_mpc_torch.ops import fleet as fl  # noqa: E402
from intent_mpc_torch.ops import qp as qplib  # noqa: E402
from intent_mpc_torch.ops.qp import ConVec  # noqa: E402
from intent_mpc_torch.parallel import sharding as sh  # noqa: E402
from intent_mpc_torch.utils import trace  # noqa: E402
from intent_mpc_torch.utils.config import (IntentMPCConfig,  # noqa: E402
                                           PlannerConfig, SolverConfig,
                                           small_config)
from intent_mpc_torch.utils.tree import flatten  # noqa: E402

torch.set_num_threads(1)

ALPHA = 1.6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _launches(kernel):
    """The kernel's launches by the host, counted by utils/trace since its
    last reset."""
    return trace.counters().get(kernel + ".launches", 0)


def _device_names(fn):
    """fn()'s result and the names of the device events of its record
    (torch.profiler's CUDA activity): a cycle replayed from a CUDA graph
    launches its kernels from the graph, which only the device record
    sees run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]


def _kernel_events(fn):
    """fn()'s result and each kernel's events in its device record."""
    out, names = _device_names(fn)
    return out, {k: sum(k + "_kernel" in n for n in names)
                 for k in ("ew_chain", "fleet_admm", "dense_loop",
                           "constraint_op")}


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
@pytest.mark.parametrize("S", [None, 1, 33])
def test_kernel_bit_equal_to_plain_version(cuda_device, S):
    """The CUDA kernel against the plain PyTorch version on the card: built
    with -fmad=false, IEEE division and the plain version's operation
    order, the outputs are bit-equal and the NaN masks identical; one
    launch adds one to the count, and a second gives the same bits. S:
    the production shapes (horizon 30, 29 steps, 65 slots, 385 variables)
    at an odd scenario count, where x (2310 S floats) and cb (870 S) end
    inside a float4 and their ragged ends go through the same pass; None:
    a (6, 6) batch of a small config."""
    if S is None:
        args = _regime_args(cuda_device)
    else:
        args = _regime_args(cuda_device, batch=(S * 6,), H=30, W=29, K=65,
                            n=385)
        assert args[0].numel() % 4 and args[2].cb.numel() % 4
    before = _launches("ew_chain")
    got = ew.ew_chain(ALPHA, *args)
    want = ew.ew_chain_reference(ALPHA, *args)
    again = ew.ew_chain(ALPHA, *args)
    torch.cuda.synchronize()
    assert _launches("ew_chain") == before + 2
    for g, w, a in zip(_flat(got), _flat(want), _flat(again)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
        assert _same_bits(g, a)


@pytest.mark.cuda
def test_kernel_refuses_a_misaligned_view(cuda_device):
    """A view that starts 4 bytes into its buffer cannot be read 16 bytes
    at a time: the wrapper raises ValueError and launches nothing."""
    args = _regime_args(cuda_device)
    base = torch.zeros(args[0].numel() + 1, device=cuda_device)
    view = base[1:].view(args[0].shape)
    view.copy_(args[0])
    before = _launches("ew_chain")
    with pytest.raises(ValueError, match="16-byte"):
        ew.ew_chain(ALPHA, view, *args[1:])
    assert _launches("ew_chain") == before


def _constraint_op_setup(device, S, shared, horizon=30, K=65):
    """(cfg, qps, D, E, rho, h_s) of (S, 6) seeded candidate QPs on
    `device` with every obstacle row in use (chip_smoke's
    constraint_op_inputs: random gradients, mixed masks): a shared
    factor's (S, 1, ...) scaling or each candidate's."""
    cfg = PlannerConfig(horizon=horizon, max_obstacles=K)
    return (cfg,) + constraint_op_inputs(cfg, S, shared, device)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("entry", ["forward", "transpose", "normal"])
def test_constraint_op_matches_plain_version(cuda_device, shared, entry):
    """Each entry of csrc/constraint_op.cu against its plain version on the
    card at the cell's shapes (128 scenarios x 6 candidates, horizon 30,
    65 slots), with a shared factor's scaling (candidate stride 0) and with
    each candidate's: within chip_smoke.CONSTRAINT_OP_TOL of each problem's
    largest output in a group (the order of summation differs); one
    launch per call, and a second launch gives the same bits."""
    cfg, qps, D, E, rho, h_s = _constraint_op_setup(cuda_device, 128, shared)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(qps.q.shape, generator=g, device=cuda_device)
    w = ConVec(*(torch.randn(t.shape, generator=g, device=cuda_device) * 10
                 for t in rho))
    args = {"forward": (x,), "transpose": (w,),
            "normal": (rho, h_s, 1e-6, x)}[entry]
    op = cop.ConstraintOp(cfg, qps, D, E)
    before = _launches("constraint_op")
    got = getattr(op, entry)(*args)
    again = getattr(op, entry)(*args)
    want = getattr(cop.ConstraintOpReference(cfg, qps, D, E), entry)(*args)
    torch.cuda.synchronize()
    assert _launches("constraint_op") == before + 2
    pairs = (zip(got, want, again) if entry == "forward"
             else [(got, want, again)])
    for a, b, c in pairs:
        assert _same_bits(a, c)
        err = (a - b).abs().flatten(2).amax(-1)
        scale = b.abs().flatten(2).amax(-1)
        assert bool((err <= CONSTRAINT_OP_TOL * scale).all()), float(
            (err / scale.clamp(min=1e-30)).max())


def _entry_bad_cases():
    """(name, entry, how to break its arguments, the exception, a pattern
    of its message)."""
    def x(f):
        return lambda c: c.update(x=f(c["x"]))
    return [
        ("x_float64", "normal", x(torch.Tensor.double), TypeError,
         "float32"),
        ("x_strided", "normal", x(lambda t: t.mT.contiguous().mT),
         ValueError, "contiguous"),
        ("x_shape", "normal", x(lambda t: t[..., 1:]), ValueError, "shape"),
        ("x_one_candidate", "forward", x(lambda t: t[:, :1]), ValueError,
         "shape"),
        ("x_on_cpu", "forward", x(lambda t: t.cpu()), ValueError, "on cpu"),
        ("w_shape", "transpose", lambda c: c.update(w=c["w"]._replace(
            obs=c["w"].obs[..., :-1])), ValueError, "shape"),
        ("rho_shared", "normal", lambda c: c.update(rho=c["rho"]._replace(
            cb=c["rho"].cb[:, :1].contiguous())), ValueError, "shape"),
        ("h_s_strided", "normal", lambda c: c.update(h_s=c["h_s"].expand(
            c["x"].shape)), ValueError, "contiguous"),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("name,entry,brk,exc,says", _entry_bad_cases(),
                         ids=[c[0] for c in _entry_bad_cases()])
def test_constraint_op_refuses_before_launching(cuda_device, name, entry,
                                                brk, exc, says):
    """An entry given a vector of the wrong dtype, layout, shape or device,
    or a rho or h_s of the wrong shape or layout, raises, and the kernel
    does not launch."""
    cfg, qps, D, E, rho, h_s = _constraint_op_setup(cuda_device, 2, True,
                                                    horizon=10, K=4)
    op = cop.ConstraintOp(cfg, qps, D, E)
    x = torch.randn(qps.q.shape, device=cuda_device)
    c = dict(x=x, w=op.forward(x), rho=rho, h_s=h_s)
    torch.cuda.synchronize()
    brk(c)
    args = {"forward": (c["x"],), "transpose": (c["w"],),
            "normal": (c["rho"], c["h_s"], 1e-6, c["x"])}[entry]
    before = _launches("constraint_op")
    with pytest.raises(exc, match=says):
        getattr(op, entry)(*args)
    torch.cuda.synchronize()
    assert _launches("constraint_op") == before


@pytest.mark.cuda
def test_default_solve_iterates_without_gemv(cuda_device):
    """admm_solve on the default path (shared factor, CG-2) at the cell's
    batch launches the constraint operator 5 times per iteration and once
    for its first z; the cuBLAS gemv launches that remain (the unscale of
    its result) do not grow with the iterations."""
    cfg = PlannerConfig(horizon=30, max_obstacles=65)
    qps = small_fleet_qps(cfg, 128, cuda_device)
    fac = admmlib.admm_factor(cfg, admmlib.candidate_mean(qps))
    x0 = torch.zeros(qps.q.shape, device=cuda_device)
    rho = torch.full((128, 1), 0.1, device=cuda_device)
    counts = {}
    for iters in (10, 20):
        admmlib.admm_solve(cfg, qps, x0, iters, rho_override=rho, factor=fac)
        _, names = _device_names(lambda: admmlib.admm_solve(
            cfg, qps, x0, iters, rho_override=rho, factor=fac))
        counts[iters] = (sum("constraint_op_kernel" in n for n in names),
                         sum("gemv" in n for n in names))
    assert counts[10][0] == 5 * 10 + 1 and counts[20][0] == 5 * 20 + 1
    assert counts[10][1] == counts[20][1]


@pytest.mark.cuda
def test_closed_loop_on_card_matches_cpu(cuda_device):
    """The small closed loop on the card and on the CPU, through the entry
    points with their default device: positions agree to 1e-4 m over 4
    cycles (the iterates of this config are stable; see
    intent_mpc_torch/benchmark/sensitivity.py for the production one),
    and every cycle's solve launched the kernel 30 times (the device
    record of a third run, which replays the earlier runs' graphs and
    gives their bits)."""
    cfg = small_config(num_obstacles=4, horizon=8, timeout=0.5,
                       max_obstacles=4, hist=8).replace(goal=(6.0, 0.0, 2.0))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    scen = sh.stack_scenarios(cfg, [0, 1])

    def fly():
        return cl.run_episode(cfg, scen, ref, ref.shape[0], num_cycles=4)[0]
    gpu = fly()
    fly()                       # every variant captured before the record
    again, counts = _kernel_events(fly)
    iters = cfg.planner.solver.max_iter
    assert counts["ew_chain"] == 4 * iters
    assert counts["constraint_op"] == 4 * (5 * iters + 1)
    assert torch.equal(again.pos, gpu.pos)
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
        before = _launches("fleet_admm")
        got = fl.fleet_solve(pcfg, fp, iters, 3)
        want = fl.fleet_solve_reference(pcfg, fp, iters, 3)
        torch.cuda.synchronize()
        assert _launches("fleet_admm") == before + 1
        live = want[0][:, :fl.LIVE]
        err = float((got[0][:, :fl.LIVE] - live).abs().max())
        assert err <= tol * float(live.abs().max()), (iters, err)
        for a, b in zip(got[1:], want[1:]):
            b = b[:, :fl.LIVE]
            assert float((a[:, :fl.LIVE] - b).abs().max()) \
                <= 1e-3 * (float(b.abs().max()) + 1.0)
        for t in got:
            assert not bool(t[:, fl.LIVE:].any())


_FLEET_SMALL = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
    max_iter=60, shared_refine_mode="stationary", shared_refine_iters=3))
_FLEET_PRODUCTION = PlannerConfig(horizon=30, max_obstacles=65)


def _fleet_problem(pcfg, S, device):
    qps = small_fleet_qps(pcfg, S, device)
    warm = torch.zeros((S, 6, pcfg.num_vars), device=device)
    return fl.fleet_setup(pcfg, qps, warm)[0]


def _check_fleet(pcfg, fp, iters, refine, tol):
    """One launch against fleet_solve_reference, with the tolerances of
    test_fleet_kernel_matches_plain_version: x within tol of max|x|, the
    duals within 1e-3 of their scale, the inert slots zero."""
    before = _launches("fleet_admm")
    got = fl.fleet_solve(pcfg, fp, iters, refine)
    want = fl.fleet_solve_reference(pcfg, fp, iters, refine)
    torch.cuda.synchronize()
    assert _launches("fleet_admm") == before + 1
    live = want[0][:, :fl.LIVE]
    err = float((got[0][:, :fl.LIVE] - live).abs().max())
    assert err <= tol * float(live.abs().max()), (iters, refine, err)
    for a, b in zip(got[1:], want[1:]):
        b = b[:, :fl.LIVE]
        assert float((a[:, :fl.LIVE] - b).abs().max()) \
            <= 1e-3 * (float(b.abs().max()) + 1.0)
    for t in got:
        assert not bool(t[:, fl.LIVE:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["small", "production"])
@pytest.mark.parametrize("S", [1, 133])
def test_fleet_kernel_at_scenario_counts(cuda_device, config, S):
    """One scenario, and more scenarios than the H100 has SMs (one block
    each), at the small config and at the production shapes (horizon 30,
    72 slots): after 1 iteration within 1e-5 of max|x|, after 60 within
    1e-3."""
    pcfg = _FLEET_SMALL if config == "small" else _FLEET_PRODUCTION
    refine = pcfg.solver.shared_refine_iters
    fp = _fleet_problem(pcfg, S, cuda_device)
    for iters, tol in ((1, 1e-5), (60, 1e-3)):
        _check_fleet(pcfg, fp, iters, refine, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1])
@pytest.mark.parametrize("refine", [0, 1, 2, 3])
def test_fleet_kernel_refine_and_iters(cuda_device, refine, iters):
    """Every refinement count the configs use and the shortest solves:
    0 iterations returns the warm start and zero duals, 1 iteration is
    within 1e-5 of max|x|."""
    fp = _fleet_problem(_FLEET_SMALL, 4, cuda_device)
    _check_fleet(_FLEET_SMALL, fp, iters, refine, 1e-5)


@pytest.mark.cuda
def test_fleet_kernel_is_deterministic(cuda_device):
    """No atomics and fixed summation orders: two 100-iteration launches on
    the candidate QPs of cycle 2 of the production fused loop (4
    scenarios) give the same bits."""
    cfg = _fused(IntentMPCConfig())
    pcfg = cfg.planner
    qps, warm, rho = capture_fused_qps(cfg, 4, 2, cuda_device)
    fp, _ = fl.fleet_setup(pcfg, qps, warm, rho_override=rho)
    refine = pcfg.solver.shared_refine_iters
    a = fl.fleet_solve(pcfg, fp, 100, refine)
    b = fl.fleet_solve(pcfg, fp, 100, refine)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.cuda
def test_fleet_kernel_rejects_a_poisoned_candidate(cuda_device):
    """A NaN in one candidate's scaled q (scenario 1, candidate 2) reaches
    its rhs, and the dense Minv apply spreads it over the candidate: the
    planner's acceptance rule rejects that candidate for the kernel as for
    the plain version, and every other candidate of every scenario gives
    the same bits as a launch without the poison (each candidate's sums
    read only its own vectors; csrc/fleet_admm.cu's note on non-finite
    values)."""
    pcfg = _FLEET_SMALL
    refine = pcfg.solver.shared_refine_iters
    qps = small_fleet_qps(pcfg, 4, cuda_device)
    warm = torch.zeros((4, 6, pcfg.num_vars), device=cuda_device)
    fp, fac = fl.fleet_setup(pcfg, qps, warm)
    q = fp.q.clone()
    q[1, 2, 5] = float("nan")
    bad = fp._replace(q=q)
    clean = fl.fleet_solve(pcfg, fp, 60, refine)
    got = fl.fleet_solve(pcfg, bad, 60, refine)
    want = fl.fleet_solve_reference(pcfg, bad, 60, refine)
    torch.cuda.synchronize()
    acc_got = accepted(fl.fleet_result(pcfg, qps, fac, *got))
    acc_want = accepted(fl.fleet_result(pcfg, qps, fac, *want))
    acc_clean = accepted(fl.fleet_result(pcfg, qps, fac, *clean))
    assert not bool(acc_got[1, 2]) and not bool(acc_want[1, 2])
    assert not bool(torch.isfinite(got[0][1, 2]).all())
    others = torch.ones((4, fl.LANES), dtype=torch.bool, device=cuda_device)
    others[1, 2] = False
    for a, b in zip(got, clean):
        assert _same_bits(a[others], b[others])
    keep = others[:, :fl.LIVE]
    assert torch.equal(acc_got[keep], acc_clean[keep])
    assert torch.equal(acc_got, acc_want)


def _dense_problem(pcfg, device, candidates=None, scenarios=1,
                   with_qps=False):
    """The dense-A problem of small_fleet_qps(pcfg, scenarios) (6
    candidates each, or the first `candidates`), as admm_solve_dense
    builds it; with_qps also returns the flat QPs and the column scale."""
    n = pcfg.num_vars
    qps = admmlib._flatten(small_fleet_qps(pcfg, scenarios, device), 2)
    if candidates is not None:
        qps = type(qps)(*(type(v)(*(t[:candidates] for t in v))
                          if isinstance(v, ConVec) else v[:candidates]
                          for v in qps))
    warm = torch.zeros((qps.q.shape[0], n), device=device)
    n_pad, m_pad = admmlib.dense_pads(pcfg, qps.G.shape[-2])
    sp, (D, _, _) = admmlib._dense_scaled_problem(pcfg, qps, warm,
                                                  pcfg.solver, n_pad, m_pad)
    return (sp, qps, D) if with_qps else sp


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("candidates", [None, 1, 138])
def test_dense_kernel_matches_plain_version(cuda_device, candidates, refine):
    """csrc/dense_loop.cu against dense_loop_reference on the card at the
    config of tests/test_pallas_admm.py (horizon 10, 4 slots, dense
    factor), on 6 candidates (None), one, and more than the H100 has SMs
    (one block each; 138 of 23 scenarios): one launch per call, a second
    launch gives the same bits; after 1 iteration x within 1e-5 of
    max|x|, after 150 within 1e-3 of it (the two sum in different orders;
    cond(M) amplifies that over the iterations); the padded entries stay
    0. With a refinement step the limit after 1 iteration is 2e-4, set
    from readings as on the CPU (test_torch_dense.py::
    test_dense_loop_readings_over_seeds): the residual rhs - M xt, with
    cond(M) ~1e5, cancels down to rounding, and Minv carries the
    summation order's share of it into x. chip_smoke.py's small-config
    phase reads that spread over 24 candidates on the card (largest
    5.86e-5, CPU against JAX 7.56e-5); 2e-4 is 2.6x the largest."""
    pcfg = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
        max_iter=150, refine_iters=refine, structured_factor=False))
    sp = _dense_problem(pcfg, cuda_device, candidates=candidates,
                        scenarios=1 if candidates is None else 23)
    assert sp.q.shape[0] == (candidates or 6)
    for iters, tol in ((1, 2e-4 if refine else 1e-5), (150, 1e-3)):
        before = _launches("dense_loop")
        got = dl.admm_iterations_dense(sp, iters, 1e-6, ALPHA, refine)
        want = dl.dense_loop_reference(sp, iters, 1e-6, ALPHA, refine)
        again = dl.admm_iterations_dense(sp, iters, 1e-6, ALPHA, refine)
        torch.cuda.synchronize()
        assert _launches("dense_loop") == before + 2
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), (iters, err)
        assert not bool(got[:, pcfg.num_vars:].any())
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_dense_kernel_production_pair(cuda_device):
    """Two candidates at production shapes (horizon 30, 65 slots: n_pad
    512, m_pad 2560) with the production solver settings (structured
    factor, refine 0): after 1 iteration within 1e-5 of max|x|, after 10
    within 5e-4 of it (the tolerance of the CPU parity test against JAX
    at these shapes)."""
    pcfg = PlannerConfig(horizon=30, max_obstacles=65)
    sp = _dense_problem(pcfg, cuda_device, candidates=2)
    assert tuple(sp.amat.shape) == (2, 2560, 512)
    for iters, tol in ((1, 1e-5), (10, 5e-4)):
        got = dl.admm_iterations_dense(sp, iters, 1e-6, ALPHA, 0)
        want = dl.dense_loop_reference(sp, iters, 1e-6, ALPHA, 0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), (iters, err)


@pytest.mark.cuda
def test_dense_kernel_is_deterministic(cuda_device):
    """No atomics and fixed summation orders: two launches on the same
    production-shape problem give the same bits."""
    pcfg = PlannerConfig(horizon=30, max_obstacles=65)
    sp = _dense_problem(pcfg, cuda_device)
    a = dl.admm_iterations_dense(sp, 20, 1e-6, ALPHA, 1)
    b = dl.admm_iterations_dense(sp, 20, 1e-6, ALPHA, 1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


_DENSE_SMALL = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
    max_iter=150, refine_iters=0, structured_factor=False))


@pytest.mark.cuda
def test_dense_kernel_rejects_a_poisoned_candidate(cuda_device):
    """A NaN in candidate 2's scaled q reaches its rhs; the CSR products
    skip A's zeros, but the dense Minv apply spreads it over the
    candidate: its x ends non-finite and the planner's acceptance rule
    rejects it, for the kernel as for the plain version, and the other
    candidates give the same bits as a launch without the poison."""
    pcfg = _DENSE_SMALL
    sp, qps, D = _dense_problem(pcfg, cuda_device, with_qps=True)
    n = pcfg.num_vars
    q = sp.q.clone()
    q[2, 7] = float("nan")
    bad = sp._replace(q=q)
    clean = dl.admm_iterations_dense(sp, 150, 1e-6, ALPHA, 0)
    got = dl.admm_iterations_dense(bad, 150, 1e-6, ALPHA, 0)
    want = dl.dense_loop_reference(bad, 150, 1e-6, ALPHA, 0)
    torch.cuda.synchronize()
    acc = [accepted(admmlib.dense_result(pcfg, qps, D * x[:, :n],
                                         pcfg.solver))
           for x in (got, want, clean)]
    assert not bool(acc[0][2]) and not bool(acc[1][2])
    assert not bool(torch.isfinite(got[2]).any())
    others = torch.arange(6, device=cuda_device) != 2
    assert _same_bits(got[others], clean[others])
    assert torch.equal(acc[0][others], acc[2][others])
    assert torch.equal(acc[0], acc[1])


_OVERFLOW = """
import sys, torch
sys.path.insert(0, %r)
from intent_mpc_torch.ops import dense_loop as dl
C, n_pad, m_pad = 2, 128, 256
g = torch.Generator(device="cuda").manual_seed(0)
def r(*shape):
    return torch.rand(shape, generator=g, device="cuda") + 0.5
eye = torch.eye(n_pad, device="cuda").expand(C, -1, -1).contiguous()
sp = dl.DenseScaledProblem(eye, eye.clone(), r(C, m_pad, n_pad), r(C, n_pad),
                           r(C, n_pad), r(C, m_pad), -r(C, m_pad), r(C, m_pad))
assert m_pad * n_pad > dl.csr_capacity(n_pad, m_pad)
x = dl.admm_iterations_dense(sp, 3, 1e-6, 1.6, 0)
print("launched", flush=True)
torch.cuda.synchronize()
print("no failure", flush=True)
"""


@pytest.mark.cuda
def test_dense_kernel_fails_loudly_past_its_csr(cuda_device):
    """A candidate whose A has more nonzeros than the kernel's CSR holds
    (a fully dense 256 x 128 A: 32,768 against 15,944) fails a device-side
    assert: the launch returns without a host sync, and the next
    synchronize raises. The assert leaves the CUDA context unusable, so
    this runs in its own process."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _OVERFLOW % root],
                         capture_output=True, text=True, timeout=600)
    assert "launched" in out.stdout, out.stderr[-2000:]
    assert "no failure" not in out.stdout
    assert out.returncode != 0
    assert "assert" in out.stderr.lower(), out.stderr[-2000:]


@pytest.mark.cuda
def test_dense_entry_refuses_an_a_beyond_its_csr(cuda_device):
    """admm_solve_dense refuses, before building anything, a config whose
    A may have more nonzeros than the kernel's CSR holds (horizon 30, 100
    slots: 15,618 at most)."""
    pcfg = PlannerConfig(horizon=30, max_obstacles=100)
    qps = small_fleet_qps(pcfg, 1, cuda_device)
    K = qps.G.shape[-2]
    n_pad, m_pad = admmlib.dense_pads(pcfg, K)
    assert qplib.dense_a_nnz_max(pcfg, K) > dl.csr_capacity(n_pad, m_pad)
    before = _launches("dense_loop")
    warm = torch.zeros((1, 6, pcfg.num_vars), device=cuda_device)
    with pytest.raises(ValueError, match="cannot hold A"):
        admmlib.admm_solve_dense(pcfg, qps, warm, 5)
    assert _launches("dense_loop") == before


@pytest.mark.cuda
def test_dense_kernel_raises_on_shapes_it_cannot_take(cuda_device):
    """A CUDA problem the kernel cannot take raises instead of running the
    plain version: n_pad above 512 or not a multiple of 4, or vectors
    beyond shared memory."""
    def problem(C, n_pad, m_pad):
        z = functools.partial(torch.zeros, device=cuda_device)
        return dl.DenseScaledProblem(
            z((C, n_pad, n_pad)), z((C, n_pad, n_pad)), z((C, m_pad, n_pad)),
            z((C, n_pad)), z((C, n_pad)), z((C, m_pad)), z((C, m_pad)),
            z((C, m_pad)))
    before = _launches("dense_loop")
    for n_pad in (640, 130):
        with pytest.raises(ValueError, match="n_pad = %d" % n_pad):
            dl.admm_iterations_dense(problem(1, n_pad, 128), 1, 1e-6, ALPHA, 0)
    with pytest.raises(ValueError, match="shared memory"):
        dl.admm_iterations_dense(problem(1, 128, 12800), 1, 1e-6, ALPHA, 0)
    assert _launches("dense_loop") == before


def _fused(cfg):
    return cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                fused_solve=True)))


@pytest.mark.cuda
def test_fused_loop_on_card_matches_cpu(cuda_device):
    """The small closed loop with fused_solve=True on the card and on the
    CPU: one fleet_admm launch per cycle, no ew_chain launch (the device
    record of a third run, which replays the earlier runs' graphs and
    gives their bits), positions within 1e-3 m over 4 cycles."""
    cfg = _fused(small_config(num_obstacles=4, horizon=8, timeout=0.5,
                              max_obstacles=4, hist=8).replace(
        goal=(6.0, 0.0, 2.0)))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 0.5)
    scen = sh.stack_scenarios(cfg, [0, 1])

    def fly():
        return cl.run_episode(cfg, scen, ref, ref.shape[0], num_cycles=4)[0]
    gpu = fly()
    fly()                       # every variant captured before the record
    again, counts = _kernel_events(fly)
    assert counts["fleet_admm"] == 4 and counts["ew_chain"] == 0
    assert torch.equal(again.pos, gpu.pos)
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


def _harness_config(fused, timeout=1.5):
    """tests/test_checkpoint.py's harness config (15 cycles), optionally
    fused."""
    cfg = small_config(num_obstacles=6, horizon=10, timeout=timeout,
                       max_obstacles=6, hist=12).replace(goal=(8.0, 0.0, 2.0))
    return _fused(cfg) if fused else cfg


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_checkpointed_rows_equal_plain_rows_on_card(cuda_device, fused,
                                                    tmp_path):
    """On the card, run_trials_checkpointed (snapshots every 6 cycles, off
    the factor-refresh cycles) gives rows identical (==) to run_trials,
    and a run cut at 6 cycles and resumed from its file gives rows
    identical to the uninterrupted one: every op of a cycle gives the
    same bits run to run (the kernels keep fixed orders, and no op of the
    loop accumulates with atomics)."""
    cfg = _harness_config(fused)
    plain = harness.run_trials(cfg, [1, 2], solver_iters=30)
    ck = harness.run_trials_checkpointed(cfg, [1, 2], str(tmp_path / "a"),
                                         chunk_cycles=6, solver_iters=30)
    assert ck == plain
    cut = str(tmp_path / "b")
    harness.run_trials_checkpointed(_harness_config(fused, 0.6), [1, 2], cut,
                                    chunk_cycles=6, solver_iters=30)
    assert harness.run_trials_checkpointed(cfg, [1, 2], cut, chunk_cycles=6,
                                           solver_iters=30) == ck


# solver options of the sync test's cases (the truncation="osqp" loop reads
# one flag per block on the host by design and is not among them), and the
# loop options of benchmark/capture.LOOP_OPTIONS it runs by name, on the
# default path and, where named "fused_...", on the fused path
_NO_SYNC = {"default": {}, "fused": dict(fused_solve=True),
            "default_polish_temporal_rho": dict(polish=True,
                                                temporal_rho=True),
            "fused_polish_temporal_rho": dict(fused_solve=True, polish=True,
                                              temporal_rho=True),
            "per_candidate_adaptive": dict(shared_factor=False,
                                           adaptive_rho=True),
            "goal_relax": "goal_relax", "drift_refresh": "drift_refresh",
            "quadrotor": "quadrotor", "use_fov": "use_fov",
            "no_predictor": "no_predictor", "flat_iter": "flat_iter",
            "stationary": "stationary", "predictor_stale": "predictor_stale",
            "fused_quadrotor": "quadrotor", "fused_use_fov": "use_fov",
            # the planner's solve_override hook at its default, passed
            "solve_override_none": {},
            # the TPU-tuned solver options
            "woodbury_candidates": dict(woodbury_candidates=True),
            "block_refine": dict(block_refine=True),
            "folded_refine": dict(folded_refine=True),
            "minv_bf16": dict(minv_dtype="bf16"),
            "warm_frac": dict(shared_refine_warm_frac=0.5),
            "fused_minv_bf16": dict(fused_solve=True, minv_dtype="bf16"),
            # the spans of utils/trace on, both paths
            "default_traced": {}, "fused_traced": dict(fused_solve=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("solve", list(_NO_SYNC), ids=list(_NO_SYNC))
def test_episode_step_does_not_synchronize(cuda_device, solve):
    """No op inside a cycle waits for the device: under
    torch.cuda.set_sync_debug_mode("error") a factor-refresh cycle (4) and
    a reuse cycle (5) of the production config run without raising, after
    4 warm-up cycles have built the kernels and the cached constants. The
    default and fused paths, and with them the polish, temporal rho, a
    factor per candidate with in-solve adaptive rho, and each loop option:
    goal relax and the drift-aware refresh decide per scenario on the
    device (the stall counter starts past the grace, so the anneal is
    live). The case solve_override_none passes the planner's
    solve_override hook its default, None; the "_traced" cases record the
    spans of utils/trace."""
    from intent_mpc_torch.benchmark.capture import option_start, with_option
    cfg = IntentMPCConfig()
    opt = _NO_SYNC[solve]
    hook = ({"solve_override": None} if solve == "solve_override_none"
            else {})
    start = None
    if isinstance(opt, str):
        cfg = with_option(cfg, opt)
        start = option_start(opt)
        opt = dict(fused_solve=solve.startswith("fused"))
    cfg = cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(cfg.planner.solver, **opt)))
    scen = sh.stack_scenarios(cfg, [0, 1])
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device="cuda")
    occ = empty_grid("cuda")
    carry = cl.init_carry(cfg, scen)
    if start is not None:
        carry = start(carry, cfg)
    for i in range(4):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i)
    torch.cuda.synchronize()
    traced = solve.endswith("_traced")
    if traced:
        trace.start()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in (4, 5):
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                       carry, i, **hook)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        spans = trace.stop()
    assert bool(torch.isfinite(carry.pos).all())
    assert [s.cycle for s in spans if s.name == "cycle"] == \
        ([4, 5] if traced else [])


# the runtime's calls that put work on the device (mpcbench/spans.RUNTIME)
_RUNTIME = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")


def _path_config(path):
    """The production config on the default or the fused solve path."""
    cfg = IntentMPCConfig()
    if path == "fused":
        cfg = cfg.replace(planner=dataclasses.replace(
            cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                    fused_solve=True)))
    return cfg


def _profiled(cfg, scen, ref, occ, carry, cycles, spans_on):
    """Run `cycles` under torch.profiler's CUDA activity (the benchmark's
    traced sub-window), the spans of utils/trace on or off. Returns
    (spans, device events, {correlation id: runtime event}); an event is
    (start_ns, end_ns, name, correlation id)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if spans_on:
            trace.start()
        for i in cycles:
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                       carry, i)
        torch.cuda.synchronize()
        spans = trace.stop()
    dev, host = [], {}
    for e in prof.profiler.kineto_results.events():
        ev = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
              e.correlation_id())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(ev)
        elif _RUNTIME.match(e.name()):
            host[e.correlation_id()] = ev
    return spans, sorted(dev), host


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "fused"])
def test_spans_and_counters_agree_with_the_device_trace(cuda_device, path):
    """The production config at S = 2, 4 warm-up cycles, then the same 4 cycles
    from a factor-refresh cycle profiled from the same carry, spans on and off
    (both eager: spans on keep engine/graph.py's rule off, and the spans-off
    window turns it off). The runtime's launch, copy and memset calls are the
    same in number (counted on the host side: CUPTI can drop device activity
    records, seen on the card in one window of five, so the device events are
    not an exact count). The registry counts 100 ew_chain launches per cycle on
    the default path, and a window whose record kept them all (up to 3 tries)
    holds exactly that many ew_chain_kernel events. On the fused path it counts
    one fleet_admm launch per cycle; each fleet_admm_kernel event starts after
    the start of the `solve` span that holds its runtime launch event (matched
    by correlation id; where none carries one, the k-th kernel and the k-th
    span)."""
    cfg = _path_config(path)
    scen = sh.stack_scenarios(cfg, [0, 1])
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device="cuda")
    occ = empty_grid("cuda")
    carry = cl.init_carry(cfg, scen)
    for i in range(4):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i)
    torch.cuda.synchronize()
    trace.reset()
    spans, dev, host = _profiled(cfg, scen, ref, occ, carry, range(4, 8),
                                 True)
    counts = trace.counters()
    with pytest.MonkeyPatch.context() as mp:
        # spans off would replay CUDA graphs (engine/graph.py): held to
        # the eager cycle, the window issues the same calls as with spans
        mp.setattr(graph, "engages", lambda *a: False)
        off_spans, _, host_off = _profiled(cfg, scen, ref, occ, carry,
                                           range(4, 8), False)
    assert off_spans == [] and len(spans) > 0
    assert len(host) == len(host_off) > 0
    solves = [s for s in spans if s.name == "solve"]
    assert len(solves) == 4
    if path == "default":
        want = 4 * cfg.planner.solver.max_iter
        assert counts["ew_chain.launches"] == want
        got = [sum("ew_chain_kernel" in e[2] for e in dev)]
        while got[-1] != want and len(got) < 3:
            _, d, _ = _profiled(cfg, scen, ref, occ, carry, range(4, 8), True)
            got.append(sum("ew_chain_kernel" in e[2] for e in d))
        assert got[-1] == want, got
        return
    assert counts["fleet_admm.launches"] == 4
    kernels = [e for e in dev if "fleet_admm_kernel" in e[2]]
    assert kernels
    matched = 0
    for k in kernels:
        rt = host.get(k[3])
        if rt is None:
            continue
        inside = [s for s in solves if s.start_ns <= rt[0] <= s.end_ns]
        assert len(inside) == 1, (rt, solves)
        assert k[0] >= inside[0].start_ns
        matched += 1
    if not matched:
        # no runtime event carried a kernel's correlation id: the order
        assert len(kernels) == 4
        assert all(k[0] >= s.start_ns for k, s in zip(kernels, solves))
    print("fleet_admm kernels matched by correlation id: %d of %d"
          % (matched, len(kernels)))


_GRAPH_COUNTERS = ("closed_loop.graph_captures", "closed_loop.graph_replays",
                   "closed_loop.graph_eager")


def _graph_counts():
    c = trace.counters()
    return tuple(c.get(k, 0) for k in _GRAPH_COUNTERS)


def _host_leaves(carry):
    """Each leaf of a carry, copied to the host."""
    return [t.to("cpu", copy=True) for t in flatten(carry)]


def _gap(a, b):
    """None where two lists of host leaves hold the same bits, else the
    largest absolute difference of a differing leaf (inf for a differing
    leaf that is not floating point, or a NaN against a number)."""
    worst = None
    for x, y in zip(a, b):
        if x.numpy().tobytes() == y.numpy().tobytes():
            continue
        d = float("inf")
        if x.is_floating_point():
            d = float((x.double() - y.double()).abs()
                      .nan_to_num(nan=float("inf")).max())
        worst = d if worst is None else max(worst, d)
    return worst


def _graph_flight(cfg, scen, ref, occ, cycles=12, flight=9):
    """`cycles` cycles from init_carry, a new flight at cycle `flight`:
    the carries returned and their leaves on the host when each was
    returned."""
    carry, i = cl.init_carry(cfg, scen), 0
    out, snaps = [], []
    for n in range(cycles):
        if n == flight:
            carry, i = cl.init_carry(cfg, scen), 0
        carry, pos = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                     carry, i)
        assert pos is carry.pos
        out.append(carry)
        snaps.append(_host_leaves(carry))
        i += 1
    return out, snaps


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "fused"])
def test_graphed_cycles_are_the_eager_cycles_on_card(cuda_device, path,
                                                     monkeypatch):
    """The production config at S = 32, 12 cycles over refresh and reuse
    cycles and a flight boundary (init_carry at cycle 9), replayed from
    CUDA graphs (engine/graph.py) and run eagerly: every carry has the
    same bits; every carry returned, 8 and more cycles back included,
    still holds the bits it had when it was returned; the counters read
    on the default path 2 eager cycles (each variant's first), 2 captures
    (the refresh and the reuse variant) and 8 replays, on the fused path
    (one variant: it factors every cycle) 1 eager, 1 capture and 10
    replays, and the eager run 12 eager cycles."""
    cfg = _path_config(path)
    scen = sh.stack_scenarios(cfg, list(range(32)))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device="cuda")
    occ = empty_grid("cuda")
    graph.clear()
    trace.reset(*_GRAPH_COUNTERS)
    with monkeypatch.context() as mp:
        mp.setattr(graph, "engages", lambda *a: False)
        _, eager = _graph_flight(cfg, scen, ref, occ)
    assert _graph_counts() == (0, 0, 12)
    trace.reset(*_GRAPH_COUNTERS)
    got, snaps = _graph_flight(cfg, scen, ref, occ)
    assert _graph_counts() == ((2, 8, 2) if path == "default" else (1, 10, 1))
    gaps = [_gap(a, b) for a, b in zip(eager, snaps)]
    print("largest gap to the eager cycle, per cycle:", gaps)
    assert gaps == [None] * 12
    for i, (carry, b) in enumerate(zip(got, snaps)):
        assert _gap(_host_leaves(carry), b) is None, \
            "carry of cycle %d overwritten" % i
    graph.clear()


@pytest.mark.cuda
def test_host_reads_and_spans_keep_the_cycle_eager_on_card(cuda_device):
    """A truncation="osqp" cycle reads the host (100 iterations: a flag
    after each of the first three blocks of 25), so its variant stays
    eager after its first run and is never captured; with spans on every
    cycle runs eagerly and records its span."""
    cfg = small_config(num_obstacles=8, horizon=10, max_obstacles=8)
    osqp = cfg.replace(planner=dataclasses.replace(
        cfg.planner, solver=dataclasses.replace(
            cfg.planner.solver, truncation="osqp", max_iter=100)))
    scen = sh.stack_scenarios(cfg, [0, 1])
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device="cuda")
    occ = empty_grid("cuda")
    graph.clear()
    trace.reset(*_GRAPH_COUNTERS, "admm.host_reads")
    carry = cl.init_carry(osqp, scen)
    for i in range(5):
        carry, _ = cl.episode_step(osqp, scen, ref, ref.shape[0], occ, carry,
                                   1 + 4 * i)
    assert trace.counters()["admm.host_reads"] >= 5
    assert _graph_counts() == (0, 0, 5)
    trace.reset(*_GRAPH_COUNTERS)
    carry = cl.init_carry(cfg, scen)
    trace.start()
    try:
        for i in range(4):
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                       carry, i)
    finally:
        spans = trace.stop()
    assert [s.cycle for s in spans if s.name == "cycle"] == [0, 1, 2, 3]
    assert _graph_counts() == (0, 0, 4)
    graph.clear()


def _device_events(cfg, scen, ref, occ, carry, cycles):
    """Device events of `cycles` under torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in cycles:
            carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                       carry, i)
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["default", "fused"])
def test_profiler_records_the_graphs_kernels(cuda_device, path, monkeypatch):
    """torch.profiler sees the kernels of replayed cycles: over 4 replays
    from a refresh cycle (S = 32) it records within 5% of the device
    events of the same 4 cycles run eagerly, and the same number of the
    path's own kernel (up to 3 tries each: CUPTI can drop records)."""
    cfg = _path_config(path)
    kernel = "fleet_admm_kernel" if path == "fused" else "ew_chain_kernel"
    scen = sh.stack_scenarios(cfg, list(range(32)))
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device="cuda")
    occ = empty_grid("cuda")
    graph.clear()
    carry = cl.init_carry(cfg, scen)
    for i in range(4):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i)
    for i in range(4, 8):       # the refresh variant captured too
        cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry, i)
    torch.cuda.synchronize()

    def counted(engaged):
        with monkeypatch.context() as mp:
            if not engaged:
                mp.setattr(graph, "engages", lambda *a: False)
            best = None
            for _ in range(3):
                ev = _device_events(cfg, scen, ref, occ, carry, range(4, 8))
                n = (len(ev), sum(kernel in e for e in ev))
                best = n if best is None or n > best else best
            return best
    trace.reset(*_GRAPH_COUNTERS)
    replayed = counted(True)
    assert _graph_counts() == (0, 12, 0)
    eager = counted(False)
    print("device events over 4 cycles: eager %s, replayed %s"
          % (eager, replayed))
    assert replayed[1] == eager[1] > 0
    assert abs(replayed[0] - eager[0]) <= 0.05 * eager[0]
    graph.clear()


@pytest.mark.cuda
def test_oracle_override_round_trip_on_card(cuda_device):
    """The f64 oracle's host round trip hands the planner card tensors:
    x, the residuals and rho_suggest float32, solved bool, y's groups
    float32, all on the card; no ew_chain launches on its cycles, and the
    carry stays finite."""
    from intent_mpc_torch.benchmark import oracle_loop
    from intent_mpc_torch.entry import tiny_setup
    cfg, scen, ref = tiny_setup(cuda_device)
    over = oracle_loop.make_oracle_override(cfg.planner)
    seen = []

    def spy(qps, warm6):
        res = over(qps, warm6)
        seen.append(res)
        return res
    carry = cl.init_carry(cfg, scen)
    trace.reset("ew_chain.launches")
    for i in range(3):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0],
                                   empty_grid(cuda_device), carry, i,
                                   solve_override=spy)
    torch.cuda.synchronize()
    assert _launches("ew_chain") == 0
    res = seen[-1]
    for t in (res.x, res.prim_res, res.dual_res, res.rho_suggest) \
            + tuple(res.y):
        assert t.is_cuda and t.dtype == torch.float32
    assert res.solved.is_cuda and res.solved.dtype == torch.bool
    assert res.x.shape == (1, 6, cfg.planner.num_vars)
    assert bool(torch.isfinite(carry.pos).all())
    assert int(carry.metrics.solve_attempts[0]) == 3


@pytest.mark.cuda
def test_pipelined_fetch_returns_each_cycles_command(cuda_device):
    """The depth-1 pipelined fetch hands back, for every cycle i, exactly
    the pos and vel that a blocking fetch of cycle i reads, and leaves
    the same carry."""
    cfg = _harness_config(False)
    scen = sh.stack_scenarios(cfg, [1, 2])
    step = bench.command_step(cfg, scen)
    b_carry, _, b_cmds = bench.blocking_cycles(
        step, cl.init_carry(cfg, scen), range(7))
    p_carry, secs, p_cmds = bench.pipelined_cycles(
        step, cl.init_carry(cfg, scen), range(7))
    assert len(secs) == 6 and len(p_cmds) == len(b_cmds) == 7
    for i, (a, b) in enumerate(zip(p_cmds, b_cmds)):
        assert a.device.type == "cpu" and torch.equal(a, b), i
    assert torch.equal(p_carry.pos, b_carry.pos)
    assert torch.equal(p_carry.vel, b_carry.vel)


@pytest.mark.cuda
def test_df_identities_exact_on_card(cuda_device):
    """The error-free transforms of ops/df.py hold exactly on the card
    (each eager op rounds on its own; -fmad does not reach PyTorch's
    elementwise kernels): s + e == a + b and p + e == a b in float64 on
    2^16 seeded pairs, the split's halves sum back and square exactly,
    and df_matvec at the polish's A shape (2510 x 385) is within 1e-12
    of the float64 product, relative to |ref| + 1."""
    from intent_mpc_torch.ops import df
    g = torch.Generator(device="cuda").manual_seed(3)
    n = 1 << 16
    a = torch.randn(n, generator=g, device="cuda")
    b = torch.randn(n, generator=g, device="cuda") * 1e-4
    s_, e = df.two_sum(a, b)
    assert torch.equal(s_.double() + e.double(), a.double() + b.double())
    assert bool((e != 0).any())
    c = torch.randn(n, generator=g, device="cuda")
    p, e = df.two_prod(a, c)
    assert torch.equal(p.double() + e.double(), a.double() * c.double())
    assert bool((e != 0).any())
    big = a * 1e6
    hi, lo = df.split(big)
    assert torch.equal(hi + lo, big)
    for h in (hi.double(), lo.double()):
        assert torch.equal((h * h).float().double(), h * h)
    M = torch.randn((4, 2510, 385), generator=g, device="cuda")
    x = torch.randn((4, 385), generator=g, device="cuda")
    mh, ml = df.df_matvec(M, x, torch.zeros_like(x))
    ref = torch.matmul(M.double(), x.double()[..., None])[..., 0]
    err = ((mh.double() + ml.double() - ref).abs() / (ref.abs() + 1)).max()
    assert float(err) < 1e-12, float(err)


@pytest.mark.cuda
def test_truncation_loop_ew_chain_bit_equal_to_grouped_step(cuda_device):
    """truncation="osqp" on the card: the termination loop with its
    elementwise tail through ew_chain gives the same bits (x, duals,
    iterations per problem) as with the grouped torch step, on 2 x 6
    seeded small QPs whose per-lane penalties stop them at different
    blocks; the chain launched once per iteration the loop ran."""
    pcfg = PlannerConfig(horizon=10, max_obstacles=4, solver=SolverConfig(
        max_iter=410, refine_iters=1, truncation="osqp"))
    qps = small_fleet_qps(pcfg, 2, "cuda")
    rho = torch.tensor([0.03, 0.01, 0.1, 0.3, 0.05, 1.0] * 2,
                       device="cuda").reshape(2, 6)
    out = {}
    for ew_kernel in (True, False):
        scfg = dataclasses.replace(pcfg.solver, ew_kernel=ew_kernel)
        trace.reset("ew_chain.launches")
        out[ew_kernel] = admmlib.admm_solve(pcfg, qps, scfg=scfg,
                                            rho_override=rho)
        torch.cuda.synchronize()
        if ew_kernel:
            assert _launches("ew_chain") == int(out[True].iters.max())
    a, b = out[True], out[False]
    assert torch.equal(a.iters, b.iters)
    assert len(set(a.iters.flatten().tolist())) > 1, a.iters
    assert torch.equal(a.x, b.x)
    for ga, gb in zip(a.y, b.y):
        assert torch.equal(ga, gb)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", [
    dict(temporal_rho=True),
    dict(temporal_rho=True, shared_factor=False, adaptive_rho=True,
         adapt_interval=10)],
    ids=["temporal_rho", "per_candidate_adaptive"])
def test_checkpointed_rows_equal_plain_rows_on_card_temporal_rho(
        cuda_device, solver, tmp_path):
    """Under temporal_rho (and with a factor per candidate and in-solve
    adaptive rho) on the card: run_trials_checkpointed gives rows
    identical (==) to run_trials, and a run cut at 6 cycles and resumed
    from its file gives rows identical to the uninterrupted one."""
    def config(timeout):
        cfg = _harness_config(False, timeout)
        return cfg.replace(planner=dataclasses.replace(
            cfg.planner, solver=dataclasses.replace(cfg.planner.solver,
                                                    **solver)))
    cfg = config(1.5)
    plain = harness.run_trials(cfg, [1, 2], solver_iters=30)
    ck = harness.run_trials_checkpointed(cfg, [1, 2], str(tmp_path / "a"),
                                         chunk_cycles=6, solver_iters=30)
    assert ck == plain
    cut = str(tmp_path / "b")
    harness.run_trials_checkpointed(config(0.6), [1, 2], cut,
                                    chunk_cycles=6, solver_iters=30)
    assert harness.run_trials_checkpointed(cfg, [1, 2], cut, chunk_cycles=6,
                                           solver_iters=30) == ck


@pytest.mark.cuda
@pytest.mark.parametrize("ticks", [1, 100])
def test_quad_plant_on_card_matches_cpu(cuda_device, ticks):
    """The rigid-body plant (no kernel of its own: eager PyTorch ops) on
    the card against its CPU run from the same seeded flying state and
    commands: after one tick within 2e-5, after 100 within 1e-3, as
    tests/test_torch_quad_plant.py holds it against JAX (each PID's
    setpoint derivative, rounding noise over the 1 ms step, within
    2e-3)."""
    from intent_mpc_torch.engine.checkpoint import flatten, unflatten
    from intent_mpc_torch.models import quad_plant as qp_
    g = torch.Generator().manual_seed(4)
    st = qp_.quad_init(torch.randn((16, 3), generator=g))
    leaves = [t + 0.1 * torch.randn(t.shape, generator=g)
              for t in flatten(st)]
    q = leaves[2]
    leaves[2] = q / q.norm(dim=-1, keepdim=True)
    st = unflatten(st, leaves)
    acc = torch.randn((16, 3), generator=g) * 2.0
    yaw = torch.rand((16,), generator=g) * 6.0 - 3.0
    cfg = qp_.QuadPlantConfig()
    cpu, card = st, unflatten(st, [t.cuda() for t in leaves])
    for _ in range(ticks):
        cpu = qp_.quad_step(cfg, cpu, acc, yaw, 0.01)
        card = qp_.quad_step(cfg, card, acc.cuda(), yaw.cuda(), 0.01)
    tol = 2e-5 if ticks == 1 else 1e-3
    for i, (a, b) in enumerate(zip(flatten(card), flatten(cpu))):
        dinput = i >= 6 and (i - 6) % 3 == 1
        torch.testing.assert_close(a.cpu(), b, rtol=tol,
                                   atol=2e-3 if dinput else tol)


@pytest.mark.cuda
def test_real_path_waits_only_for_dbscan_flags(cuda_device):
    """On the real-perception DYNUS path the only waits for the device are
    DBSCAN's reads of its "labels changed" flag, once per block of rounds
    (the counter "clustering.host_reads" of utils/trace, which chip_smoke's
    real_perception phase reports): under
    torch.cuda.set_sync_debug_mode("warn") two cycles after two warm-up
    cycles warn exactly that many times, at least once per sense tick and
    static clustering."""
    import warnings
    from intent_mpc_torch.benchmark.capture import real_dynus_config
    from intent_mpc_torch.benchmark.real_loop import static_maps
    cfg = real_dynus_config()
    scen = sh.stack_scenarios(cfg, [0, 1])
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5, device="cuda")
    occ, veto = static_maps(cfg, [0, 1], "cuda")
    carry = cl.init_carry(cfg, scen)
    for i in range(2):
        carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ, carry,
                                   i, veto_occ=veto)
    torch.cuda.synchronize()
    trace.reset("clustering.host_reads")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in (2, 3):
                carry, _ = cl.episode_step(cfg, scen, ref, ref.shape[0], occ,
                                           carry, i, veto_occ=veto)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    per_cycle = len(cfg.engine.hist_ticks) + 1
    reads = trace.counters()["clustering.host_reads"]
    assert reads >= 2 * per_cycle
    assert len(syncs) == reads, [str(w.message) for w in syncs[:3]]
    assert bool(torch.isfinite(carry.pos).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["linspace", "minsnap", "global"])
def test_goal_mode_waits_only_for_the_build_flag(cuda_device, mode):
    """Goal mode on the DYNUS goal-mode protocol (benchmark/capture.
    goal_dynus, 2 scenarios): under torch.cuda.set_sync_debug_mode("warn")
    a factor-refresh cycle (4) with every input trajectory due for a
    rebuild (the composed modes' build pass) and a reuse cycle (5), after
    4 warm-up cycles, wait for the device exactly as often as the counter
    "closed_loop.host_reads" of utils/trace says: once per cycle in the composed modes (the "does any scenario
    build" flag), never with the straight input trajectory."""
    import traceback
    import warnings
    from intent_mpc_torch.benchmark import capture as C
    cfg, run = C.goal_dynus(mode, 2, "cuda")
    carry = C.goal_init(cfg, run, "cuda")
    for i in range(4):
        carry, _ = C.goal_step(cfg, run, carry, i)
    if mode != "linspace":
        carry = C.rearm_build(carry)
    torch.cuda.synchronize()
    trace.reset("closed_loop.host_reads")
    syncs = []

    def record(message, *args, **kw):
        # where each wait happened: the Python frames of the warning
        if "synchronizing CUDA" in str(message):
            syncs.append(" <- ".join(
                "%s:%d" % (os.path.basename(f.filename), f.lineno)
                for f in traceback.extract_stack()[-6:-1][::-1]))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in (4, 5):
                carry, _ = C.goal_step(cfg, run, carry, i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reads = trace.counters().get("closed_loop.host_reads", 0)
    assert reads == (0 if mode == "linspace" else 2)
    assert len(syncs) == reads, sorted(set(syncs))
    assert bool(torch.isfinite(carry.pos).all())
    if mode != "linspace":
        assert not bool(carry.need_ref.any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["linspace", "global"])
def test_goal_mode_checkpoint_resumes_bit_exactly_on_card(cuda_device, mode,
                                                          tmp_path):
    """The DYNUS goal-mode protocol at 2 scenarios on the card: 5 cycles
    uninterrupted against 2 cycles, a checkpoint (engine/checkpoint.py;
    the composed mode's input trajectory, its length and the build flag
    among the leaves), load_checkpoint with the allocation, and 3 more
    cycles: every leaf equal (the composed mode builds at cycle 0, and
    again at cycle 2 after a re-arm in both runs)."""
    from intent_mpc_torch.benchmark import capture as C
    from intent_mpc_torch.engine import checkpoint as ckpt
    cfg, run = C.goal_dynus(mode, 2, "cuda")

    def steps(carry, cycles):
        for i in cycles:
            if i == 2 and mode != "linspace":
                carry = C.rearm_build(carry)
            carry, _ = C.goal_step(cfg, run, carry, i)
        return carry
    whole = steps(C.goal_init(cfg, run, "cuda"), range(5))
    half = steps(C.goal_init(cfg, run, "cuda"), range(2))
    path = str(tmp_path / "goal")
    ckpt.save_checkpoint(path, half, 2, [0, 1])
    loaded, cycle, _, _ = ckpt.load_checkpoint(path, cfg, device="cuda",
                                               ref_len=run.ref.shape[0])
    assert cycle == 2
    resumed = steps(loaded, range(2, 5))
    for a, b in zip(ckpt.flatten(whole), ckpt.flatten(resumed)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mapping_on_card_matches_cpu(cuda_device):
    """The small world's 6 frames on the card and on the CPU (the same
    projected points): log-odds bit-equal, octree search / is_blocked /
    segment_free answers equal in both unknown-space semantics, the RRT
    over each octree within 1e-6 m (chip_smoke.check_mapping_small)."""
    out = check_mapping_small(cuda_device)
    assert out["log_odds_bit_equal"] and out["answers_equal"]
    assert out["occupied_voxels"] > 0


@pytest.mark.cuda
def test_perception_fusion_on_card_matches_cpu(cuda_device):
    """U-map boxes, bird's-eye track tables and mutual-best fusion equal on
    the card and the CPU over the small world's frames; the YOLO network
    within 1e-4 of the CPU; decode and fuse_external_2d equal
    (chip_smoke.check_fusion_small)."""
    out = check_fusion_small(cuda_device)
    assert out["tracks_equal"] and out["fused_equal"] and out["decode_equal"]
    assert out["yolo_max_abs_diff"] <= 1e-4


@pytest.mark.cuda
def test_esdf_and_inflation_on_card_match_cpu(cuda_device):
    """The ESDF (exact min-plus passes, with a chunk small enough to split
    every axis) and the inflation of seeded grids equal the CPU's."""
    from intent_mpc_torch.models import mapping as mp
    g = torch.Generator().manual_seed(0)
    occ = (torch.rand((2, 40, 31, 17), generator=g) > 0.93).to(torch.int8)
    cfg = mp.MappingConfig()
    want = mp.esdf(occ, 0.15)
    got = mp.esdf(occ.to(cuda_device), 0.15).cpu()
    assert torch.equal(got, want)
    assert torch.equal(mp.inflate(cfg, occ.to(cuda_device), 0.15).cpu(),
                       mp.inflate(cfg, occ, 0.15))


@pytest.mark.cuda
def test_mapping_frame_does_not_synchronize(cuda_device):
    """One frame of integrate_cloud + to_occupancy_grid + octo.from_log_odds
    + segment_free runs under torch.cuda.set_sync_debug_mode("error")
    after a warm-up frame has built the cached constants: nothing on the
    mapping path waits for the device."""
    from intent_mpc_torch.benchmark.capture import small_frames
    from intent_mpc_torch.models import mapping as mp
    from intent_mpc_torch.models import octo
    fr = small_frames(device=cuda_device)
    cfg = mp.MappingConfig(resolution=0.2)
    m = mp.init_map((0.0, 0.0, 0.0), (10.0, 6.0, 3.0), cfg, batch=2,
                    device=cuda_device)
    a = fr.cam_pos[0][:, None].expand(2, 16, 3).contiguous()
    b = fr.obs_pos[0][:, :4].repeat(1, 4, 1)

    def frame(m, f):
        m = mp.integrate_cloud(cfg, m, fr.cam_pos[f], fr.pts[f], fr.valid[f])
        g = mp.to_occupancy_grid(cfg, m)
        o = octo.from_log_odds(m, cfg, levels=3, ignore_unknown=False)
        return m, g, octo.segment_free(o, a, b)
    m, _, _ = frame(m, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m, g, free = frame(m, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert g.grid.shape == m.log_odds.shape and free.shape == (2, 16)
    assert not bool(free.all())


@pytest.mark.cuda
def test_exploration_on_card_matches_cpu(cuda_device):
    """The exploration stack's small inputs on the card against the CPU
    (chip_smoke.check_exploration_small): 4 DEP cycles and one with
    line-of-sight gains, the next-best view, RRT*, the PRM, the wavefront,
    30 B-spline steps, the divider and TOPP; masks and counts equal,
    positions within 1e-5 m, TOPP within 1e-5 relative."""
    out = check_exploration_small(cuda_device)
    assert out["exact_equal"]


@pytest.mark.cuda
def test_dep_step_does_not_synchronize(cuda_device):
    """One dep_step at tests/test_dep.py's size (two explorers) runs under
    torch.cuda.set_sync_debug_mode("error") after a warm-up step has built
    the cached constants: no data-dependent host read."""
    from chip_smoke import _dep_small_map, _small_cfg
    from intent_mpc_torch.models import dep
    from intent_mpc_torch.utils import prng
    cfg = _small_cfg()
    lo = _dep_small_map()[None].expand(2, -1, -1, -1).to(cuda_device)
    start = torch.tensor([[1.0, 4.0, 1.5], [2.0, 6.0, 1.0]],
                         device=cuda_device)
    yaw = torch.zeros(2, device=cuda_device)
    keys = prng.prng_key(torch.tensor([0, 5]), cuda_device)
    st = dep.dep_init(cfg, start, device=cuda_device)
    st, _ = dep.dep_step(cfg, lo, (0.0, 0.0, 0.0), 0.5, st, start, yaw,
                         prng.fold_in(keys, 0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, plan = dep.dep_step(cfg, lo, (0.0, 0.0, 0.0), 0.5, st, start,
                                yaw, prng.fold_in(keys, 1))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(plan.success.all()) and int(st.valid.sum()) > 2


@pytest.mark.cuda
def test_solver_knobs_on_card_match_cpu(cuda_device):
    """Each TPU-tuned solver option (Woodbury candidates, block and folded
    refinement, the bf16 factor, two-phase refinement) on the small
    config for 4 cycles, card against CPU, within chip_smoke.KNOB_TOL
    with equal solve counts."""
    lines = check_knobs_small(cuda_device)
    assert [ln["solve"] for ln in lines] == ["woodbury_candidates",
                                             "block_refine", "folded_refine",
                                             "minv_bf16", "warm_frac"]


@pytest.mark.cuda
def test_north_star_parity_on_card(cuda_device):
    """The north-star check of tests/test_fullscale_parity.py on the card:
    the horizon-30 QP through build_qp, admm_solve (2000 iterations, each
    one ew_chain launch and four of the constraint operator, refine 1 by
    CG, and one for the first z) and polish against the port's float64
    oracle:
    the polish accepted, positions within 1e-3 m and accelerations within
    1e-1 (the unpolished iterate within 2e-2 m and 1.5)."""
    out = check_north_star(cuda_device)
    assert out["launches"] == {"ew_chain": 2000, "fleet_admm": 0,
                               "dense_loop": 0, "constraint_op": 8001}
    assert out["accepted"]
    b = NORTH_STAR_BOUNDS
    assert out["pos_err"] < b["pos"] and out["acc_err"] < b["acc"], out
    assert out["raw_pos_err"] < b["raw_pos"], out
    assert out["raw_acc_err"] < b["raw_acc"], out


@pytest.mark.cuda
def test_fleet_world_one_over_nccl_on_card(cuda_device, monkeypatch):
    """One NCCL rank on cuda:0 in a process of its own
    (parallel/launch.spawn): its per-scenario metrics and aggregate equal
    the one-device batch_rollout of the same seeds, and the inventory of
    its rollout is the two all-reduces, 32 bytes."""
    from intent_mpc_torch.parallel import launch
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.abspath(
        __file__)) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res, = launch.spawn("torch_fleet_worker:fleet_rollout", 1, "nccl",
                        kwargs=dict(seeds=list(range(4)), iters=20, cycles=5,
                                    inventory_cycles=2), timeout=600)
    assert res["world"] == 1
    assert res["metrics"] == res["metrics_one_process"]
    assert res["agg"] == res["agg_one_process"]
    assert res["report"] == {"counts": {"all-reduce": 2}, "total_bytes": 32}


@pytest.mark.cuda
def test_dryrun_multichip_one_rank_over_nccl(cuda_device):
    """The toy flight of entry.dryrun_multichip(1) over NCCL (its rank,
    entry.dryrun_rank, spawned with production=False) reaches the goal in
    every episode and its inventory is the two all-reduces."""
    from intent_mpc_torch.parallel import launch
    out = launch.spawn("intent_mpc_torch.entry:dryrun_rank", 1, "nccl",
                       kwargs=dict(production=False), timeout=600)[0]
    assert out["backend"] == "nccl" and out["device"] == "cuda:0"
    assert out["success_rate"] == 1.0 and out["collision_rate"] == 0.0
    assert out["collective_ops"] == {"all-reduce": 2}
    assert out["collective_bytes"] == 32
