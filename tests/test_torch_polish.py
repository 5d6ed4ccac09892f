"""Port parity: intent_mpc_torch.ops.polish against the JAX package's
ops/polish.py and the port's float64 oracle (intent_mpc_torch/oracle/
numpy_ref.py, polish on), on the
problems of tests/test_polish.py.

Both polishes start from the same JAX ADMM iterate (800 iterations,
refine 1) and its duals. The limits against the oracle are
tests/test_polish.py's (positions 1e-3, accelerations 1e-1). Against the
JAX polish the port is held to 1e-5 in x: both converge the same pinned
KKT system with compensated residuals, and the readings agree to ~3e-8;
the two packages' float32 Schur factors differ only in their rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.ops import polish as jpol
from intent_mpc_tpu.ops.admm import admm_solve as jadmm_solve
from intent_mpc_torch.ops import polish as tpol
from intent_mpc_torch.ops import qp as tqp
from intent_mpc_torch.oracle import numpy_ref

import test_qp as tq
from test_torch_qp import configs, stack_jax, to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfgs():
    return configs(max_iter=800, refine_iters=1)


def _inputs(cfgs, seed, iters=None):
    """The JAX QP, its ADMM iterate and duals, the port's copies, and the
    problem's dense QP as the port's float64 oracle builds it."""
    jcfg, tcfg = cfgs
    jq, _, _ = tq._build_both(jcfg, 4, 3, seed=seed, with_static=True)
    x0, xref, oxyz, osize, yaw, is_dyn, _, lin = tq._random_problem(
        jcfg, 4, 3, seed, with_static=True)
    dense = numpy_ref.build_reference_qp(
        tcfg, x0, xref, oxyz[:, :3], osize[:, :3], yaw[:, :3],
        is_dyn[:, :3], lin)
    res = jadmm_solve(jcfg, jq, max_iter=iters)
    return (jq, res, dense, to_torch(jq, tqp.QPData),
            torch.as_tensor(np.array(res.x)), to_torch(res.y, tqp.ConVec))


def _pos_acc_err(cfg, x, x_ref):
    H, W = cfg.horizon, cfg.mpc_window
    x = np.asarray(x, np.float64)
    pos = np.abs(x[:8 * H].reshape(H, 8)[:, :3]
                 - x_ref[:8 * H].reshape(H, 8)[:, :3]).max()
    acc = np.abs(x[8 * H:].reshape(W, 5)[:, :3]
                 - x_ref[8 * H:].reshape(W, 5)[:, :3]).max()
    return pos, acc


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_polish_matches_jax_and_oracle(cfgs, seed):
    jcfg, tcfg = cfgs
    jq, res, (P, q, A, l, u), tq_, tx, ty = _inputs(cfgs, seed)
    x_c, _ = numpy_ref.solve_qp_dense(P, q, A, l, u, max_iter=20000,
                                      eps=1e-10, polish=True)
    tp = tpol.polish(tcfg, tq_, tx, ty)
    jp = jpol.polish(jcfg, jq, res.x, res.y)
    assert bool(tp.accepted) and bool(jp.accepted), seed
    pos, acc = _pos_acc_err(tcfg, tp.x.numpy(), x_c)
    assert pos < 1e-3, f"seed {seed}: pos {pos:.2e}"
    assert acc < 1e-1, f"seed {seed}: acc {acc:.2e}"
    np.testing.assert_allclose(tp.x.numpy(), np.asarray(jp.x), rtol=0,
                               atol=1e-5)
    assert float(tp.kkt_res) < 1e-4 and float(jp.kkt_res) < 1e-4


def test_polish_rejected_passes_through(cfgs):
    """An iterate 3 ADMM iterations in is rejected by both gates, and the
    port hands back its input unchanged (bit for bit)."""
    jcfg, tcfg = cfgs
    jq, res, _, tq_, tx, ty = _inputs(cfgs, 0, iters=3)
    tp = tpol.polish(tcfg, tq_, tx, ty)
    jp = jpol.polish(jcfg, jq, res.x, res.y)
    assert not bool(jp.accepted) and not bool(tp.accepted)
    assert torch.equal(tp.x, tx)


def test_polish_batched_equals_sequential(cfgs):
    """A batch of three problems (two converged iterates, accepted, and one
    3 iterations in, rejected) polishes as each does alone: the active
    set, the dual warm start and the gate are per problem. Held to 1e-5
    (the batched Schur factor may round differently), acceptance
    equal, and the rejected problem passes its input through exactly."""
    jcfg, tcfg = cfgs
    items = [_inputs(cfgs, 0), _inputs(cfgs, 3, iters=3), _inputs(cfgs, 11)]
    jqs = stack_jax([it[0] for it in items])
    tqb = to_torch(jqs, tqp.QPData)
    txb = torch.stack([it[4] for it in items])
    tyb = tqp.ConVec(*(torch.stack(g) for g in zip(*[it[5] for it in items])))
    out = tpol.polish(tcfg, tqb, txb, tyb)
    assert out.accepted.tolist() == [True, False, True]
    for i, it in enumerate(items):
        single = tpol.polish(tcfg, it[3], it[4], it[5])
        assert bool(out.accepted[i]) == bool(single.accepted)
        np.testing.assert_allclose(out.x[i].numpy(), single.x.numpy(),
                                   rtol=0, atol=1e-5)
    assert torch.equal(out.x[1], txb[1])
    jb = jax.vmap(lambda q, x, y: jpol.polish(jcfg, q, x, y))(
        jqs, jnp.stack([it[1].x for it in items]),
        stack_jax([it[1].y for it in items]))
    np.testing.assert_array_equal(np.asarray(jb.accepted),
                                  out.accepted.numpy())
    np.testing.assert_allclose(out.x.numpy(), np.asarray(jb.x), rtol=0,
                               atol=1e-5)
