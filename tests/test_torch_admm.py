"""Port parity: intent_mpc_torch.ops.admm and ops.block_chol against the
JAX package and the float64 numpy oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.ops import admm as jadmm
from intent_mpc_tpu.ops import block_chol as jbc
from intent_mpc_tpu.ops import qp as jqp
from intent_mpc_tpu.oracle import native
from intent_mpc_tpu.oracle import numpy_ref as oracle
from intent_mpc_torch.ops import admm as tadmm
from intent_mpc_torch.ops import block_chol as tbc
from intent_mpc_torch.ops import qp as tqp

from test_qp import _random_problem
from test_torch_qp import build_both, configs, stack_jax, to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    jcfg, tcfg = configs(max_iter=60)
    jq, tq = build_both(jcfg, tcfg, 4, 3)
    return jcfg, tcfg, jq, tq


def test_ruiz_matches(problem):
    """Ruiz scaling: max/rsqrt/mean in float32; rtol 1e-5 covers the
    rsqrt and mean rounding of three sweeps."""
    jcfg, tcfg, jq, tq = problem
    js = jadmm.ruiz_equilibrate(jcfg, jq, jqp.hessian_diag(jcfg), 3)
    ts = tadmm.ruiz_equilibrate(tcfg, tq, tqp.hessian_diag(tcfg), 3)
    np.testing.assert_allclose(ts.D.numpy(), np.asarray(js.D), rtol=1e-5)
    for a, b in zip(ts.E, js.E):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    np.testing.assert_allclose(float(ts.c), float(js.c), rtol=1e-5)


def _scaled_inputs(cfg, qp, mod, qpmod):
    sc = mod.ruiz_equilibrate(cfg, qp, qpmod.hessian_diag(cfg), 3)
    h_s = sc.c * sc.D * sc.D * qpmod.hessian_diag(cfg)
    rho = qpmod.rho_vec(cfg, qp, 0.1, 1e3)
    rho_inner = rho.map(lambda r, e: r * e * e, sc.E)
    return h_s, rho_inner, sc.D


def test_structured_minv_matches_jax_and_dense_inverse(problem):
    """Explicit inverse of the scaled normal matrix. The port factors each
    13x13 block with LAPACK's Cholesky where JAX unrolls rank-1 updates,
    so the two agree to float32 factorization rounding: rtol 1e-4 with an
    atol of 1e-4 of the largest entry (entries span many decades and the
    small ones come from cancellation). Also held against the float64
    inverse of the dense assembly."""
    jcfg, tcfg, jq, tq = problem
    jh, jr, jD = _scaled_inputs(jcfg, jq, jadmm, jqp)
    th, tr, tD = _scaled_inputs(tcfg, tq, tadmm, tqp)
    jm = np.asarray(jbc.structured_minv(jcfg, jq, jh, 1e-6, jr, jD))
    tm = tbc.structured_minv(tcfg, tq, th, 1e-6, tr, tD).numpy()
    scale = np.abs(jm).max()
    np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-4 * scale)
    M = tqp.assemble_normal_matrix(tcfg, tq, th, 1e-6, tr, col_scale=tD)
    dense = np.linalg.inv(M.numpy().astype(np.float64))
    np.testing.assert_allclose(tm, dense, rtol=1e-4, atol=1e-4 * scale)


def test_chol_inv_small_inverts():
    rng = np.random.RandomState(0)
    a = rng.randn(5, 13, 13)
    S = torch.as_tensor(a @ a.transpose(0, 2, 1) + 13 * np.eye(13),
                        dtype=torch.float32)
    L, J = tbc.chol_inv_small(S)
    eye = torch.eye(13).expand(5, 13, 13)
    np.testing.assert_allclose((J @ L).numpy(), eye.numpy(), atol=1e-5)
    np.testing.assert_allclose((L @ L.mT).numpy(), S.numpy(), rtol=1e-5,
                               atol=1e-4)


def _candidates(jcfg, tcfg):
    """Three candidate QPs (seeds 0-2) and their mean, as the planner
    factors it: mean of every leaf, union of the obstacle activity."""
    pairs = [build_both(jcfg, tcfg, 4, 3, seed=s) for s in range(3)]
    jqs = stack_jax([p[0] for p in pairs])
    jmean = jax.tree.map(lambda a: jnp.mean(a, axis=0), jqs)._replace(
        obs_active=jnp.max(jqs.obs_active, axis=0))
    return jqs, to_torch(jqs, tqp.QPData), jmean, to_torch(jmean, tqp.QPData)


def _with(cfg, **kw):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, **kw))


@pytest.fixture(scope="module")
def candidates():
    # refine_iters=1, as tests/test_qp.py runs the per-candidate path for
    # its tightest parity: with 0 the x-update is Minv @ rhs alone and
    # carries Minv's float32 factorization rounding straight into x
    jcfg, tcfg = configs(max_iter=60, refine_iters=1)
    return (jcfg, tcfg) + _candidates(jcfg, tcfg)


@pytest.mark.parametrize("ew_kernel", [False, True])
@pytest.mark.parametrize("path", ["per_candidate", "shared_cg2"])
@pytest.mark.parametrize("iters", [1, 10, 60])
def test_admm_iterates_match_jax(candidates, path, ew_kernel, iters):
    """admm_solve after 1, 10 and 60 iterations from the same warm start:
    the per-candidate path (factor=None, Ruiz + structured Minv per QP) and
    the shared-factor CG-2 path (one factor of the candidate mean, CG
    warm-started from the previous x-tilde), with the elementwise tail as
    the grouped step or through ew_chain. The port runs each against the
    JAX package with the same flag. Tolerance as test_pallas_ew: x atol
    2e-5 / rtol 1e-4; prim_res atol 1e-4 / rtol 1e-3. On the shared path
    x gets atol 1e-4 (5e-6 of max|x| ~ 20): the two packages round the
    shared inverse differently (cond(M) ~ 9e4; the inverses agree to
    ~4e-5 of their largest entry, each as close to the float64 inverse),
    and a truncated CG-2 step depends on its preconditioner to first
    order."""
    jcfg, tcfg, jqs, tqs, jmean, tmean = candidates
    jcfg, tcfg = _with(jcfg, ew_kernel=ew_kernel), _with(tcfg, ew_kernel=ew_kernel)
    rng = np.random.RandomState(7)
    warm = (0.1 * rng.randn(3, jcfg.num_vars)).astype(np.float32)
    if path == "per_candidate":
        jr = jax.vmap(lambda q, x: jadmm.admm_solve(jcfg, q, x, iters))(
            jqs, jnp.asarray(warm))
        tr = tadmm.admm_solve(tcfg, tqs, torch.as_tensor(warm), iters)
    else:
        jf = jadmm.admm_factor(jcfg, jmean)
        jr = jax.vmap(lambda q, x: jadmm.admm_solve(jcfg, q, x, iters,
                                                    factor=jf))(
            jqs, jnp.asarray(warm))
        tf = tadmm.admm_factor(tcfg, tmean)
        tr = tadmm.admm_solve(tcfg, tqs, torch.as_tensor(warm), iters,
                              factor=tf)
    x_atol = 2e-5 if path == "per_candidate" else 1e-4
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=x_atol,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.prim_res.numpy(), np.asarray(jr.prim_res),
                               atol=1e-4, rtol=1e-3)


def test_ew_and_grouped_steps_identical_on_cpu(candidates):
    """On CPU tensors ew_chain runs its plain version, whose operations
    are the grouped step's: the two solver branches agree exactly."""
    _, tcfg, _, tqs, _, tmean = candidates
    tf = tadmm.admm_factor(tcfg, tmean)
    a = tadmm.admm_solve(_with(tcfg, ew_kernel=True), tqs, factor=tf)
    b = tadmm.admm_solve(_with(tcfg, ew_kernel=False), tqs, factor=tf)
    assert torch.equal(a.x, b.x)


def _reference_case(num_active, with_static):
    """The port's config and QP, and the same QP in the float64 oracle's
    dense form (P, q, A, l, u)."""
    jcfg, tcfg = configs(max_iter=400, refine_iters=1)
    K = tcfg.max_obstacles
    _, tq = build_both(jcfg, tcfg, K, num_active, with_static=with_static)
    x0, xref, oxyz, osize, yaw, is_dyn, active, lin = _random_problem(
        jcfg, K, num_active, 0, with_static)
    ka = num_active
    dense = oracle.build_reference_qp(
        jcfg, x0, xref, oxyz[:, :ka], osize[:, :ka], yaw[:, :ka],
        is_dyn[:, :ka], lin)
    return tcfg, tq, dense


def _assert_converged_near(tcfg, tq, x_ref):
    res = tadmm.admm_solve(tcfg, tq, max_iter=1000)
    x = res.x.numpy().astype(np.float64)
    H, W = tcfg.horizon, tcfg.mpc_window
    assert float(res.prim_res) < 5e-2 and bool(res.solved)
    np.testing.assert_allclose(x[:8 * H].reshape(H, 8)[:, :3],
                               x_ref[:8 * H].reshape(H, 8)[:, :3], atol=5e-3)
    np.testing.assert_allclose(x[8 * H:].reshape(W, 5)[:, :3],
                               x_ref[8 * H:].reshape(W, 5)[:, :3], atol=5e-2)


@pytest.mark.parametrize("num_active,with_static", [(0, False), (3, True)])
def test_converged_solve_matches_oracle(num_active, with_static):
    """A converged float32 solve against the float64 oracle, to the float32
    floor used by tests/test_qp.py (positions 5e-3, accelerations 5e-2)."""
    tcfg, tq, (P, q, A, l, u) = _reference_case(num_active, with_static)
    x_ref, _ = oracle.solve_qp_dense(P, q, A, l, u, max_iter=20000, eps=1e-10)
    _assert_converged_near(tcfg, tq, x_ref)


@pytest.mark.parametrize("num_active,with_static", [(0, False), (3, True)])
def test_converged_solve_matches_native_oracle(num_active, with_static):
    """The same converged float32 solve against the C++ oracle
    (intent_mpc_tpu/oracle/native.py, float64 OSQP-style ADMM run to
    eps 1e-10), with the same tolerances: positions 5e-3, accelerations
    5e-2. Skipped where the C++ library cannot be built."""
    if not native.available():
        pytest.skip("native C++ QP solver unavailable (no g++ build)")
    tcfg, tq, (P, q, A, l, u) = _reference_case(num_active, with_static)
    x_ref, _, status, iters = native.solve_qp(np.diag(P), q, A, l, u,
                                              max_iter=20000, eps=1e-10)
    assert status == 0, "native solver did not converge in %d iters" % iters
    _assert_converged_near(tcfg, tq, x_ref)


def test_unported_options_raise(problem):
    _, tcfg, _, tq = problem
    for kw in ({"truncation": "osqp"}, {"woodbury_candidates": True},
               {"flat_iter": True}, {"minv_dtype": "bf16"}):
        with pytest.raises(NotImplementedError):
            tadmm.admm_solve(_with(tcfg, **kw), tq, max_iter=1)
