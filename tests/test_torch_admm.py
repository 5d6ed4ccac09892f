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


# (shared_refine_mode, shared_refine_x0) of the flat-iteration cases, as
# tests/test_qp.py::test_flat_iteration_matches_grouped runs them
FLAT_MODES = [("cg", "prev"), ("cg", "minv"), ("stationary", "prev")]


@pytest.mark.parametrize("iters", [1, 10, 60])
@pytest.mark.parametrize("mode", FLAT_MODES, ids=lambda m: "-".join(m))
def test_flat_iterates_match_grouped_and_jax(candidates, mode, iters):
    """flat_iter (ops/admm._solve_flat) on the shared factor, after 1, 10
    and 60 iterations from the same warm start: against the port's own
    grouped loop with the limits of the JAX package's test (x within
    5e-4, each dual group within 2e-3 of its largest entry, prim_res rtol
    1e-3: the flat products sum in another order, and the z clip turns a
    last-ulp difference on a row at its bound into a discrete one), and
    against JAX's flat loop with the shared-path limits of
    test_admm_iterates_match_jax (x atol 1e-4 / rtol 1e-4, prim_res atol
    1e-4 / rtol 1e-3)."""
    jcfg, tcfg, jqs, tqs, jmean, tmean = candidates
    kw = dict(shared_refine_mode=mode[0], shared_refine_x0=mode[1])
    jflat = _with(jcfg, flat_iter=True, **kw)
    tflat, tgroup = (_with(tcfg, flat_iter=f, **kw) for f in (True, False))
    warm = (0.1 * np.random.RandomState(7).randn(3, jcfg.num_vars)
            ).astype(np.float32)
    jf = jadmm.admm_factor(jflat, jmean)
    jr = jax.vmap(lambda q, x: jadmm.admm_solve(jflat, q, x, iters,
                                                factor=jf))(
        jqs, jnp.asarray(warm))
    tf = tadmm.admm_factor(tflat, tmean)
    tr = tadmm.admm_solve(tflat, tqs, torch.as_tensor(warm), iters, factor=tf)
    tg = tadmm.admm_solve(tgroup, tqs, torch.as_tensor(warm), iters,
                          factor=tf)
    assert float((tr.x - tg.x).abs().max()) < 5e-4
    for name, a, b in zip(tg.y._fields, tg.y, tr.y):
        rel = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-9)
        assert rel < 2e-3, (name, rel)
    np.testing.assert_allclose(tr.prim_res.numpy(), tg.prim_res.numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.prim_res.numpy(), np.asarray(jr.prim_res),
                               atol=1e-4, rtol=1e-3)


def test_flat_iteration_launches_no_ew_chain(candidates, monkeypatch):
    """JAX dispatches the flat loop before the elementwise kernel's branch,
    so with flat_iter and ew_kernel both on the solve never calls
    ew_chain; without a factor flat_iter does not apply and it does."""
    _, tcfg, _, tqs, _, tmean = candidates
    calls = []
    chain = tadmm.ew_chain

    def count(*a, **k):
        calls.append(1)
        return chain(*a, **k)
    monkeypatch.setattr(tadmm, "ew_chain", count)
    cfg = _with(tcfg, flat_iter=True, ew_kernel=True)
    tadmm.admm_solve(cfg, tqs, max_iter=5, factor=tadmm.admm_factor(cfg,
                                                                     tmean))
    assert not calls
    tadmm.admm_solve(cfg, tqs, max_iter=5)
    assert len(calls) == 5


@pytest.mark.parametrize("path", ["shared", "per_candidate"])
def test_stationary_refinement_matches_jax(candidates, path):
    """shared_refine_mode="stationary": each x-update is Minv rhs plus
    `refine` steps x += Minv (rhs - M x) against the candidate's own
    operator (shared_refine_iters 3 on the shared factor; refine_iters 1
    per candidate), 60 iterations from the same warm start, against JAX
    with the limits of test_admm_iterates_match_jax's paths."""
    jcfg, tcfg, jqs, tqs, jmean, tmean = candidates
    kw = dict(shared_refine_mode="stationary", shared_refine_iters=3)
    jcfg, tcfg = _with(jcfg, **kw), _with(tcfg, **kw)
    warm = (0.1 * np.random.RandomState(7).randn(3, jcfg.num_vars)
            ).astype(np.float32)
    if path == "shared":
        jf = jadmm.admm_factor(jcfg, jmean)
        jr = jax.vmap(lambda q, x: jadmm.admm_solve(jcfg, q, x, factor=jf))(
            jqs, jnp.asarray(warm))
        tr = tadmm.admm_solve(tcfg, tqs, torch.as_tensor(warm),
                              factor=tadmm.admm_factor(tcfg, tmean))
    else:
        jr = jax.vmap(lambda q, x: jadmm.admm_solve(jcfg, q, x))(
            jqs, jnp.asarray(warm))
        tr = tadmm.admm_solve(tcfg, tqs, torch.as_tensor(warm))
    x_atol = 1e-4 if path == "shared" else 2e-5
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=x_atol,
                               rtol=1e-4)
    np.testing.assert_allclose(tr.prim_res.numpy(), np.asarray(jr.prim_res),
                               atol=1e-4, rtol=1e-3)


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
    """Every solver option runs now (tests/test_torch_solver_knobs.py
    holds the TPU-tuned ones against JAX): admm_solve takes each, with and
    without a factor, and only a value that names no mode raises."""
    _, tcfg, _, tq = problem
    for kw in ({"block_refine": True}, {"woodbury_candidates": True},
               {"folded_refine": True}, {"minv_dtype": "bf16"},
               {"shared_refine_warm_frac": 0.5}):
        cfg = _with(tcfg, **kw)
        for fac in (None, tadmm.admm_factor(cfg, tq)):
            res = tadmm.admm_solve(cfg, tq, max_iter=1, factor=fac)
            assert bool(torch.isfinite(res.x).all()), kw
    with pytest.raises(ValueError, match="shared_refine_mode"):
        tadmm.admm_solve(_with(tcfg, shared_refine_mode="jacobi"), tq,
                         max_iter=1)


# ---------------------------------------------------------------------------
# truncation="osqp" and the in-solve adaptive rho
# ---------------------------------------------------------------------------

# per-lane base penalties that stop the four lanes of _truncation_batch at
# different blocks (200, 325 and 350 iterations) or not before the cap
TRUNC_RHO = np.array([0.03, 0.01, 0.1, 0.3], np.float32)


@pytest.fixture(scope="module")
def truncation_batch():
    """Four copies of one QP (2 of 4 slots active), as both packages hold
    it; their lanes differ only in rho_override (TRUNC_RHO)."""
    jcfg, tcfg = configs(max_iter=400, refine_iters=1)
    jq, _ = build_both(jcfg, tcfg, 4, 0, seed=3)
    jqs = stack_jax([jq] * 4)
    return jcfg, tcfg, jqs, to_torch(jqs, tqp.QPData)


@pytest.mark.parametrize("ew_kernel", [False, True])
def test_osqp_truncation_matches_jax(truncation_batch, ew_kernel):
    """truncation="osqp" at max_iter 410, check interval 25 (port of
    tests/test_qp.py::test_osqp_truncation_emulation): each lane freezes
    at the first block end where OSQP's unscaled eps_abs/eps_rel test
    holds, and the lanes that never meet it run the 400 iterations of the
    full blocks plus the remainder block of 10. The lanes ran 200, 325,
    350 and 410 iterations. Per lane the port's iterate is bit-equal to
    its own fixed-schedule solve of that many iterations, the JAX
    package's iterate equals JAX's fixed schedule of the same count
    (atol 1e-6, JAX's own limit), and port and JAX agree to atol 1e-4
    on x (~2.7e-5 read after 400 iterations) and rtol 1e-3 on prim_res.
    A frozen iterate meets the termination test it stopped on."""
    jcfg, tcfg, jqs, tqs = truncation_batch
    jc = _with(jcfg, truncation="osqp", max_iter=410)
    tc = _with(tcfg, truncation="osqp", max_iter=410, ew_kernel=ew_kernel)
    jr = jax.vmap(lambda q, r: jadmm.admm_solve(jc, q, rho_override=r))(
        jqs, jnp.asarray(TRUNC_RHO))
    tadmm.HOST_READS = 0
    tr = tadmm.admm_solve(tc, tqs, rho_override=torch.as_tensor(TRUNC_RHO))
    assert tr.iters.tolist() == [200, 325, 350, 410]
    assert tadmm.HOST_READS == 15          # 16 full blocks, no read after
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tr.prim_res.numpy(), np.asarray(jr.prim_res),
                               rtol=1e-3)
    for i, k in enumerate(tr.iters.tolist()):
        tf = tadmm.admm_solve(_with(tcfg, ew_kernel=ew_kernel), tqs,
                              max_iter=k,
                              rho_override=torch.as_tensor(TRUNC_RHO))
        assert torch.equal(tf.x[i], tr.x[i]), (i, k)
        jf = jax.vmap(lambda q, r: jadmm.admm_solve(
            jcfg, q, max_iter=k, rho_override=r))(jqs, jnp.asarray(TRUNC_RHO))
        np.testing.assert_allclose(np.asarray(jr.x[i]), np.asarray(jf.x[i]),
                                   atol=1e-6)
    sc = tc.solver
    hdiag = tqp.hessian_diag(tcfg)
    for i in range(3):                     # the lanes that froze
        q = tadmm._flatten(tqs, 1)
        qi = tqp.QPData(*(tqp.ConVec(*(g[i] for g in v))
                          if isinstance(v, tqp.ConVec) else v[i] for v in q))
        ax = tqp.a_matvec(tcfg, qi, tr.x[i])
        aty = tqp.at_matvec(tcfg, qi, tr.y.map(lambda g: g[i]))
        z = ax.map(lambda a, l, u: torch.clamp(a, l, u), qi.l, qi.u)
        eps_p = sc.eps_abs + sc.eps_rel * max(float(ax.inf_norm()),
                                              float(z.inf_norm()))
        eps_d = sc.eps_abs + sc.eps_rel * max(
            float(torch.abs(hdiag * tr.x[i]).max()),
            float(torch.abs(aty).max()), float(torch.abs(qi.q).max()))
        assert float(tr.prim_res[i]) < eps_p
        assert float(torch.abs(hdiag * tr.x[i] + qi.q + aty).max()) < eps_d


@pytest.mark.parametrize("ew_kernel", [False, True])
def test_osqp_truncation_stops_exactly_at_max_iter(truncation_batch,
                                                   ew_kernel):
    """The cap is exact, as OSQP's (port of tests/test_qp.py::
    test_osqp_truncation_stops_exactly_at_max_iter): with a tolerance no
    iterate meets, truncation="osqp" at max_iter 60 and check interval 25
    runs two full blocks and a remainder of 10 on every lane and returns
    the fixed schedule's 60-iteration iterate, bit for bit in the port,
    and agrees with the JAX package's truncated solve to the per-candidate
    limits of test_admm_iterates_match_jax (atol 2e-5, rtol 1e-4)."""
    jcfg, tcfg, jqs, tqs = truncation_batch
    kw = dict(truncation="osqp", max_iter=60, eps_abs=1e-20, eps_rel=1e-20,
              term_check_interval=25)
    rho = torch.as_tensor(TRUNC_RHO)
    tr = tadmm.admm_solve(_with(tcfg, ew_kernel=ew_kernel, **kw), tqs,
                          rho_override=rho)
    assert tr.iters.tolist() == [60] * 4
    tf = tadmm.admm_solve(_with(tcfg, ew_kernel=ew_kernel, max_iter=60),
                          tqs, rho_override=rho)
    assert torch.equal(tr.x, tf.x)
    jr = jax.vmap(lambda q, r: jadmm.admm_solve(_with(jcfg, **kw), q,
                                                rho_override=r))(
        jqs, jnp.asarray(TRUNC_RHO))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=2e-5,
                               rtol=1e-4)


def test_osqp_truncation_with_shared_factor_matches_jax(candidates):
    """The default config's shared factor with CG-2 under truncation="osqp"
    (60 iterations, check interval 25, a tolerance no iterate meets):
    against JAX with the shared-path limits of
    test_admm_iterates_match_jax (x atol 1e-4)."""
    jcfg, tcfg, jqs, tqs, jmean, tmean = candidates
    kw = dict(truncation="osqp", eps_abs=1e-20, eps_rel=1e-20)
    jcfg, tcfg = _with(jcfg, **kw), _with(tcfg, **kw)
    jf = jadmm.admm_factor(jcfg, jmean)
    jr = jax.vmap(lambda q: jadmm.admm_solve(jcfg, q, factor=jf))(jqs)
    tr = tadmm.admm_solve(tcfg, tqs, factor=tadmm.admm_factor(tcfg, tmean))
    assert tr.iters.tolist() == [60] * 3
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("ew_kernel", [False, True])
def test_solve_adaptive_matches_jax(ew_kernel):
    """adaptive_rho with no factor (JAX _solve_adaptive): 200 iterations
    in 8 blocks of 25 from per-lane base penalties 1e-3, 0.1, 10 and 0.3
    on four seeded QPs. The lanes switch rho 2, 0, 1 and 0 times; the
    final rho matches JAX's to rtol 1e-3 (the ratio is read from float32
    residuals), x to 1e-4 of max|x| (~20; the lane started at 1e-3 is
    factored at cond ~1e7 and reads 1.3e-3) and prim_res (measured
    against clip(A x, l, u)) to rtol 1e-3."""
    jcfg, tcfg = configs(max_iter=200, refine_iters=1)
    pairs = [build_both(jcfg, tcfg, 4, 3, seed=s) for s in range(4)]
    jqs = stack_jax([p[0] for p in pairs])
    tqs = to_torch(jqs, tqp.QPData)
    rho = np.array([1e-3, 0.1, 10.0, 0.3], np.float32)
    jc = _with(jcfg, adaptive_rho=True)
    tc = _with(tcfg, adaptive_rho=True, ew_kernel=ew_kernel)
    jr = jax.vmap(lambda q, r: jadmm.admm_solve(jc, q, rho_override=r))(
        jqs, jnp.asarray(rho))
    tr = tadmm.admm_solve(tc, tqs, rho_override=torch.as_tensor(rho))
    assert tr.rho_switches.tolist() == [2, 0, 1, 0]
    np.testing.assert_allclose(tr.rho_suggest.numpy(),
                               np.asarray(jr.rho_suggest), rtol=1e-3)
    xmax = float(np.abs(np.asarray(jr.x)).max())
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-4 * xmax)
    np.testing.assert_allclose(tr.prim_res.numpy(), np.asarray(jr.prim_res),
                               rtol=1e-3)


def test_adaptive_rho_recovers_bad_initialization():
    """Port of tests/test_qp.py::test_adaptive_rho_recovers_bad_
    initialization on the port: from a bad initial rho (1e-3 or 10) the
    adaptive solve (500 iterations) lands over 3x closer to the float64
    oracle's polished optimum than the fixed-rho solve at the same
    budget, and the adapted rho moves into (1e-3, 1)."""
    jcfg, tcfg = configs(horizon=30, max_obstacles=8, max_iter=500,
                         refine_iters=1)
    _, tq = build_both(jcfg, tcfg, 8, 4, with_static=True)
    x0, xref, oxyz, osize, yaw, is_dyn, active, lin = _random_problem(
        jcfg, 8, 4, 0, True)
    P, q, A, l, u = oracle.build_reference_qp(
        jcfg, x0, xref, oxyz[:, :4], osize[:, :4], yaw[:, :4],
        is_dyn[:, :4], lin)
    x_c, _ = oracle.solve_qp_dense(P, q, A, l, u, max_iter=20000, eps=1e-9,
                                   polish=True)
    H = tcfg.horizon

    def pos_err(res):
        x = res.x.numpy().astype(np.float64)
        return np.abs(x[:8 * H].reshape(H, 8)[:, :3]
                      - x_c[:8 * H].reshape(H, 8)[:, :3]).max()

    for rho0 in (1e-3, 10.0):
        fixed = tadmm.admm_solve(tcfg, tq, rho_override=rho0)
        adap = tadmm.admm_solve(_with(tcfg, adaptive_rho=True), tq,
                                rho_override=rho0)
        assert pos_err(adap) < pos_err(fixed) / 3.0, (rho0, pos_err(adap),
                                                      pos_err(fixed))
        assert 1e-3 < float(adap.rho_suggest) < 1.0
