"""Port parity: the dense-A ADMM path (qp.dense_a_matrix, the dense
factor, admm._dense_scaled_problem, ops/dense_loop.py and the entry
admm.admm_solve_dense) against the JAX package's ops/pallas_admm.py,
whose Pallas kernel runs here in interpret mode, as
tests/test_pallas_admm.py runs it.

Config of tests/test_pallas_admm.py:26-28: horizon 10, 4 obstacle slots
(3 active, static ones yawed), 150 iterations, refine_iters 0,
structured_factor False; two candidates (seeds 0 and 1) and a seeded
warm start.

Tolerances. On identical inputs the port's plain loop and the Pallas
kernel differ only in the summation order of their products, but the
rho_eq = 1e3 rows make rhs a sum of large cancelling terms: one
iteration already moves x by ~1e-5 of max|x|, and a refinement step
through M (cond ~1e5) by ~2e-5. Those are the scales the tests hold."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.ops import admm as jadmm
from intent_mpc_tpu.ops import pallas_admm as jpk
from intent_mpc_tpu.ops import qp as jqp
from intent_mpc_torch.ops import admm as tadmm
from intent_mpc_torch.ops import dense_loop as tdl
from intent_mpc_torch.ops import qp as tqp
from intent_mpc_torch.utils import convert, trace

from test_torch_qp import build_both, configs, stack_jax, to_torch

torch.set_num_threads(1)

ITERS = 150
SIGMA, ALPHA = 1e-6, 1.6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _problems(jcfg, tcfg, K, active, count):
    pairs = [build_both(jcfg, tcfg, K, active, seed=s) for s in range(count)]
    jqps = stack_jax([p[0] for p in pairs])
    warm = (0.1 * np.random.RandomState(7).randn(count, jcfg.num_vars)
            ).astype(np.float32)
    return jqps, to_torch(jqps, tqp.QPData), warm


def _jax_problem(jcfg, jqps, warm, K):
    n_pad, m_pad = tadmm.dense_pads(jcfg, K)
    sp, _ = jax.vmap(lambda q, x: jadmm._dense_scaled_problem(
        jcfg, q, x, jcfg.solver, n_pad, m_pad))(jqps, jnp.asarray(warm))
    return sp


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = configs(max_iter=ITERS, refine_iters=0,
                         structured_factor=False)
    jqps, tqps, warm = _problems(jcfg, tcfg, 4, 3, 2)
    jsp = _jax_problem(jcfg, jqps, warm, 4)
    return dict(jcfg=jcfg, tcfg=tcfg, jqps=jqps, tqps=tqps, warm=warm,
                jsp=jsp, sp=convert.dense_problem_from_numpy(_np(jsp)))


@pytest.mark.parametrize("horizon,K,active", [(10, 4, 3), (30, 65, 40)],
                         ids=["small", "production"])
def test_dense_a_matrix_matches_jax(horizon, K, active):
    """The scattered dense A against JAX's a_matvec over the identity, two
    candidates at once: within 1e-6 (the entries are the same float32
    values: in practice equal)."""
    jcfg, tcfg = configs(horizon=horizon, max_obstacles=K)
    jqps, tqps, _ = _problems(jcfg, tcfg, K, active, 2)
    want = np.asarray(jax.vmap(lambda q: jqp.dense_a_matrix(jcfg, q))(jqps))
    got = tqp.dense_a_matrix(tcfg, tqps).numpy()
    assert got.shape == want.shape == (2, 2 * 8 * horizon
                                       + (5 + K) * (horizon - 1),
                                       tcfg.num_vars)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_con_to_flat_and_flat_to_con_match_jax(dense):
    """The flat constraint order against JAX's (exact: a reshape), and
    the round trip both ways, with leading batch axes."""
    jcfg, tcfg = dense["jcfg"], dense["tcfg"]
    K = 4
    m = 2 * 8 * jcfg.horizon + (5 + K) * jcfg.mpc_window
    rng = np.random.RandomState(2)
    v = rng.randn(m).astype(np.float32)
    jw = jqp.flat_to_con(jnp.asarray(v), jcfg, K)
    tw = tqp.flat_to_con(torch.as_tensor(v), tcfg, K)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tqp.con_to_flat(tw).numpy(),
                                  np.asarray(jqp.con_to_flat(jw)))
    vb = torch.as_tensor(rng.randn(3, 2, m).astype(np.float32))
    wb = tqp.flat_to_con(vb, tcfg, K)
    assert wb.obs.shape == (3, 2, jcfg.mpc_window, K)
    assert torch.equal(tqp.con_to_flat(wb), vb)
    assert all(torch.equal(a, b) for a, b in
               zip(tqp.flat_to_con(tqp.con_to_flat(wb), tcfg, K), wb))


def test_dense_a_matrix_is_a_matvec(dense):
    """A z with the materialized A equals the closed-form a_matvec, per
    candidate (float32 sums of a few terms: 1e-5)."""
    tcfg, tqps = dense["tcfg"], dense["tqps"]
    z = torch.as_tensor(np.random.RandomState(3).randn(2, tcfg.num_vars)
                        .astype(np.float32))
    A = tqp.dense_a_matrix(tcfg, tqps)
    got = torch.matmul(A, z[..., None])[..., 0]
    want = tqp.con_to_flat(tqp.a_matvec(tcfg, tqps, z))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _scaled_inputs(cfg, qp, mod, qpmod):
    sc = mod.ruiz_equilibrate(cfg, qp, qpmod.hessian_diag(cfg), 3)
    h_s = sc.c * sc.D * sc.D * qpmod.hessian_diag(cfg)
    rho = qpmod.rho_vec(cfg, qp, 0.1, 1e3)
    return h_s, rho.map(lambda r, e: r * e * e, sc.E), sc.D


def test_explicit_minv_dense_matches_jax(dense):
    """The dense branch (assembled M, Cholesky, triangular inverse,
    Linv^T Linv) against JAX's: both factor the same float32 M, whose
    condition number is ~1e5, so the inverses agree to 1e-4 of the
    largest entry (as test_torch_admm holds the structured inverse), and
    each is that close to the float64 inverse."""
    jcfg, tcfg = dense["jcfg"], dense["tcfg"]
    jq, tq = build_both(jcfg, tcfg, 4, 3)
    jh, jr, jD = _scaled_inputs(jcfg, jq, jadmm, jqp)
    th, tr, tD = _scaled_inputs(tcfg, tq, tadmm, tqp)
    want = np.asarray(jadmm._explicit_minv(jcfg, jq, jh, jcfg.solver, jr, jD))
    got = tadmm._explicit_minv(tcfg, tq, th, tcfg.solver, tr, tD).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    M = tqp.assemble_normal_matrix(tcfg, tq, th, SIGMA, tr, col_scale=tD)
    exact = np.linalg.inv(M.numpy().astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("iters", [1, 10, 60])
def test_admm_solve_unstructured_factor_matches_jax(dense, iters):
    """admm_solve (factor=None) and admm_factor with
    structured_factor=False, which the port used to refuse, against JAX.
    refine_iters=1 as in test_torch_admm's per-candidate parity: with 0,
    x carries the two inverses' 1e-4 difference straight through. x atol
    1e-4 / rtol 1e-4, prim_res atol 1e-4 / rtol 1e-3."""
    jcfg, tcfg = configs(max_iter=60, refine_iters=1, structured_factor=False)
    jqps, tqps, warm = dense["jqps"], dense["tqps"], dense["warm"]
    jr = jax.vmap(lambda q, x: jadmm.admm_solve(jcfg, q, x, iters))(
        jqps, jnp.asarray(warm))
    tr = tadmm.admm_solve(tcfg, tqps, torch.as_tensor(warm), iters)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tr.prim_res.numpy(), np.asarray(jr.prim_res),
                               rtol=1e-3, atol=1e-4)
    jm = jax.tree.map(lambda a: a[0], jqps)
    tm = jax.tree.map(lambda a: a[0], tqps)
    jf, tf = jadmm.admm_factor(jcfg, jm), tadmm.admm_factor(tcfg, tm)
    scale = np.abs(np.asarray(jf.Minv)).max()
    np.testing.assert_allclose(tf.Minv.numpy(), np.asarray(jf.Minv),
                               rtol=1e-4, atol=1e-4 * scale)


def test_dense_scaled_problem_matches_jax(dense):
    """Every field of the port's _dense_scaled_problem against JAX's, from
    the same QPs and warm start: within 1e-5 of the field's largest
    finite entry, the same +-inf entries, the same shapes. minv is the
    exception: the two dense inverses agree to 1e-4 of their largest
    entry (test_explicit_minv_dense_matches_jax)."""
    tcfg = dense["tcfg"]
    n_pad, m_pad = tadmm.dense_pads(tcfg, 4)
    got, (D, E, c) = tadmm._dense_scaled_problem(
        tcfg, dense["tqps"], torch.as_tensor(dense["warm"]), tcfg.solver,
        n_pad, m_pad)
    assert D.shape == (2, tcfg.num_vars) and c.shape == (2,)
    for name, a, b in zip(tdl.DenseScaledProblem._fields, got, dense["sp"]):
        a, b = a.numpy(), b.numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        fin = np.isfinite(b)
        tol = (1e-4 if name == "minv" else 1e-5) * np.abs(b[fin]).max()
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol,
                                   err_msg=name)
    # the padding of the kernel's problem
    n, m = tcfg.num_vars, 2 * 8 * 10 + 9 * 9
    assert torch.equal(got.minv[:, n:, n:], torch.eye(n_pad - n).expand(
        2, -1, -1))
    assert not bool(got.amat[:, m:].any()) and not bool(got.amat[:, :, n:].any())
    assert bool((got.rho[:, m:] == 1e-6).all())
    assert bool(torch.isinf(got.lo[:, m:]).all() & torch.isinf(got.hi[:, m:]).all())


@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("iters", [1, 10, ITERS])
def test_dense_loop_reference_matches_jax(dense, iters, refine):
    """The plain loop against the Pallas kernel (interpret mode) on one
    problem carried across by convert. 1 and 10 iterations: within
    5e-5 and 5e-4 of max|x| (measured 9e-6 / 8e-6 at refine 0, 2e-5 /
    1.5e-4 at refine 1). 150 iterations: refine 0 to the 2e-3 of
    test_pallas_admm.py:40-41 (rtol and atol); refine 1 to 2e-3 of
    max|x| (measured 5e-5 of it, 2.3e-3 absolute), since the residual
    rhs - M xt, with cond(M) ~1e5, carries the summation order's
    rounding into every step (the reason test_pallas_admm.py:21-25 runs
    refine 0). The padded x entries stay exactly 0."""
    jx = np.asarray(jpk.admm_iterations_dense(
        dense["jsp"], iters, SIGMA, ALPHA, refine=refine, interpret=True))
    tx = tdl.dense_loop_reference(dense["sp"], iters, SIGMA, ALPHA,
                                  refine).numpy()
    assert tx.shape == jx.shape
    n = dense["tcfg"].num_vars
    assert not np.any(tx[:, n:])
    if iters == ITERS and refine == 0:
        np.testing.assert_allclose(tx, jx, rtol=2e-3, atol=2e-3)
    elif iters == ITERS:
        assert np.abs(tx - jx).max() <= 2e-3 * np.abs(jx).max()
    else:
        tol = 5e-5 if iters == 1 else 5e-4
        assert np.abs(tx - jx).max() <= tol * np.abs(jx).max()


@pytest.mark.parametrize("seed", range(6))
def test_dense_loop_readings_over_seeds(seed):
    """The spread behind the parity limits: the plain loop against the
    Pallas kernel (interpret mode) on one seeded candidate with its own
    seeded warm start, at 1 and 150 iterations, refine 0 and 1, each as
    max|dx| / max|x|. Over seeds 0-5 one iteration reads 4e-6 - 1.5e-5
    at refine 0 and 4e-5 - 7.6e-5 at refine 1: the refinement residual
    rhs - M xt cancels down to rounding, and Minv (cond(M) ~1e5) carries
    the summation order's share of it into x. Limits: 5e-5 after 1
    iteration at refine 0 and 2e-4 at refine 1; 2e-3 after 150 (readings
    1e-6 - 1.6e-4). Prints one JSON line of the readings (run with -s)."""
    jcfg, tcfg = configs(max_iter=ITERS, refine_iters=0,
                         structured_factor=False)
    jqps = stack_jax([build_both(jcfg, tcfg, 4, 3, seed=seed)[0]])
    warm = (0.1 * np.random.RandomState(100 + seed).randn(1, jcfg.num_vars)
            ).astype(np.float32)
    jsp = _jax_problem(jcfg, jqps, warm, 4)
    sp = convert.dense_problem_from_numpy(_np(jsp))
    readings = {}
    for refine in (0, 1):
        for iters in (1, ITERS):
            jx = np.asarray(jpk.admm_iterations_dense(
                jsp, iters, SIGMA, ALPHA, refine=refine, interpret=True))
            tx = tdl.dense_loop_reference(sp, iters, SIGMA, ALPHA,
                                          refine).numpy()
            rel = float(np.abs(tx - jx).max() / np.abs(jx).max())
            readings[(refine, iters)] = rel
    print(json.dumps({"dense_loop_vs_pallas_interpret": {
        "seed": seed, "x_rel_diff": {"refine_%d_iters_%d" % k: v
                                     for k, v in readings.items()}}}))
    limits = {(0, 1): 5e-5, (1, 1): 2e-4, (0, ITERS): 2e-3, (1, ITERS): 2e-3}
    for key, rel in readings.items():
        assert rel <= limits[key], (key, rel)


def test_admm_solve_dense_matches_jax_and_admm_solve(dense):
    """The entry point against admm_solve_pallas(interpret=True) and
    against the port's admm_solve (factor=None), at 150 iterations,
    with the tolerance of test_pallas_admm.py:40-41 (rtol and atol
    2e-3) and its residual check."""
    tcfg, tqps, warm = dense["tcfg"], dense["tqps"], dense["warm"]
    ref = jadmm.admm_solve_pallas(dense["jcfg"], dense["jqps"],
                                  jnp.asarray(warm), ITERS, interpret=True)
    out = tadmm.admm_solve_dense(tcfg, tqps, torch.as_tensor(warm), ITERS)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out.prim_res.numpy(), np.asarray(ref.prim_res),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(out.solved.numpy(), np.asarray(ref.solved))
    xla = tadmm.admm_solve(tcfg, tqps, torch.as_tensor(warm), ITERS)
    np.testing.assert_allclose(out.x.numpy(), xla.x.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert float(out.prim_res[0]) < 0.5


def test_admm_solve_dense_takes_leading_axes(dense):
    """(S, C) batches flatten to one candidate axis and come back: the
    same bits as the flat (2,) batch."""
    tcfg, tqps, warm = dense["tcfg"], dense["tqps"], dense["warm"]
    flat = tadmm.admm_solve_dense(tcfg, tqps, torch.as_tensor(warm), 20)
    nested = jax.tree.map(lambda a: a.reshape((1, 2) + a.shape[1:]), tqps)
    out = tadmm.admm_solve_dense(tcfg, nested,
                                 torch.as_tensor(warm).reshape(1, 2, -1), 20)
    assert out.x.shape == (1, 2, tcfg.num_vars)
    assert out.prim_res.shape == (1, 2) and out.y.obs.shape == (1, 2, 9, 4)
    assert torch.equal(out.x.reshape(2, -1), flat.x)
    assert torch.equal(out.prim_res.reshape(2), flat.prim_res)


def test_admm_solve_dense_duals_are_nan(dense):
    """The kernel returns no duals: y and dual_res are NaN and
    rho_suggest is scfg.rho, as admm_solve_pallas sets them
    (intent_mpc_tpu/ops/admm.py:964-972)."""
    tcfg = dense["tcfg"]
    out = tadmm.admm_solve_dense(tcfg, dense["tqps"],
                                 torch.as_tensor(dense["warm"]), 5)
    for g, ref in zip(out.y, tqp.a_matvec(tcfg, dense["tqps"], out.x)):
        assert g.shape == ref.shape and bool(torch.isnan(g).all())
    assert bool(torch.isnan(out.dual_res).all())
    assert torch.equal(out.rho_suggest,
                       torch.full((2,), tcfg.solver.rho))
    assert torch.equal(out.solved, out.prim_res < 5e-2)


def test_production_shapes_match_jax():
    """One case at production shapes (horizon 30, 65 slots, 40 active,
    n_pad 512, m_pad 2560) with the production solver settings
    (structured factor, refine 0): 2 candidates, 10 iterations, the
    JAX problem through both loops, within 5e-4 of max|x|; and the port's
    own problem field by field as in test_dense_scaled_problem_matches_jax
    (minv, the structured inverse, to 1e-4 of its largest entry)."""
    jcfg, tcfg = configs(horizon=30, max_obstacles=65)
    jqps, tqps, warm = _problems(jcfg, tcfg, 65, 40, 2)
    jsp = _jax_problem(jcfg, jqps, warm, 65)
    sp = convert.dense_problem_from_numpy(_np(jsp))
    assert sp.amat.shape == (2, 2560, 512)
    jx = np.asarray(jpk.admm_iterations_dense(jsp, 10, SIGMA, ALPHA, refine=0,
                                              interpret=True))
    tx = tdl.dense_loop_reference(sp, 10, SIGMA, ALPHA, 0).numpy()
    assert np.abs(tx - jx).max() <= 5e-4 * np.abs(jx).max()
    got, _ = tadmm._dense_scaled_problem(tcfg, tqps, torch.as_tensor(warm),
                                         tcfg.solver, 512, 2560)
    for name, a, b in zip(tdl.DenseScaledProblem._fields, got, sp):
        a, b = a.numpy(), b.numpy()
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        tol = (1e-4 if name == "minv" else 1e-5) * np.abs(b[fin]).max()
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol,
                                   err_msg=name)


def test_admm_iterations_dense_on_cpu_is_the_plain_version(dense):
    """On CPU tensors admm_iterations_dense runs the plain version and
    launches no kernel; a wrong shape or dtype, or a device that is
    neither CPU nor CUDA, raises."""
    sp = dense["sp"]
    before = trace.counters().get("dense_loop.launches", 0)
    got = tdl.admm_iterations_dense(sp, 7, SIGMA, ALPHA, 1)
    want = tdl.dense_loop_reference(sp, 7, SIGMA, ALPHA, 1)
    assert trace.counters().get("dense_loop.launches", 0) == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shape"):
        tdl.admm_iterations_dense(sp._replace(q=sp.q[:, :-1].contiguous()),
                                  1, SIGMA, ALPHA)
    with pytest.raises(TypeError, match="float32"):
        tdl.admm_iterations_dense(sp._replace(lo=sp.lo.double()), 1, SIGMA,
                                  ALPHA)
    meta = tdl.DenseScaledProblem(*(t.to("meta") for t in sp))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tdl.admm_iterations_dense(meta, 1, SIGMA, ALPHA)
    assert trace.counters().get("dense_loop.launches", 0) == before


def test_dense_problem_from_numpy_drops_the_column(dense):
    """convert.dense_problem_from_numpy maps JAX's (C, rows, 1) columns to
    (C, rows) and keeps the matrices, element for element."""
    jsp, sp = _np(dense["jsp"]), dense["sp"]
    for name, a in zip(tdl.DenseScaledProblem._fields, sp):
        b = getattr(jsp, name)
        if b.ndim == 3 and b.shape[-1] == 1:
            b = b[..., 0]
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert a.is_contiguous()


@pytest.mark.parametrize("active", ["all", "seed0", "seed1"])
@pytest.mark.parametrize("horizon,K", [(10, 4), (30, 65)],
                         ids=["small", "production"])
def test_dense_a_nnz_max_bounds_the_matrix_and_fits_the_kernel(horizon, K,
                                                                active):
    """qp.dense_a_nnz_max (the linear rows' nonzeros plus 5 per obstacle
    row) against the nonzeros of dense_a_matrix, the port's and JAX's, on
    two candidates with every slot active or a seeded number of active
    slots (seeds 0 and 1): the count found never exceeds the maximum, and
    the maximum fits the CSR capacity the dense_loop kernel plans for the
    padded shapes (ops/dense_loop.csr_capacity). Pinned: 10,543 nonzeros
    at most at the production shapes, against a capacity of 11,872."""
    jcfg, tcfg = configs(horizon=horizon, max_obstacles=K)
    if active == "all":
        num = K
    else:
        num = int(np.random.RandomState(int(active[-1])).randint(1, K + 1))
    jqps, tqps, _ = _problems(jcfg, tcfg, K, num, 2)
    bound = tqp.dense_a_nnz_max(tcfg, K)
    got = (tqp.dense_a_matrix(tcfg, tqps) != 0).sum(dim=(-2, -1))
    want = np.count_nonzero(np.asarray(
        jax.vmap(lambda q: jqp.dense_a_matrix(jcfg, q))(jqps)), axis=(-2, -1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) <= bound
    n_pad, m_pad = tadmm.dense_pads(tcfg, K)
    assert bound <= tdl.csr_capacity(n_pad, m_pad)
    if horizon == 30:
        assert (bound, tdl.csr_capacity(n_pad, m_pad)) == (10543, 11872)
