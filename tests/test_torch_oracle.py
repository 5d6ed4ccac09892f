"""Port parity: the f64 oracle tools (intent_mpc_torch/oracle/,
intent_mpc_torch/native/, benchmark/oracle_loop.py, native_loop.py)
against the JAX package's.

The C++ sources are the JAX package's, byte for byte, and build with the
same compiler and flags, so the port's solves are bit-equal to JAX's on
seeded problems. The oracle-override loop holds positions within 1e-4 of
JAX's over 3 cycles: the two packages build the same QPs to float32
rounding, and the oracle solves them to eps 1e-3 in float64."""

import ctypes
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_setup
from intent_mpc_tpu.benchmark import oracle_loop as joracle
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.oracle import native as jnative
from intent_mpc_tpu.oracle import osqp_ref as josqp
from intent_mpc_torch.benchmark import native_loop, oracle_loop
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.entry import tiny_setup
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.oracle import native, osqp_ref

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["qp_solver.cpp", "closed_loop.cpp",
                                  "closed_loop_engine.inc"])
def test_native_sources_are_the_jax_packages(name):
    with open(os.path.join(ROOT, "intent_mpc_tpu", "native", name), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "intent_mpc_torch", "native", name),
              "rb") as f:
        assert f.read() == want


def test_library_builds_outside_the_package():
    """The library is keyed by a hash of the sources and flags under
    build/native, and nothing is written into the package."""
    assert native.available(), native.build_error()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    assert os.path.exists(path)
    assert not [f for f in os.listdir(native.NATIVE_DIR)
                if f.endswith(".so") or ".tmp" in f]


def _problems(seed, P=5, n=16, m=24):
    rng = np.random.default_rng(seed)
    h = np.abs(rng.normal(1.0, 0.2, n)) + 0.5
    q = rng.normal(size=(P, n))
    A = rng.normal(size=(P, m, n))
    xs = rng.normal(size=(P, n))
    ax = np.einsum("pmn,pn->pm", A, xs)
    l = ax - np.abs(rng.normal(size=(P, m))) - 0.1
    u = ax + np.abs(rng.normal(size=(P, m))) + 0.1
    warm = rng.normal(size=(P, n))
    warm[2] = 0.0                                   # a cold-start row
    return h, q, A, l, u, warm


@pytest.mark.parametrize("seed", [3, 11])
def test_solves_bit_equal_to_jax(seed):
    """solve_qp (cold and warm) and solve_qp_batch: x, y, status and
    iterations identical (tolerance 0) to the JAX package's binding."""
    assert jnative.available() and native.available()
    h, q, A, l, u, warm = _problems(seed)
    for i in range(A.shape[0]):
        for x0 in (None, warm[i]):
            got = native.solve_qp(h, q[i], A[i], l[i], u[i], x0=x0,
                                  max_iter=500, eps=1e-7)
            want = jnative.solve_qp(h, q[i], A[i], l[i], u[i], x0=x0,
                                    max_iter=500, eps=1e-7)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2:] == want[2:]
    got = native.solve_qp_batch(h, q, A, l, u, x0=warm, max_iter=500,
                                eps=1e-7)
    want = jnative.solve_qp_batch(h, q, A, l, u, x0=warm, max_iter=500,
                                  eps=1e-7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_solver_rejects_mismatched_shapes():
    h, q, A, l, u, _ = _problems(0)
    with pytest.raises(ValueError):
        native.solve_qp(h, q[0], A[0], l[0][:-1], u[0])
    with pytest.raises(ValueError):
        native.solve_qp_batch(h, q, A, l, u, x0=np.zeros(3))


@pytest.mark.parametrize("upper", [False, True])
def test_dense_to_csc_equals_jax(upper):
    """Seeded matrices with exact zeros, a zero diagonal entry among
    them: pointers, indices and values equal."""
    rng = np.random.default_rng(7)
    M = rng.normal(size=(9, 9))
    M[rng.random((9, 9)) < 0.5] = 0.0
    M[3, 3] = 0.0
    M = M + M.T if upper else M[:, :7]
    got = osqp_ref._dense_to_csc(M, upper=upper)
    want = josqp._dense_to_csc(M, upper=upper)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]


@pytest.mark.parametrize("struct", ["_csc", "_OSQPData", "_OSQPSettings",
                                    "_OSQPInfo", "_OSQPSolution",
                                    "_OSQPWorkspace"])
def test_osqp_struct_layout_equals_jax(struct):
    """Every field at the JAX binding's offset and size (the ABI that the
    self-check verifies against the library's defaults)."""
    a, b = getattr(osqp_ref, struct), getattr(josqp, struct)
    assert ctypes.sizeof(a) == ctypes.sizeof(b)
    assert [f[0] for f in a._fields_] == [f[0] for f in b._fields_]
    for f in a._fields_:
        assert getattr(a, f[0]).offset == getattr(b, f[0]).offset, f[0]


def test_osqp_library_is_looked_up_in_the_repository():
    """The binding loads the reference's libosqp.so from `reference/` in
    the repository; where it is absent, available() is False and the
    override raises."""
    assert osqp_ref._LIB_PATH.startswith(os.path.join(ROOT, "reference"))
    if not os.path.exists(osqp_ref._LIB_PATH):
        assert not osqp_ref.available()
        cfg, _, _ = tiny_setup("cpu")
        with pytest.raises(RuntimeError, match="libosqp"):
            oracle_loop.make_osqp_override(cfg.planner)


def test_oracle_override_episode_steps_match_jax():
    """3 cycles of episode_step with make_oracle_override from a fresh
    carry (the __graft_entry__ config, one scenario): pos and vel within
    1e-4 of the JAX package's jitted episode_step with its override, and
    the solve counters equal."""
    jcfg, jsc, jref = _tiny_setup()
    jover = joracle.make_oracle_override(jcfg.planner)
    L = jnp.asarray(jref.shape[0])
    step = jax.jit(lambda c, i: jcl.episode_step(
        jcfg, jsc, jref, L, jempty(), c, i, solve_override=jover)[0])
    cfg, scen, ref = tiny_setup("cpu")
    over = oracle_loop.make_oracle_override(cfg.planner)
    jc = jcl.init_carry(jcfg, jsc)
    tc = tcl.init_carry(cfg, scen, device="cpu")
    for i in range(3):
        jc = step(jc, jnp.asarray(i, jnp.int32))
        tc, _ = tcl.episode_step(cfg, scen, ref, ref.shape[0],
                                 empty_grid("cpu"), tc, i,
                                 solve_override=over)
        np.testing.assert_allclose(tc.pos[0].numpy(), np.asarray(jc.pos),
                                   atol=1e-4, err_msg="pos, cycle %d" % i)
        np.testing.assert_allclose(tc.vel[0].numpy(), np.asarray(jc.vel),
                                   atol=1e-4, err_msg="vel, cycle %d" % i)
        for f in ("solve_attempts", "solve_successes"):
            assert int(getattr(tc.metrics, f)[0]) == int(
                getattr(jc.metrics, f)), (f, i)


def test_override_result_and_no_admm_launch():
    """The override hands the planner x (S, 6, n), y in the constraint
    layout, float32 residuals, NaN dual residuals and `solved` at the
    runtime's 5e-2, on the QPs' device; the batched ADMM does not run."""
    cfg, scen, ref = tiny_setup("cpu")
    over = oracle_loop.make_oracle_override(cfg.planner)
    seen = []

    def spy(qps, warm6):
        res = over(qps, warm6)
        seen.append((qps, res))
        return res
    solve = tcl.mpclib.admm_solve
    tcl.mpclib.admm_solve = None            # any call of the ADMM fails
    try:
        tc = tcl.init_carry(cfg, scen, device="cpu")
        for i in range(2):
            tc, _ = tcl.episode_step(cfg, scen, ref, ref.shape[0],
                                     empty_grid("cpu"), tc, i,
                                     solve_override=spy)
    finally:
        tcl.mpclib.admm_solve = solve
    qps, res = seen[-1]
    n = cfg.planner.num_vars
    assert res.x.shape == (1, 6, n) and res.x.dtype == torch.float32
    assert res.prim_res.shape == (1, 6) and res.prim_res.dtype == torch.float32
    assert bool(torch.isnan(res.dual_res).all())
    assert torch.equal(res.solved, res.prim_res < 5e-2)
    for g, want in zip(res.y, qps.l):
        assert g.shape == want.shape
    assert int(tc.metrics.solve_attempts[0]) == 2


def test_run_divergence_row_keys_match_jax():
    """The port's lockstep row (3 compared cycles on the tiny config) has
    the JAX row's keys in its order (JAX's at 0 cycles, which compiles
    nothing)."""
    jcfg, _, _ = _tiny_setup()
    jcfg = jcfg.replace(engine=dataclasses.replace(jcfg.engine, timeout=0.0))
    want = joracle.run_divergence(jcfg, 0, None)
    cfg, _, _ = tiny_setup("cpu")
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, timeout=0.3))
    got = oracle_loop.run_divergence(
        cfg, 0, oracle_loop.make_oracle_override(cfg.planner),
        runtime_iters=10, device="cpu")
    assert list(got) == list(want)
    assert got["cycles_compared"] >= 1
    assert got["du_first_max"] >= 0.0


def test_oracle_loop_cli_on_cpu(tmp_path):
    """The CLI at the DYNUS widths (32 QP slots), cut to 1 cycle and 16
    obstacles: the oracle rows and the runtime's, with harness.aggregate's
    keys."""
    out = oracle_loop.main(["--seeds", "0", "--obstacles", "16",
                            "--timeout", "0.1", "--runtime-iters", "5",
                            "--device", "cpu", "--out", str(tmp_path)])
    assert out["oracle_rows"][0]["mpc_solve_count"] == 1
    assert set(out["oracle"]) == set(out["runtime"])
    assert os.path.exists(tmp_path / "summary.json")


def test_native_loop_cli(tmp_path):
    """The C++ system oracle's CLI on one short trial (8 obstacles, 1 s):
    one row with the runtime's fields, the aggregate written."""
    out = native_loop.main(["--seeds", "0", "--obstacles", "8",
                            "--max-obstacles", "8", "--timeout", "1",
                            "--threads", "2", "--out", str(tmp_path)])
    row = out["rows"][0]
    assert set(native._EP_FIELDS) <= set(row)
    assert row["solve_attempts"] > 0
    assert out["aggregate"]["num_trials"] == 1
    assert os.path.exists(tmp_path / "summary.json")
