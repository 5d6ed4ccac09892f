"""Port parity: the f64 oracle tools (intent_mpc_torch/oracle/,
intent_mpc_torch/native/, benchmark/oracle_loop.py, native_loop.py)
against the JAX package's; the north-star parity check on the port; the
flags of the port's bench.py.

The numpy oracles (oracle/numpy_ref.py, oracle/predictor_ref.py) are
copies of the JAX package's, operation for operation: their results are
bit-equal (np.array_equal) on seeded horizon-10 problems and obstacle
histories.

The C++ sources are the JAX package's, byte for byte, and build with the
same compiler and flags, so the port's solves are bit-equal to JAX's on
seeded problems. The oracle-override loop holds positions within 1e-4 of
JAX's over 3 cycles: the two packages build the same QPs to float32
rounding, and the oracle solves them to eps 1e-3 in float64."""

import ctypes
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _tiny_setup
from intent_mpc_tpu.benchmark import oracle_loop as joracle
from intent_mpc_tpu.engine import closed_loop as jcl
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.oracle import native as jnative
from intent_mpc_tpu.oracle import numpy_ref as jnumpy_ref
from intent_mpc_tpu.oracle import osqp_ref as josqp
from intent_mpc_tpu.oracle import predictor_ref as jpredictor_ref
from intent_mpc_tpu.utils.config import PlannerConfig as JPlannerConfig
from intent_mpc_tpu.utils.config import PredictorConfig as JPredictorConfig
from intent_mpc_torch.benchmark import bench, native_loop, oracle_loop
from intent_mpc_torch.engine import closed_loop as tcl
from intent_mpc_torch.entry import tiny_setup
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.oracle import (native, numpy_ref, osqp_ref,
                                     predictor_ref)
from intent_mpc_torch.utils.config import PlannerConfig, PredictorConfig

from test_qp import _random_problem as tq_random_problem

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


# ---- the float64 oracles (oracle/numpy_ref.py, oracle/predictor_ref.py):
# the port's copies against the JAX package's, bit for bit ----

def _small_dense(seed):
    """The horizon-10 problem of tests/test_qp.py (4 slots, 3 active,
    static rows) through both packages' build_reference_qp, each with its
    own PlannerConfig."""
    jc = JPlannerConfig(horizon=10, max_obstacles=4)
    tc = PlannerConfig(horizon=10, max_obstacles=4)
    x0, xref, oxyz, osize, yaw, is_dyn, _, lin = tq_random_problem(
        tc, 4, 3, seed, with_static=True)
    args = (x0, xref, oxyz[:, :3], osize[:, :3], yaw[:, :3], is_dyn[:, :3],
            lin)
    return (jnumpy_ref.build_reference_qp(jc, *args),
            numpy_ref.build_reference_qp(tc, *args))


@pytest.mark.parametrize("ts", [0.1, 0.05])
def test_dynamics_matrices_bit_equal_to_jax(ts):
    for got, want in zip(numpy_ref.dynamics_matrices(ts),
                         jnumpy_ref.dynamics_matrices(ts)):
        assert np.array_equal(got, want)
    assert (numpy_ref.NX, numpy_ref.NU) == (jnumpy_ref.NX, jnumpy_ref.NU)
    assert numpy_ref.INF == jnumpy_ref.INF


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_reference_qp_bit_equal_to_jax(seed):
    """P, q, A, l, u equal (np.array_equal: every entry, infinities in
    their places)."""
    want, got = _small_dense(seed)
    assert got[2].shape == (232, 125)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("polish", [True, False])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_solve_qp_dense_bit_equal_to_jax(seed, polish):
    """solve_qp_dense at its defaults (4000 iterations, eps 1e-9): x and
    y equal; with polish on, the polish is accepted (x moves off the ADMM
    iterate)."""
    want_qp, got_qp = _small_dense(seed)
    got = numpy_ref.solve_qp_dense(*got_qp, polish=polish)
    want = jnumpy_ref.solve_qp_dense(*want_qp, polish=polish)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    if polish:
        raw = numpy_ref.solve_qp_dense(*got_qp, polish=False)[0]
        assert not np.array_equal(got[0], raw)


def test_polish_gate_bit_equal_to_jax():
    """_polish from a converged iterate (accepted: equal x) and from the
    zero point with zero duals (rejected by the row gate: None in both)."""
    _, (P, q, A, l, u) = _small_dense(3)
    x, y = numpy_ref.solve_qp_dense(P, q, A, l, u, polish=False)
    rho = np.full(A.shape[0], 0.1)
    got = numpy_ref._polish(P, q, A, l, u, x, y, rho)
    assert np.array_equal(got, jnumpy_ref._polish(P, q, A, l, u, x, y, rho))
    zero = np.zeros_like(x), np.zeros_like(y)
    assert numpy_ref._polish(P, q, A, l, u, *zero, rho) is None
    assert jnumpy_ref._polish(P, q, A, l, u, *zero, rho) is None


def _histories(seed, O=6, Hh=12):
    """Seeded float64 obstacle walks, newest sample first, as lists of
    (Hh, 3) positions and velocities."""
    rng = np.random.RandomState(seed)
    t = np.arange(Hh)[::-1] * 0.1
    pos, vel = [], []
    for _ in range(O):
        heading, turn = rng.uniform(-np.pi, np.pi), rng.uniform(-0.5, 0.5)
        speed = rng.uniform(0.0, 2.0)
        ang = heading + turn * t
        v = np.stack([speed * np.cos(ang), speed * np.sin(ang),
                      np.zeros(Hh)], axis=-1)
        p = np.cumsum(v * 0.1, axis=0) + [*rng.uniform(-5, 5, 2), 2.0]
        pos.append(p[::-1].copy())
        vel.append(v[::-1].copy())
    return pos, vel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intent_prob_bit_equal_to_jax(seed):
    pos, vel = _histories(seed)
    got = predictor_ref.intent_prob(PredictorConfig(), pos, vel)
    want = jpredictor_ref.intent_prob(JPredictorConfig(), pos, vel)
    assert got.shape == (6, 4) and np.array_equal(got, want)


def _wall(p):
    """An occupied half-space and a pillar: rollouts stop at them."""
    return p[0] > 1.5 or math.hypot(p[0] + 2.0, p[1]) < 1.0


@pytest.mark.parametrize("occupied", ["free", "wall"])
@pytest.mark.parametrize("seed", [0, 1])
def test_predict_obstacle_bit_equal_to_jax(seed, occupied):
    """predict_obstacle per obstacle (forward, turning and stop models,
    genTraj, the fallback), positions and sizes equal; one obstacle
    slower than stop_vel. On the wall map some hypothesis differs from the
    free map's, so the occupied branches ran."""
    pos, vel = _histories(seed)
    vel[0] = vel[0] * 0.01
    sizes = np.random.RandomState(seed + 100).uniform(0.5, 1.5, (6, 3))
    tc, jc = PredictorConfig(num_pred=10), JPredictorConfig(num_pred=10)
    kw = {} if occupied == "free" else {"occupied": _wall}
    moved = False
    for o in range(6):
        args = (pos[o][0], vel[o][0], sizes[o])
        got = predictor_ref.predict_obstacle(tc, *args, **kw)
        want = jpredictor_ref.predict_obstacle(jc, *args, **kw)
        assert np.array_equal(got[0], want[0]) and np.array_equal(
            got[1], want[1]), o
        if kw:
            free = predictor_ref.predict_obstacle(tc, *args)
            moved |= not np.array_equal(got[0], free[0])
    assert moved or not kw


# ---- the north-star parity check on the port (chip_smoke.check_north_star,
# which the card runs too) ----

def test_north_star_problem_is_test_fullscale_parity_s():
    """The problem is the one tests/test_fullscale_parity.py builds: its
    dense QP equal to the JAX oracle's on test_qp._random_problem's
    inputs."""
    pcfg, inputs, dense = chip_smoke.north_star_problem()
    assert (pcfg.horizon, pcfg.max_obstacles, pcfg.solver.max_iter,
            pcfg.solver.refine_iters) == (30, 8, 2000, 1)
    jcfg = JPlannerConfig(horizon=30, max_obstacles=8)
    want = tq_random_problem(jcfg, 8, 4, 0, with_static=True)
    for g, w in zip(inputs, want):
        assert np.array_equal(g, w)
    x0, xref, oxyz, osize, yaw, is_dyn, _, lin = want
    jdense = jnumpy_ref.build_reference_qp(
        jcfg, x0, xref, oxyz[:, :4], osize[:, :4], yaw[:, :4],
        is_dyn[:, :4], lin)
    for g, w in zip(dense, jdense):
        assert np.array_equal(g, w)


def test_north_star_parity_on_cpu():
    """The port's build_qp, admm_solve (2000 iterations, refine 1) and
    polish on the horizon-30 problem against its own float64 oracle: the
    polish accepted, positions within 1e-3 m and accelerations within
    1e-1; the unpolished iterate within 2e-2 m and 1.5
    (tests/test_fullscale_parity.py's bounds; measured ~5.5e-6 m and
    ~1.1e-3 polished, ~3.0e-3 m and ~1.06 unpolished). On the CPU
    ew_chain and the constraint operator run their plain versions: no
    launch."""
    out = chip_smoke.check_north_star("cpu")
    b = chip_smoke.NORTH_STAR_BOUNDS
    assert b == {"pos": 1e-3, "acc": 1e-1, "raw_pos": 2e-2, "raw_acc": 1.5}
    assert out["accepted"]
    assert out["pos_err"] < 1e-3 and out["acc_err"] < 1e-1, out
    assert out["raw_pos_err"] < 2e-2 and out["raw_acc_err"] < 1.5, out
    assert out["launches"] == {"ew_chain": 0, "fleet_admm": 0,
                               "dense_loop": 0, "constraint_op": 0}


@pytest.mark.parametrize("horizon,K,num_active,seed,with_static,feasible", [
    (10, 4, 3, 0, True, True), (10, 4, 3, 7, True, True),
    (30, 8, 4, 0, True, True), (30, 8, 0, 2, False, True),
    (12, 5, 2, 4, False, False)])
def test_chip_smoke_random_problem_equals_test_qp(horizon, K, num_active,
                                                  seed, with_static,
                                                  feasible):
    """chip_smoke.random_problem (numpy only, for the card's machine) gives
    test_qp._random_problem's arrays, dtypes included."""
    cfg = PlannerConfig(horizon=horizon, max_obstacles=K)
    got = chip_smoke.random_problem(cfg, K, num_active, seed, with_static,
                                    feasible)
    want = tq_random_problem(cfg, K, num_active, seed, with_static, feasible)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---- bench.py's flags on the port's benchmark ----

def test_bench_solver_flags_set_jax_bench_fields():
    """--folded-refine and --minv-bf16 set what bench.py sets
    (folded_refine=True, minv_dtype="bf16"), through solver_fields into
    the SolverConfig; without them the defaults stay."""
    args = bench.parse_args(["--folded-refine", "--minv-bf16"])
    assert bench.solver_fields(args) == {"folded_refine": True,
                                         "minv_dtype": "bf16"}
    sv = bench.bench_config(solver=bench.solver_fields(args)).planner.solver
    assert sv.folded_refine and sv.minv_dtype == "bf16"
    plain = bench.parse_args([])
    assert bench.solver_fields(plain) == {}
    assert (plain.device, plain.profile) == (None, None)


def test_bench_profile_writes_a_trace_on_cpu(tmp_path, capsys):
    """--profile DIR on --device cpu at a tiny size: the JSON line and the
    summary marked as profiled, and a Chrome trace in DIR whose events
    include the cycle's operators."""
    out = tmp_path / "prof"
    bench.main(["--device", "cpu", "--batch", "2", "--obstacles", "8",
                "--iters", "3", "--cycles", "1", "--profile", str(out)])
    out_err = capsys.readouterr()
    line = json.loads(out_err.out.strip().splitlines()[-1])
    assert line["metric"] == "mpc_solves_per_sec_per_chip"
    assert line["profiled"] is True and "profiled=true" in out_err.err
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_bench_latency_refuses_the_cpu(tmp_path):
    """--latency measures only on a CUDA device: --device cpu raises
    before any cycle runs (no trace is written)."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main(["--device", "cpu", "--latency", "--batch", "2",
                    "--profile", str(tmp_path / "p")])
    assert not os.path.exists(tmp_path / "p")
