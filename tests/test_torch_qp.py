"""Port parity: intent_mpc_torch.ops.qp against the JAX package.

Shared helpers for the other test_torch_* files live here: numpy problems
from tests/test_qp.py go through both packages' build_qp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.ops import qp as jqp
from intent_mpc_tpu.utils.config import PlannerConfig as JPlannerConfig
from intent_mpc_tpu.utils.config import SolverConfig as JSolverConfig
from intent_mpc_torch.ops import qp as tqp
from intent_mpc_torch.utils import convert
from intent_mpc_torch.utils.config import PlannerConfig, SolverConfig

from test_qp import _random_problem

torch.set_num_threads(1)

# Structured assembly and matvecs: the same float32 operations in the
# same order up to the summation order of the small contractions, so
# agreement is at float32 rounding: rtol 1e-5, atol 1e-6.
RTOL, ATOL = 1e-5, 1e-6


def configs(horizon=10, max_obstacles=4, **solver):
    """Matching (JAX, port) PlannerConfigs."""
    j = JPlannerConfig(horizon=horizon, max_obstacles=max_obstacles,
                       solver=JSolverConfig(**solver))
    t = PlannerConfig(horizon=horizon, max_obstacles=max_obstacles,
                      solver=SolverConfig(**solver))
    return j, t


def build_both(jcfg, tcfg, K, num_active, seed=0, with_static=True):
    """One problem from test_qp._random_problem through both build_qp."""
    x0, xref, oxyz, osize, yaw, is_dyn, active, lin = _random_problem(
        jcfg, K, num_active, seed, with_static)
    f32 = np.float32
    args = [np.asarray(a, f32) for a in
            (x0, xref, oxyz, osize, yaw, is_dyn, active, lin)]
    jq = jqp.build_qp(jcfg, *(jnp.asarray(a) for a in args))
    tq = tqp.build_qp(tcfg, *(torch.as_tensor(a) for a in args))
    return jq, tq


def to_torch(tree, typ):
    """A JAX NamedTuple -> the port's NamedTuple of CPU tensors."""
    return convert.from_numpy(jax.tree.map(np.asarray, tree), typ)


def stack_jax(trees):
    return jax.tree.map(lambda *a: jnp.stack(a), *trees)


def assert_tree_close(t_tree, j_tree, rtol=RTOL, atol=ATOL):
    for a, b in zip(jax.tree.leaves(j_tree), _leaves(t_tree)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=atol)


def _leaves(t):
    if isinstance(t, tuple):
        return [x for s in t for x in _leaves(s)]
    return [t.detach().numpy()]


@pytest.fixture(scope="module")
def problem():
    jcfg, tcfg = configs()
    jq, tq = build_both(jcfg, tcfg, 4, 3)
    return jcfg, tcfg, jq, tq


def test_build_qp_matches(problem):
    _, _, jq, tq = problem
    assert_tree_close(tq, jq)


def test_build_qp_batched_matches_single():
    """Leading batch axes: two problems built at once equal one at a time."""
    jcfg, tcfg = configs()
    singles = [build_both(jcfg, tcfg, 4, 3, seed=s)[1] for s in (0, 1)]
    f32 = np.float32
    probs = [_random_problem(jcfg, 4, 3, s, True) for s in (0, 1)]
    stacked = [torch.as_tensor(np.stack([np.asarray(p[i], f32) for p in probs]))
               for i in range(8)]
    tb = tqp.build_qp(tcfg, *stacked)
    for i, single in enumerate(singles):
        for a, b in zip(_leaves(tb), _leaves(single)):
            np.testing.assert_array_equal(a[i], b)


def test_matvecs_match(problem):
    jcfg, tcfg, jq, tq = problem
    rng = np.random.RandomState(3)
    z = rng.randn(jcfg.num_vars).astype(np.float32)
    ja = jqp.a_matvec(jcfg, jq, jnp.asarray(z))
    ta = tqp.a_matvec(tcfg, tq, torch.as_tensor(z))
    assert_tree_close(ta, ja)
    w = [rng.randn(*np.shape(a)).astype(np.float32) for a in ja]
    jw = jqp.at_matvec(jcfg, jq, jqp.ConVec(*(jnp.asarray(a) for a in w)))
    tw = tqp.at_matvec(tcfg, tq, tqp.ConVec(*(torch.as_tensor(a) for a in w)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=1e-5)


def test_matvec_adjoint(problem):
    """<A z, w> == <z, A^T w> in the port (float32 sums of ~10^2 terms)."""
    _, tcfg, _, tq = problem
    rng = np.random.RandomState(1)
    z = torch.as_tensor(rng.randn(tcfg.num_vars).astype(np.float32))
    az = tqp.a_matvec(tcfg, tq, z)
    w = tqp.ConVec(*(torch.as_tensor(rng.randn(*a.shape).astype(np.float32))
                     for a in az))
    lhs = sum(float((a * b).sum()) for a, b in zip(az, w))
    rhs = float((z * tqp.at_matvec(tcfg, tq, w)).sum())
    assert abs(lhs - rhs) < 1e-4 * max(1.0, abs(lhs))


def test_rho_rowmax_colmax_match(problem):
    jcfg, tcfg, jq, tq = problem
    jr = jqp.rho_vec(jcfg, jq, 0.1, 1e3)
    tr = tqp.rho_vec(tcfg, tq, 0.1, 1e3)
    assert_tree_close(tr, jr)
    rng = np.random.RandomState(4)
    D = rng.uniform(0.1, 3.0, jcfg.num_vars).astype(np.float32)
    assert_tree_close(tqp.a_rowmax(tcfg, tq, torch.as_tensor(D)),
                      jqp.a_rowmax(jcfg, jq, jnp.asarray(D)))
    E = [rng.uniform(0.1, 3.0, np.shape(a)).astype(np.float32) for a in jr]
    np.testing.assert_allclose(
        tqp.a_colmax(tcfg, tq, tqp.ConVec(*(torch.as_tensor(a) for a in E))
                     ).numpy(),
        np.asarray(jqp.a_colmax(jcfg, jq,
                                jqp.ConVec(*(jnp.asarray(a) for a in E)))),
        rtol=RTOL, atol=ATOL)


def test_split_merge_roundtrip(problem):
    jcfg, tcfg, _, _ = problem
    z = np.arange(jcfg.num_vars, dtype=np.float32)
    X, U = tqp.split_z(torch.as_tensor(z), tcfg)
    jX, jU = jqp.split_z(jnp.asarray(z), jcfg)
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    np.testing.assert_array_equal(tqp.merge_z(X, U).numpy(), z)


def test_normal_matrix_matches(problem):
    """assemble_normal_matrix (tests only) against the JAX assembly."""
    jcfg, tcfg, jq, tq = problem
    hd = jqp.hessian_diag(jcfg)
    jr = jqp.rho_vec(jcfg, jq, 0.1, 1e3)
    jm = jqp.assemble_normal_matrix(jcfg, jq, hd, 1e-6, jr)
    tm = tqp.assemble_normal_matrix(tcfg, tq, tqp.hessian_diag(tcfg), 1e-6,
                                    tqp.rho_vec(tcfg, tq, 0.1, 1e3))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_array_equal(tqp.hessian_diag(tcfg).numpy(),
                                  np.asarray(hd, np.float32))
