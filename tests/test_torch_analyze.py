"""Port parity: intent_mpc_torch.benchmark.analyze (load_rows,
combine_runs, recheck_collisions, latex_table) and the harness's row
builder against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from intent_mpc_tpu.benchmark import analyze as JA
from intent_mpc_tpu.benchmark import harness as JH
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.utils.config import IntentMPCConfig as JConfig
from intent_mpc_tpu.utils.config import small_config as jsmall_config
from intent_mpc_torch.benchmark import analyze as A
from intent_mpc_torch.benchmark import harness as H
from intent_mpc_torch.models import world as tworld
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import IntentMPCConfig, small_config

torch.set_num_threads(1)

SEEDS = [1, 2]


def _small(make):
    return make(num_obstacles=6, horizon=10, timeout=1.5, max_obstacles=6,
                hist=12).replace(goal=(8.0, 0.0, 2.0))


@pytest.fixture(scope="module")
def metrics():
    """The port's per-scenario metrics after 5 cycles of the small config."""
    cfg = _small(small_config)
    scen = sh.stack_scenarios(cfg, SEEDS, device="cpu")
    ref = straight_line_ref_traj(cfg.start, cfg.goal, 2.5)
    m, _ = sh.batch_rollout(cfg, scen, ref, ref.shape[0], solver_iters=30,
                            num_cycles=5, device="cpu")
    return m


def test_rows_from_metrics_equal_jax(metrics):
    """On the same metrics the port's rows equal the JAX harness's
    _rows_from_metrics exactly: the same keys in order, values and types."""
    trows = H.rows_from_metrics(_small(small_config), SEEDS, metrics)
    jrows = JH._rows_from_metrics(_small(jsmall_config), SEEDS,
                                  jax.tree.map(lambda t: t.numpy(), metrics))
    assert trows == jrows
    assert [list(r) for r in trows] == [list(r) for r in jrows]
    assert all(type(trows[0][k]) is type(v) for k, v in jrows[0].items())


def test_csv_of_both_packages_combine_to_the_same_rows(metrics, tmp_path):
    """A port-written trials.csv and a JAX-written one (same header) merge
    through either package's combine_runs into the same rows, exactly;
    load_rows gives back the written rows (floats print as their repr)."""
    trows = H.rows_from_metrics(_small(small_config), SEEDS, metrics)
    jrows = JH._rows_from_metrics(_small(jsmall_config), [5, 6],
                                  jax.tree.map(lambda t: t.numpy(), metrics))
    H.save_csv(trows, str(tmp_path / "port" / "trials.csv"))
    JH.save_csv(jrows, str(tmp_path / "jax" / "trials.csv"))
    with open(tmp_path / "port" / "trials.csv") as f, \
            open(tmp_path / "jax" / "trials.csv") as g:
        assert f.readline() == g.readline()
    assert A.load_rows(str(tmp_path / "port" / "trials.csv")) == trows
    dirs = [str(tmp_path / "port"), str(tmp_path / "jax")]
    merged = A.combine_runs(dirs)
    assert merged == JA.combine_runs(dirs)
    assert [r["trial_id"] for r in merged] == [0, 1, 2, 3]
    assert [r["seed"] for r in merged] == SEEDS + [5, 6]


@pytest.mark.parametrize("z,pillar", [(2.0, False), (4.0, False),
                                      (10.0, True)],
                         ids=["low", "near_miss", "through_pillar"])
def test_recheck_collisions_matches_jax(z, pillar):
    """A seeded 60-cycle path at height z through the full DYNUS world
    (seed 3), upsampled 10x: the same collided flag, and min distance to
    atol 1e-4 (float32 sin/cos of the trefoil differ by ulps between XLA
    and torch, ~1e-5 m at these coordinates). At z = 2 the path collides;
    at z = 4 it misses by ~3.5 cm; `through_pillar` passes the centre of
    a static obstacle, so both must report a collision at distance 0."""
    rng = np.random.default_rng(11)
    C = 60
    jsc = jworld.generate_scenario(3, JConfig().world)
    tsc = tworld.generate_scenario(3, IntentMPCConfig().world)
    a = np.linspace(0.0, 1.0, C)[:, None]
    path = (np.array([0.0, 0.0, z]) * (1 - a) + np.array([105.0, 0.0, z]) * a
            + rng.normal(scale=0.3, size=(C, 3)))
    if pillar:
        k = int(np.argmax(np.asarray(jsc.is_static)))
        path[C // 2] = np.asarray(jsc.origin)[k]
    path = path.astype(np.float32)
    jhit, jd = JA.recheck_collisions(jsc, path, 0.1)
    thit, td = A.recheck_collisions(tsc, path, 0.1)
    assert thit == jhit
    assert abs(td - jd) <= 1e-4
    assert thit == (z != 4.0)
    if thit:
        assert td == 0.0


def test_latex_table_matches_jax(metrics):
    """The LaTeX summary row of the same aggregate is the same string."""
    rows = H.rows_from_metrics(_small(small_config), SEEDS, metrics)
    agg = H.aggregate(rows)
    assert A.latex_table(agg) == JA.latex_table(agg)
    assert A.latex_table(agg).startswith("Success & Collision")
