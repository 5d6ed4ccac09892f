"""Port parity: intent_mpc_torch.models.mpc.make_plan_with_pred against the
JAX package, from identical planner states, with more obstacles than QP
slots (12 obstacles, max_obstacles=4) so the nearest-obstacle cap runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intent_mpc_tpu.models import detector as jdet
from intent_mpc_tpu.models import mpc as jmpc
from intent_mpc_tpu.models import predictor as jpred
from intent_mpc_tpu.models import world as jworld
from intent_mpc_tpu.models.occupancy import empty_grid as jempty
from intent_mpc_tpu.utils.config import small_config as jsmall
from intent_mpc_torch.models import mpc as tmpc
from intent_mpc_torch.models.predictor import Prediction
from intent_mpc_torch.utils import convert
from intent_mpc_torch.utils.config import small_config as tsmall

torch.set_num_threads(1)

KW = dict(num_obstacles=12, horizon=8, timeout=0.5, max_obstacles=4, hist=8)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    """A JAX prediction over 12 obstacles, seven of them moved near the
    drone's path (more visible obstacles than slots), and the planner
    state after the first (unconstrained) solve of cycle 0."""
    jcfg = jsmall(**KW).replace(goal=(8.0, 0.0, 2.0))
    tcfg = tsmall(**KW).replace(goal=(8.0, 0.0, 2.0))
    sc = jworld.generate_scenario(3, jcfg.world)
    origin = np.array(sc.origin)
    origin[:7] = [(3.0, 0.4, 2.0), (5.0, -0.5, 2.2), (9.0, 2.0, 2.0),
                  (12.0, -3.0, 2.0), (15.0, 1.0, 3.0), (18.0, -1.0, 1.5),
                  (20.0, 4.0, 2.0)]
    sc = sc._replace(origin=jnp.asarray(origin))
    d = jdet.init_detector(12, jcfg.detector,
                           jworld.obstacle_state(sc, jnp.float32(0.0))[0])
    for k in range(4):
        t = jnp.float32(0.1 * k)
        p, _ = jworld.obstacle_state(sc, t)
        d = jdet.hist_push(jdet.fd_update(jcfg.detector, d, p, t), p)
    pos = jnp.array([0.2, 0.0, 2.0], jnp.float32)
    vel = jnp.array([1.0, 0.0, 0.0], jnp.float32)
    ph, vh, ah, sz, hl, vis = jdet.query_history(jcfg.detector, d, sc.bbox, pos)
    pred = jpred.predict(jcfg.predictor, ph, vh, ah, sz, hl, jempty())
    ref = jworld.straight_line_ref_traj((0.0, 0.0, 2.0), jcfg.goal, 0.5)
    plan = jax.jit(lambda st, c: jmpc.make_plan_with_pred(
        jcfg.planner, st, pos, vel, ref, jnp.asarray(ref.shape[0]), pred,
        vis, cycle_idx=c))
    out0 = plan(jmpc.init_planner_state(jcfg.planner), jnp.asarray(0))
    assert bool(out0.valid) and not bool(out0.state.first_time)
    tin = dict(pos=torch.as_tensor(np.array(pos))[None],
               vel=torch.as_tensor(np.array(vel))[None],
               ref=torch.as_tensor(np.array(ref)),
               pred=convert.from_numpy(_np_tree(pred), Prediction,
                                       add_batch_axis=True),
               vis=torch.as_tensor(np.array(vis))[None])
    assert int(tin["vis"].sum()) > KW["max_obstacles"]
    return jcfg, tcfg, plan, out0.state, tin, int(ref.shape[0])


@pytest.mark.parametrize("cycle", [0, 4, 1])
def test_make_plan_matches_jax(setup, cycle):
    """cycle 0 plans from the initial state (no obstacle rows), cycle 4
    refreshes the shared factor with obstacle rows, cycle 1 reuses the
    factor carried from cycle 0. Candidate states atol 1e-4 (30 ADMM
    iterations of float32 with differently rounded factors); the chosen
    candidate, validity and solve flags are equal."""
    jcfg, tcfg, plan, state1, tin, L = setup
    jstate = jmpc.init_planner_state(jcfg.planner) if cycle == 0 else state1
    jout = plan(jstate, jnp.asarray(cycle))
    tstate = convert.from_numpy(_np_tree(jstate), tmpc.PlannerState,
                                add_batch_axis=True)
    tout = tmpc.make_plan_with_pred(tcfg.planner, tstate, tin["pos"],
                                    tin["vel"], tin["ref"], L, tin["pred"],
                                    tin["vis"], cycle_idx=cycle)
    np.testing.assert_allclose(tout.candidate_states.numpy()[0],
                               np.asarray(jout.candidate_states), atol=1e-4)
    assert int(tout.best_idx[0]) == int(jout.best_idx)
    assert bool(tout.valid[0]) == bool(jout.valid)
    np.testing.assert_array_equal(tout.solved.numpy()[0],
                                  np.asarray(jout.solved))
    np.testing.assert_allclose(tout.state.states_sol.numpy()[0],
                               np.asarray(jout.state.states_sol), atol=1e-4)
    assert int(tout.state.last_ref_start[0]) == int(jout.state.last_ref_start)
    np.testing.assert_allclose(tout.state.fac_d.numpy()[0],
                               np.asarray(jout.state.fac_d), rtol=1e-5)


def test_candidate_sort_breaks_ties_like_reference():
    """Equal combo weights keep the reference order: descending weight,
    descending combo id on ties (a stable ascending sort, reversed)."""
    w = torch.tensor([[0.25, 0.25, 0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.2, 0.3, 0.4, 0.3]])
    got = torch.argsort(w, dim=-1, stable=True).flip(-1)
    want = np.stack([np.flip(np.argsort(np.asarray(r), kind="stable"))
                     for r in w.numpy()])
    np.testing.assert_array_equal(got.numpy(), want)
