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


def _static_boxes():
    """Three clustered static boxes near the path (rotated; the third
    inactive) as (centroid, size, yaw, active)."""
    return (np.array([[2.5, 0.6, 2.0], [4.0, -1.0, 2.0], [1.0, 3.0, 2.0]],
                     np.float32),
            np.array([[0.4, 1.0, 3.0], [1.0, 0.4, 3.0], [0.5, 0.5, 1.0]],
                     np.float32),
            np.array([0.3, -0.5, 1.0], np.float32),
            np.array([True, True, False]))


@pytest.mark.parametrize("planner", ["make_plan_with_pred", "make_plan"])
def test_static_rows_match_jax(setup, planner):
    """static_obs (the clustered static boxes of the real-perception loop)
    on both planners from the state after the first solve: the static
    rows bind with the static safety distance, the static slack column
    (obs_dyn 0) and the boxes' yaw. The predictor path factors afresh (no
    cycle index; the carried factor's static sizing is checked below and
    in the closed-loop tests); the constant-obstacle path refines once per
    x-update, as tests/test_torch_loop_options.py holds it. Candidate
    states atol 1e-4, as above; validity, solve flags and the chosen
    candidate equal; the plan moves against the one without the rows."""
    import dataclasses
    jcfg, tcfg, plan, state1, tin, L = setup
    if planner == "make_plan":
        jcfg, tcfg = (c.replace(planner=dataclasses.replace(
            c.planner, solver=dataclasses.replace(c.planner.solver,
                                                  refine_iters=1)))
            for c in (jcfg, tcfg))
    box = _static_boxes()
    tbox = tuple(torch.as_tensor(a)[None] for a in box)
    pos = jnp.asarray(tin["pos"][0].numpy())
    vel = jnp.asarray(tin["vel"][0].numpy())
    ref = jnp.asarray(tin["ref"].numpy())
    tstate = convert.from_numpy(_np_tree(state1), tmpc.PlannerState,
                                add_batch_axis=True)
    if planner == "make_plan_with_pred":
        jpred_ = jax.tree.map(lambda a: jnp.asarray(a[0].numpy()),
                              tuple(tin["pred"]))
        jp = jpred.Prediction(*jpred_)
        vis = jnp.asarray(tin["vis"][0].numpy())
        jf = jax.jit(lambda st, so: jmpc.make_plan_with_pred(
            jcfg.planner, st, pos, vel, ref, jnp.asarray(L), jp, vis,
            static_obs=so))
        jout, jnone = jf(state1, tuple(map(jnp.asarray, box))), jf(state1,
                                                                   None)
        tout = tmpc.make_plan_with_pred(tcfg.planner, tstate, tin["pos"],
                                        tin["vel"], tin["ref"], L,
                                        tin["pred"], tin["vis"],
                                        static_obs=tbox)
    else:
        nom = tin["pred"].pos[:, :, 0, 0]
        ob = (jnp.asarray(nom[0].numpy()), jnp.zeros_like(nom[0].numpy()),
              jnp.asarray(tin["pred"].size[0, :, 0, 0].numpy()))
        vis = jnp.asarray(tin["vis"][0].numpy())
        jf = jax.jit(lambda st, so: jmpc.make_plan(
            jcfg.planner, st, pos, vel, ref, jnp.asarray(L), *ob, vis,
            static_obs=so))
        jout, jnone = jf(state1, tuple(map(jnp.asarray, box))), jf(state1,
                                                                   None)
        tout = tmpc.make_plan(tcfg.planner, tstate, tin["pos"], tin["vel"],
                              tin["ref"], L, nom, torch.zeros_like(nom),
                              tin["pred"].size[:, :, 0, 0], tin["vis"],
                              static_obs=tbox)
    np.testing.assert_allclose(tout.candidate_states.numpy()[0],
                               np.asarray(jout.candidate_states), atol=1e-4)
    assert int(tout.best_idx[0]) == int(jout.best_idx)
    assert bool(tout.valid[0]) == bool(jout.valid)
    np.testing.assert_array_equal(tout.solved.numpy()[0],
                                  np.asarray(jout.solved))
    np.testing.assert_allclose(tout.state.states_sol.numpy()[0],
                               np.asarray(jout.state.states_sol), atol=1e-4)
    moved = np.abs(np.asarray(jout.state.states_sol)
                   - np.asarray(jnone.state.states_sol)).max()
    assert moved > 1e-2, moved


def test_static_clustering_sizes_the_carried_factor():
    """With static clustering the carried shared factor's obstacle scaling
    holds max_obstacles + cluster_slots + 1 slots, as in JAX."""
    import dataclasses
    for static in (False, True):
        jp = dataclasses.replace(jsmall(**KW).planner,
                                 static_clustering=static)
        tp = dataclasses.replace(tsmall(**KW).planner,
                                 static_clustering=static)
        want = jmpc.init_planner_state(jp).fac_e.obs.shape
        got = tmpc.init_planner_state(tp, 2).fac_e.obs.shape
        assert got == (2,) + tuple(want)
        assert want[-1] == KW["max_obstacles"] + 1 + 16 * static
