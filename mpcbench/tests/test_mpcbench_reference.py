"""The plain reference against the program at a small size on the CPU,
the controls (the reference in the program's place, its products in
TF32 or its stored results in bfloat16) failing the comparison, the
comparison's own rules, and a run with the timed path broken underneath
coming out not correct, once for each fault a cell can have."""

from __future__ import annotations

import pytest
import torch

from mpcbench_cells import tiny_args, tiny_cell

CELLS = ("dynus200-default.batch128", "dynus200-fused.rt32")


def _window(workload, patch=None, monkeypatch=None, cycles=12):
    """A CPU window of `cycles` cycles (12: two flights and part of a
    third, each with a settled cycle of the default path)."""
    from mpcbench import run as R
    if patch is not None:
        from intent_mpc_torch.engine import closed_loop as cl
        monkeypatch.setattr(cl, "episode_step", patch(cl.episode_step))
    c = tiny_cell(workload)
    return R.run_cell(c, tiny_args(workload, cycles=cycles), torch.device("cpu"))


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_the_reference(workload):
    res, rows = _window(workload)
    assert res["correct"] is True, rows
    vals = {n: v for n, v, _ in rows}
    assert vals["flag_mismatches"] == 0
    assert vals["plant_m"] < 1e-5 and vals["detector_pos_m"] < 1e-4


@pytest.mark.parametrize("prec", ["tf32", "bf16"])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload, prec):
    """The reference in the program's place, computed in `prec` from the
    program's own states of the sampled cycles, fails a limit."""
    from mpcbench import check
    from mpcbench.reference.solve import Precision
    from mpcbench.run import Prepared
    c = tiny_cell(workload)
    pre = Prepared(c, 12345, torch.device("cpu"))
    sampler = check.Sampler(1, 3, pre.every, check.settled_from(c["config"]))
    fl = pre.flights(sampler)
    for _ in range(9):
        fl.step()
    samples = sampler.take()
    limits = c["config"]["correct_limits"]
    ok_p, _ = check.judge(pre.numbers(samples), limits)
    ok_c, rows = check.judge(pre.numbers(samples, Precision(prec)), limits)
    assert ok_p and not ok_c, rows


# The compared numbers of the rehearsal below as the check gave them before
# it was split into stage files (commit 0be7c8a: check.stage_gaps and
# check.control_after with the ground-truth stages written out in them), on
# this rehearsal's seed, cycles and sizes; each number's repr, exactly.
PARENT = {
    "dynus200-default.batch128": {
        "program": {
            "detector_pos_m": 3.858097699094287e-06,
            "detector_vel_mps": 3.858100029027712e-05,
            "factor_minv_rel": 8.080346336586393e-05,
            "factor_scale_rel": 2.4934831347408926e-08,
            "plant_m": 6.637389287078577e-07,
            "plan_state_p50": 9.910019260317426e-06,
            "plan_state_p90": 1.1564944279562894e-05,
            "plan_state_p99": 1.2605494537892767e-05,
            "plan_state_max": 1.2687874365369112e-05,
            "flag_mismatches": 0.0,
        },
        "tf32": {
            "detector_pos_m": 3.858097699094287e-06,
            "detector_vel_mps": 3.858100029027712e-05,
            "factor_minv_rel": 0.00044536855232415074,
            "factor_scale_rel": 1.2136179386475917e-07,
            "plant_m": 3.856503840715675e-07,
            "plan_state_p50": 6.137709128058174,
            "plan_state_p90": 7.716798618411618,
            "plan_state_p99": 7.740572227440886,
            "plan_state_max": 7.757028545788341,
            "flag_mismatches": 0.0,
        },
        "bf16": {
            "detector_pos_m": 0.24538421630859375,
            "detector_vel_mps": 0.0031809973225813692,
            "factor_minv_rel": 0.0013834111261215607,
            "factor_scale_rel": 0.0022408063787159017,
            "plant_m": 0.008701987423151536,
            "plan_state_p50": 0.015015168350152042,
            "plan_state_p90": 0.015487424987840726,
            "plan_state_p99": 0.014625419180980908,
            "plan_state_max": 0.014630420578690462,
            "flag_mismatches": 4.0,
        },
    },
    "dynus200-fused.rt32": {
        "program": {
            "detector_pos_m": 3.858097699094287e-06,
            "detector_vel_mps": 3.858100029027712e-05,
            "plant_m": 1.7165390731044283e-07,
            "plan_state_p50": 3.5304643402622737e-06,
            "plan_state_p90": 3.7627517354421602e-06,
            "plan_state_p99": 3.971810391104058e-06,
            "plan_state_max": 3.995039130622047e-06,
            "flag_mismatches": 0.0,
        },
        "tf32": {
            "detector_pos_m": 3.858097699094287e-06,
            "detector_vel_mps": 3.858100029027712e-05,
            "plant_m": 6.106132048877555e-07,
            "plan_state_p50": 6.0662970415714,
            "plan_state_p90": 6.626740680365092,
            "plan_state_p99": 7.131139955279414,
            "plan_state_max": 7.187184319158783,
            "flag_mismatches": 0.0,
        },
        "bf16": {
            "detector_pos_m": 0.2390102915579746,
            "detector_vel_mps": 0.002985901530689894,
            "plant_m": 0.003278938421199973,
            "plan_state_p50": 0.015071536465782742,
            "plan_state_p90": 0.015394677505224053,
            "plan_state_p99": 0.015685504440721233,
            "plan_state_max": 0.015717818544665363,
            "flag_mismatches": 2.0,
        },
    },
}


@pytest.mark.parametrize("workload", CELLS)
def test_stages_give_the_parents_numbers(workload):
    """Each configuration's stage-driven check, program and both controls,
    gives exactly the numbers of the check before the split, on the same
    seeded CPU rehearsal: 12 cycles from seed 2**31 + 11 at the tiny size,
    3 sampled cycles."""
    from mpcbench.reference.solve import Precision
    from mpcbench.run import Prepared
    c = tiny_cell(workload)
    pre = Prepared(c, 2 ** 31 + 11, torch.device("cpu"))
    sampler = pre.sampler()
    fl = pre.flights(sampler)
    for _ in range(12):
        fl.step()
    samples = sampler.take()
    got = {"program": pre.numbers(samples)}
    for name in ("tf32", "bf16"):
        got[name] = pre.numbers(samples, Precision(name))
    assert got == PARENT[workload]


def test_a_box_turned_a_quarter_is_its_axes_swapped():
    """An obstacle row of a box turned by yaw: a quarter turn about z is
    the unturned box with its x and y semi-axes swapped."""
    import math
    from mpcbench.reference import qp as qplib
    pl = tiny_cell("dynus200-fused.rt32")["config"]["planner"]
    H, W, f64 = pl["horizon"], pl["horizon"] - 1, torch.float64
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, dtype=f64)
    x0, xref, lin, opos = rand(1, 6), rand(1, H, 3), rand(1, W, 3), rand(1, W, 2, 3)
    size = rand(1, W, 2, 3).abs() + 0.5
    act, dyn = torch.ones(1, W, 2, dtype=f64), torch.zeros(1, W, 2, dtype=f64)
    turned = qplib.build(pl, x0, xref, opos, size[..., [1, 0, 2]], dyn, act, lin,
                         torch.full((1, W, 2), math.pi / 2, dtype=f64))
    plain = qplib.build(pl, x0, xref, opos, size, dyn, act, lin)
    assert torch.allclose(turned.G, plain.G, rtol=1e-12, atol=1e-12)
    assert torch.allclose(turned.l, plain.l, rtol=1e-12, atol=1e-12)


def test_inactive_extra_rows_leave_the_candidates_as_they_were():
    """A perception stage's extra rows (static boxes) append rows to every
    candidate QP; inactive, they leave every other row as it was and add
    loose ones."""
    from mpcbench.reference import cycle as refc
    from mpcbench.reference.solve import Precision
    from mpcbench.run import Prepared
    from mpcbench import check
    c = tiny_cell("dynus200-fused.rt32")
    pre = Prepared(c, 2 ** 31 + 11, torch.device("cpu"))
    sampler = pre.sampler()
    fl = pre.flights(sampler)
    for _ in range(6):
        fl.step()
    sample = sampler.take()[-1]
    _, cyc = next(check._blocks(c["config"], pre.stages, pre.host_blocks(),
                                torch.as_tensor(pre.ref_np), sample,
                                Precision("float64"), 2, torch.device("cpu")))
    obs = cyc.obstacles(cyc.st, cyc.cycle)
    S, C = obs["visible"].shape[0], 3
    f64 = torch.float64
    extra = dict(pos=torch.ones(S, C, 3, dtype=f64), size=torch.ones(S, C, 3, dtype=f64),
                 yaw=torch.zeros(S, C, dtype=f64),
                 active=torch.zeros(S, C, dtype=torch.bool))
    a = refc.assemble(c["config"], cyc.ref, cyc.st, obs)["qps"]
    b = refc.assemble(c["config"], cyc.ref, cyc.st, dict(obs, extra=extra))["qps"]
    K = a.G.shape[-2]
    assert b.G.shape[-2] == K + C
    assert torch.equal(b.G[..., :K, :], a.G) and not b.G[..., K:, :].any()
    W = c["config"]["planner"]["horizon"] - 1
    m_lin = a.l.shape[-1] - W * K
    assert torch.equal(b.l[..., :m_lin], a.l[..., :m_lin])
    lo_a = a.l[..., m_lin:].unflatten(-1, (W, K))
    lo_b = b.l[..., m_lin:].unflatten(-1, (W, K + C))
    assert torch.equal(lo_b[..., :K], lo_a) and torch.isinf(lo_b[..., K:]).all()
    assert torch.equal(b.q, a.q)


def test_judge_fails_a_missing_number():
    """A limited number that the run did not produce (a factor the program
    no longer carries, say) fails, as a number that is not finite does."""
    from mpcbench import check
    limits = {"plant_m": 1e-3, "factor_minv_rel": 1e-3}
    assert check.judge({"plant_m": 1e-4, "factor_minv_rel": 1e-4}, limits)[0]
    ok, rows = check.judge({"plant_m": 1e-4}, limits)
    assert not ok and ("factor_minv_rel", None, 1e-3) in rows
    assert not check.judge({"plant_m": float("nan"), "factor_minv_rel": 0.0},
                           limits)[0]


@pytest.mark.parametrize("seed", range(20))
def test_sampler_holds_a_settled_cycle(seed, monkeypatch):
    """The sample holds k cycles, and a settled one wherever the window
    ran one, however few the settled cycles are."""
    from mpcbench import check
    monkeypatch.setattr(check, "snapshot", lambda carry: carry)
    sm = check.Sampler(seed, 3, 4, 4)
    cycles = [0, 1, 2, 3, 4, 0, 1, 2, 3, 0, 1, 2]
    for b, i in enumerate(cycles):
        sm.before(b, i, ("carry", b))
        sm.after(b, i, ("carry", b), ("carry", b + 1))
    got = sm.take()
    assert len(got) == 3 and any(s["cycle"] >= 4 for s in got)
    assert all(s["after"] == ("carry", s["block"] + 1) for s in got)


def _unchanged(step):
    def f(cfg, scen, ref, L, occ, carry, i, *a, **k):
        return carry, carry.pos
    return f


def _half_batch(step):
    """The step run on the first half of the scenarios only; the rest keep
    their state."""
    def f(cfg, scen, ref, L, occ, carry, i, *a, **k):
        from intent_mpc_torch.engine.closed_loop import tree_where
        new, pos = step(cfg, scen, ref, L, occ, carry, i, *a, **k)
        S = carry.pos.shape[0]
        keep = torch.arange(S) >= S // 2
        out = tree_where(keep, carry, new)
        return out, out.pos
    return f


def _command_altered(step):
    """One scenario's command moved by 1 cm where the step produces it."""
    def f(cfg, scen, ref, L, occ, carry, i, *a, **k):
        new, pos = step(cfg, scen, ref, L, occ, carry, i, *a, **k)
        p = new.pos.clone()
        p[0, 0] += 1e-2
        return new._replace(pos=p), p
    return f


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _command_altered],
                         ids=["state_unchanged", "half_batch", "command_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(workload, fault, monkeypatch):
    res, rows = _window(workload, fault, monkeypatch)
    assert res["correct"] is False, rows
