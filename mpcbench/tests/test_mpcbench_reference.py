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


def _window(workload, patch=None, monkeypatch=None, seconds=1.5):
    from mpcbench import run as R
    if patch is not None:
        from intent_mpc_torch.engine import closed_loop as cl
        monkeypatch.setattr(cl, "episode_step", patch(cl.episode_step))
    c = tiny_cell(workload)
    return R.run_cell(c, tiny_args(workload, seconds=seconds), torch.device("cpu"))


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
    from mpcbench import check, generator
    from mpcbench import harness as hz
    from mpcbench.reference.solve import Precision
    from intent_mpc_torch.models.occupancy import empty_grid
    from intent_mpc_torch.models.world import Scenario
    c = tiny_cell(workload)
    cfg, tr = c["config"], c["traffic"]
    pcfg = hz.program_config(cfg)
    blocks_np, ref_np = generator.make(cfg, tr, 12345)
    blocks = [Scenario(**{k: torch.as_tensor(v) for k, v in b.items()})
              for b in blocks_np]
    ref = torch.as_tensor(ref_np)
    sampler = check.Sampler(1, 3, pcfg.planner.solver.factor_reuse_cycles,
                            check.settled_from(cfg))
    fl = hz.Flights(pcfg, blocks, ref, empty_grid(torch.device("cpu")),
                    tr["episode_cycles"], sampler)
    for _ in range(9):
        fl.step()
    samples = sampler.take()
    bref = [{k: torch.as_tensor(v) for k, v in b.items()} for b in blocks_np]
    cpu = torch.device("cpu")
    prog, ctl = [], []
    for s in samples:
        prog.append(check.stage_gaps(cfg, bref, ref, s, 2, cpu))
        after = check.control_after(cfg, bref, ref, s, Precision(prec), 2, cpu)
        ctl.append(check.stage_gaps(cfg, bref, ref, s, 2, cpu, program=after))
    ok_p, _ = check.judge(check.numbers(prog), cfg["correct_limits"])
    ok_c, rows = check.judge(check.numbers(ctl), cfg["correct_limits"])
    assert ok_p and not ok_c, rows


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
