"""Rank tasks of tests/test_torch_sharding.py, run in fleet processes by
intent_mpc_torch.parallel.launch.spawn (one interpreter per rank, as
init_process_group runs once per process). No JAX here: each task
returns plain lists for the test to hold against the JAX package."""

import dataclasses
import time

import torch

from intent_mpc_torch.benchmark import harness as H
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import small_config


def _lists(tup):
    return {k: v.tolist() for k, v in zip(tup._fields, tup)}


def fleet_rollout(fleet, seeds, iters, cycles, inventory_cycles):
    """This rank's scenarios, its per-scenario metrics and the fleet
    aggregate of the multihost protocol (small_config(num_obstacles=8)),
    the one-process batch_rollout of the same block of seeds, and the
    inventory of the same program over inventory_cycles cycles."""
    cfg = small_config(num_obstacles=8)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=2.5,
                                 device=fleet.device)
    scen = sh.stack_scenarios_global(cfg, seeds, fleet)
    m, agg = sh.batch_rollout(cfg, scen, ref, ref.shape[0], mesh=fleet,
                              solver_iters=iters, num_cycles=cycles)
    m1, agg1 = sh.batch_rollout(cfg, scen, ref, ref.shape[0],
                                solver_iters=iters, num_cycles=cycles,
                                device=fleet.device)
    _, rep = sh.collective_report(cfg, scen, ref, ref.shape[0], fleet,
                                  solver_iters=iters,
                                  num_cycles=inventory_cycles)
    return {"rank": fleet.rank, "world": fleet.world,
            "scenarios": _lists(scen), "metrics": _lists(m), "agg": agg,
            "metrics_one_process": _lists(m1), "agg_one_process": agg1,
            "report": {"counts": rep["counts"],
                       "total_bytes": rep["total_bytes"]}}


def harness_rows(fleet, seeds, timeout, iters, checkpoint):
    """The fleet harness: this rank's rows of run_trials and of
    run_trials_checkpointed (its own snapshot file)."""
    cfg = small_config(num_obstacles=4, horizon=8, timeout=timeout,
                       max_obstacles=4, hist=8)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, timeout=timeout))
    rows = H.run_trials(cfg, seeds, mesh=fleet, solver_iters=iters)
    ck = H.run_trials_checkpointed(cfg, seeds, checkpoint, chunk_cycles=2,
                                   solver_iters=iters, mesh=fleet)
    return {"rows": rows, "checkpointed": ck,
            "file": H.rank_checkpoint_path(checkpoint, fleet),
            "threads": torch.get_num_threads()}


def fail_on_rank(fleet, rank):
    """Rank `rank` raises at once; every other rank waits ten minutes."""
    if fleet.rank == rank:
        raise RuntimeError("rank %d fails on purpose" % rank)
    time.sleep(600)
