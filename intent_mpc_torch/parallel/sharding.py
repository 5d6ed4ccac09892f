"""Scenario-batch rollouts on one device or over a fleet of processes
(port of intent_mpc_tpu/parallel/sharding.py).

The scale axis is the scenario batch: S closed-loop environments step
together on one GPU. A fleet is one process per GPU under
torch.distributed (JAX shards the batch over a device mesh with
shard_map instead): each rank generates and flies only its own
contiguous block of seeds, and the fleet statistics are reduced with two
all_reduces, a float32 7-vector of sums and the float32 smallest
obstacle distance (JAX's one psum and one pmin: 32 bytes per fleet
episode). No per-scenario tensor crosses processes, and no rank ever
holds the whole fleet.

    rank = init_distributed("tcp://127.0.0.1:29500", world, rank,
                            backend="nccl")       # "gloo" on the CPU
    fleet = make_mesh()                            # cuda:<local rank>
    scen = stack_scenarios_global(cfg, seeds, fleet)
    metrics, agg = batch_rollout(cfg, scen, ref, L, mesh=fleet)

`parallel/launch.spawn` starts such ranks as processes of their own
(`init_process_group` runs once per process); `collective_report`
runs a fleet rollout and inventories what it really sent between them.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.world import Scenario, generate_scenario_numpy
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device

# the fleet statistics in the JAX dict's key order; all but min_dist_min
# are sums
AGG_KEYS = ("episodes", "goals", "collisions", "path_length_sum",
            "travel_time_sum", "min_dist_min", "solve_attempts",
            "solve_successes")
SUM_KEYS = tuple(k for k in AGG_KEYS if k != "min_dist_min")

# torch.distributed's collectives under the names of JAX's HLO inventory
_JAX_NAMES = {
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "allgather_coalesced": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "recv_any_source": "collective-permute",
}
_BACKENDS = ("gloo", "nccl", "ucc", "mpi")
# element sizes of the profiler's dtype names
_DTYPE_BYTES = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
                "int": 4, "long int": 8, "short int": 2, "signed char": 1,
                "unsigned char": 1, "bool": 1}


class Fleet(NamedTuple):
    """The port's mesh: this process's place in the fleet."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object]    # the process group; None: one process


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl") -> int:
    """Join the fleet's process group: once per process, before
    make_mesh. The address is "tcp://host:port", "host:port" or
    "file:///path" (a FileStore); a loopback address keeps NCCL's and
    gloo's sockets on the loopback interface. backend: "nccl" on the
    card, "gloo" on the CPU. With no arguments nothing is initialized
    (one process, as JAX's single-process runs). Returns this rank."""
    if coordinator_address is None and num_processes is None:
        return dist.get_rank() if dist.is_initialized() else 0
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed needs the address, the number "
                         "of processes and this process's id")
    addr = (coordinator_address if "://" in coordinator_address
            else "tcp://" + coordinator_address)
    host = addr.split("://", 1)[1].rsplit(":", 1)[0]
    if addr.startswith("file://") or host in ("127.0.0.1", "localhost"):
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def make_mesh(n_devices: Optional[int] = None, device=None) -> Fleet:
    """This process's Fleet: its rank, the world size, its device and the
    process group. The device is cuda:<LOCAL_RANK, else the rank> (mod
    the cards present) unless `device` names another ("cpu" for the gloo
    fleets of the tests). Without an initialized process group this is
    the one-process fleet (n_devices None or 1). A fleet spans every rank
    of its group: n_devices, when given, must be the world size."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        group = dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if n_devices is not None and n_devices != world:
        raise ValueError("a fleet spans every rank of its process group: "
                         "%d devices asked, world size %d (start one "
                         "process per device, init_distributed)"
                         % (n_devices, world))
    if device is None and group is not None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return Fleet(rank=rank, world=world, device=resolve_device(device),
                 group=group)


def stack_scenarios(cfg: IntentMPCConfig, seeds, device=None) -> Scenario:
    """Generate seeded scenarios on the host and stack them on `device`
    (the GPU by default) as one (S, N, ...) batch."""
    dev = resolve_device(device)
    scs = [generate_scenario_numpy(int(s), cfg.world) for s in seeds]
    if not scs:
        raise ValueError("need at least one seed/trial")
    return Scenario(**{k: torch.as_tensor(np.stack([s[k] for s in scs]),
                                          device=dev)
                       for k in Scenario._fields})


def rank_block(n: int, mesh: Fleet) -> slice:
    """This rank's contiguous block of n fleet entries."""
    if n % mesh.world:
        raise ValueError(f"trial count {n} must divide process count "
                         f"{mesh.world}")
    per = n // mesh.world
    if per == 0:
        raise ValueError("need at least one seed per process")
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def stack_scenarios_global(cfg: IntentMPCConfig, seeds,
                           mesh: Fleet) -> Scenario:
    """The fleet's scenario feed: this rank generates only its contiguous
    block of the seeds (rank r of W holds seeds[r n/W : (r + 1) n/W]) on
    its device. With one process this equals stack_scenarios."""
    seeds = list(seeds)
    return stack_scenarios(cfg, seeds[rank_block(len(seeds), mesh)],
                           device=mesh.device)


def shard_scenarios(batch, mesh: Fleet):
    """The block of a fleet-wide batch (a tensor or a tuple of tensors
    with the fleet axis first, such as a stacked Scenario or a key batch)
    that belongs to this rank, on its device."""
    if isinstance(batch, torch.Tensor):
        return batch[rank_block(batch.shape[0], mesh)].to(mesh.device)
    return type(batch)(*(shard_scenarios(a, mesh) for a in batch))


def _local_stats(m: cl.Metrics):
    """(the SUM_KEYS sums (7,), the smallest obstacle distance (1,)) of
    this rank's episodes, float32 on their device."""
    f = torch.float32
    sums = torch.stack([
        torch.full((), m.goal_reached.shape[0], dtype=f,
                   device=m.path_length.device),
        torch.sum(m.goal_reached.to(f)), torch.sum(m.collision.to(f)),
        torch.sum(m.path_length), torch.sum(m.travel_time),
        torch.sum(m.solve_attempts.to(f)),
        torch.sum(m.solve_successes.to(f))])
    return sums, torch.min(m.min_obstacle_dist).reshape(1)


def batch_rollout(cfg: IntentMPCConfig, scenarios: Scenario,
                  ref_traj: torch.Tensor, traj_len,
                  mesh: Optional[Fleet] = None,
                  solver_iters: Optional[int] = None,
                  num_cycles: Optional[int] = None,
                  record_paths: bool = False,
                  occ=None, ref_keys: Optional[torch.Tensor] = None,
                  device=None):
    """Run a batch of episodes, on one device (the GPU by default) or on
    this rank's block of the fleet `mesh`.

    occ: the static occupancy grid every scenario shares (goal mode, the
    real detector); ref_keys: (B, 2) one utils/prng key per fleet
    scenario for the goal-mode RRT builds, split with the scenarios
    (rank r flies keys[r S:(r + 1) S] with its S scenarios).

    With a mesh, `scenarios` is this rank's block
    (stack_scenarios_global, shard_scenarios) and runs on the rank's
    device, and the fleet statistics are reduced across ranks with exactly
    two all_reduces on PyTorch's current stream (the sums, the minimum).
    The aggregate is read with one host copy either way.

    Returns (this rank's per-scenario Metrics, aggregate dict of fleet
    statistics[, paths (S, C, 3) when record_paths])."""
    dev = mesh.device if mesh is not None else device
    keys = ref_keys
    if mesh is not None and ref_keys is not None:
        S = scenarios.origin.shape[0]
        if ref_keys.shape[0] != S * mesh.world:
            raise ValueError("ref_keys holds %d keys for a fleet of %d x %d "
                             "scenarios" % (ref_keys.shape[0], mesh.world, S))
        keys = ref_keys[mesh.rank * S:(mesh.rank + 1) * S]
    carry, paths = cl.run_episode(cfg, scenarios, ref_traj, traj_len, occ=occ,
                                  solver_iters=solver_iters,
                                  num_cycles=num_cycles,
                                  record_path=record_paths, device=dev,
                                  ref_key=keys)
    m = carry.metrics
    sums, low = _local_stats(m)
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(low, op=dist.ReduceOp.MIN, group=mesh.group)
    vals = dict(zip(SUM_KEYS + ("min_dist_min",),
                    torch.cat([sums, low]).tolist()))
    agg = {k: vals[k] for k in AGG_KEYS}
    if record_paths:
        return m, agg, paths
    return m, agg


def collective_report(cfg: IntentMPCConfig, scenarios: Scenario,
                      ref_traj: torch.Tensor, traj_len, mesh: Fleet,
                      **kwargs):
    """Run one fleet rollout (batch_rollout with `mesh`; kwargs as it
    takes them) and inventory what it sends between processes.

    JAX reads the collectives from the compiled HLO; the port has no HLO,
    so it runs the rollout under torch.profiler with record_shapes and
    counts every `c10d::` collective op the process issued, from this
    module or any other: an all_gather of a scenario tensor, or an
    all_reduce of anything larger than the statistics, would be a
    sharding leak. Each op's bytes are those of the tensors its backend's
    record ("gloo:all_reduce", "nccl:all_reduce", ...) carries, paired
    with the c10d ops in time order. The profiler's raw event list is
    read (building its Python event tree costs minutes for the ~50k ops
    of every cycle).

    Returns (batch_rollout's result, the inventory {"counts": {op: n},
    "total_bytes": int, "ops": [(op, bytes), ...]}) under JAX's op names
    ("all-reduce", "all-gather", ...; an op JAX has no name for keeps
    torch's)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = batch_rollout(cfg, scenarios, ref_traj, traj_len, mesh=mesh,
                            **kwargs)
    return out, inventory(prof.profiler.kineto_results.events())


def _get(evt, name):
    v = getattr(evt, name)
    return v() if callable(v) else v


def _event_bytes(evt) -> int:
    total = 0
    for shape, dtype in zip(_get(evt, "shapes"), _get(evt, "dtypes")):
        if not shape or not dtype:
            continue
        if dtype not in _DTYPE_BYTES:
            raise ValueError("collective on a tensor of dtype %r" % (dtype,))
        total += int(np.prod(shape)) * _DTYPE_BYTES[dtype]
    return total


def inventory(events) -> dict:
    """collective_report's inventory of the profiler's raw events (each
    with name, start_ns, shapes and dtypes)."""
    named = [(_get(e, "start_ns"), _get(e, "name"), e) for e in events]
    ops = sorted((t, n) for t, n, _ in named if n.startswith("c10d::"))
    records = sorted(((t, e) for t, n, e in named
                      if ":" in n and n.split(":", 1)[0] in _BACKENDS),
                     key=lambda r: r[0])
    out, used = [], 0
    for t, name in ops:
        # the backend's record of this op: the first one not before it
        while used < len(records) and records[used][0] < t:
            used += 1
        nbytes = 0
        if used < len(records):
            nbytes = _event_bytes(records[used][1])
            used += 1
        name = name[len("c10d::"):].rstrip("_")
        out.append((_JAX_NAMES.get(name, name), nbytes))
    counts: dict = {}
    for op, _ in out:
        counts[op] = counts.get(op, 0) + 1
    return {"counts": counts, "total_bytes": sum(b for _, b in out),
            "ops": out}


def aggregate_summary(agg: dict) -> dict:
    n = max(agg["episodes"], 1.0)
    return {
        "num_episodes": int(n),
        "success_rate": agg["goals"] / n,
        "collision_rate": agg["collisions"] / n,
        "avg_path_length": agg["path_length_sum"] / n,
        "avg_travel_time": agg["travel_time_sum"] / max(agg["goals"], 1.0),
        "min_obstacle_distance": agg["min_dist_min"],
        "solver_success_rate": agg["solve_successes"]
        / max(agg["solve_attempts"], 1.0),
    }
