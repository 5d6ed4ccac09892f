"""Fleet checkpoint / resume for long batched runs (port of
intent_mpc_tpu/engine/checkpoint.py).

A whole batched fleet (every scenario's EngineCarry plus the cycle
counter) snapshots to one .npz and resumes bit-exactly: a resumed run
issues the same operations on the same bits as the uninterrupted run, so
it continues the same trajectories.

The carry is nested NamedTuples whose optional fields may be None (the
planner's carried shared factor exists only with factor reuse, the real
detector's track table, history rings and perception stats only with
real perception, the composed goal modes' input trajectory, its length
and the build flag only there). The static maps of a real-perception
fleet are not state: like the scenarios they are rebuilt from the seeds
(benchmark/real_loop.static_maps). `flatten`
lists the tensor leaves in field order and skips None; `unflatten` puts
leaves back into a template built by `init_carry` from the config, so a
field, shape or dtype mismatch raises instead of mis-zipping leaves.
Leaves on the card are copied to the host for the file and restored onto
the run's device.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.world import Scenario
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import IntentMPCConfig
from intent_mpc_torch.utils.device import resolve_device


def flatten(tree) -> List[torch.Tensor]:
    """The tensor leaves of nested NamedTuples, in field order; None
    fields contribute nothing."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in flatten(sub)]
    return [tree]


def unflatten(template, leaves: Sequence[torch.Tensor]):
    """Nested NamedTuples shaped like `template` holding `leaves` (in
    `flatten` order); a None field of the template stays None."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            return type(t)(*(build(sub) for sub in t))
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def npz_path(path: str) -> str:
    """The file a checkpoint at `path` lives in: np.savez appends .npz, so
    a resume check must look for the name the save wrote."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, carry: cl.EngineCarry, cycle_idx: int,
                    seeds: Sequence[int]) -> None:
    """Snapshot a batched EngineCarry + progress to .npz.

    The write is atomic (temp file + os.replace) so preemption mid-write,
    the very event checkpointing exists to survive, cannot truncate the
    previous good checkpoint."""
    leaves = flatten(carry)
    # numpy has no bfloat16: such a leaf (a bf16 shared factor) is kept as
    # its bit pattern and viewed back against the template on load
    arrs = {f"leaf_{i}": (l.view(torch.int16) if l.dtype == torch.bfloat16
                          else l).detach().cpu().numpy()
            for i, l in enumerate(leaves)}
    arrs["num_leaves"] = np.asarray(len(leaves))
    arrs["cycle_idx"] = np.asarray(int(cycle_idx))
    arrs["seeds"] = np.asarray(list(seeds), np.int64)
    path = npz_path(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_checkpoint(path: str, cfg: IntentMPCConfig, device=None,
                    ref_len: Optional[int] = None
                    ) -> Tuple[cl.EngineCarry, int, np.ndarray, Scenario]:
    """Restore (carry, cycle_idx, seeds, regenerated scenarios) on
    `device` (the GPU by default). ref_len: the input-trajectory
    allocation of the composed goal modes (as init_carry takes it).

    Scenarios are regenerated from the stored seeds (bit-exact MT19937
    world generation), so the checkpoint stays small."""
    dev = resolve_device(device)
    with np.load(npz_path(path)) as z:
        n = int(z["num_leaves"])
        arrs = [z[f"leaf_{i}"] for i in range(n)]
        cycle_idx = int(z["cycle_idx"])
        seeds = z["seeds"]
    scen = sh.stack_scenarios(cfg, [int(s) for s in seeds], device=dev)
    template = cl.init_carry(cfg, scen, device=dev, ref_len=ref_len)
    t_leaves = flatten(template)
    if len(t_leaves) != n:
        raise ValueError(
            f"checkpoint has {n} leaves but EngineCarry now has "
            f"{len(t_leaves)}: config/code mismatch")
    leaves = []
    for i, (a, b) in enumerate(zip(arrs, t_leaves)):
        t = torch.from_numpy(a)
        if b.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        if t.shape != b.shape or t.dtype != b.dtype:
            raise ValueError(f"leaf {i}: {tuple(t.shape)} {t.dtype} != "
                             f"expected {tuple(b.shape)} {b.dtype}: "
                             "config mismatch")
        leaves.append(t.to(dev))
    return unflatten(template, leaves), cycle_idx, seeds, scen
