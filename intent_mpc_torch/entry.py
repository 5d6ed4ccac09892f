"""The port's entry point: one closed-loop cycle at a tiny size (the
counterpart of the JAX package's `__graft_entry__.entry()`).

    from intent_mpc_torch.entry import entry
    fn, args = entry()              # on the GPU; entry("cpu") on the CPU
    pos, vel = fn(*args)

The multi-device dry run (`dryrun_multichip`) waits for the port's
`torch.distributed` fleet.
"""

from __future__ import annotations

from intent_mpc_torch.engine import closed_loop as cl
from intent_mpc_torch.models.occupancy import empty_grid
from intent_mpc_torch.models.world import straight_line_ref_traj
from intent_mpc_torch.parallel import sharding as sh
from intent_mpc_torch.utils.config import small_config
from intent_mpc_torch.utils.device import resolve_device

SOLVER_ITERS = 10


def tiny_setup(device):
    """The JAX entry's setup as one scenario (S = 1): 4 obstacles, horizon
    8, a 0.5 s timeout, goal (6, 0, 2) on a 0.5 m reference."""
    cfg = small_config(num_obstacles=4, horizon=8, timeout=0.5,
                       max_obstacles=4, hist=8).replace(goal=(6.0, 0.0, 2.0))
    scen = sh.stack_scenarios(cfg, [0], device=device)
    ref = straight_line_ref_traj(cfg.start, cfg.goal, spacing=0.5,
                                 device=device)
    return cfg, scen, ref


def entry(device=None):
    """(fn, args): fn(carry, cycle_idx) runs one full MPC replanning cycle
    (detector history, intent prediction, the 6-candidate batched ADMM
    solve at SOLVER_ITERS iterations, scoring and selection, the control
    ticks) and returns the new (pos (1, 3), vel (1, 3)); args is the fresh
    carry and cycle 0. Runs on the GPU unless `device` names another."""
    dev = resolve_device(device)
    cfg, scen, ref = tiny_setup(dev)
    occ = empty_grid(dev)
    traj_len = ref.shape[0]

    def fn(carry, cycle_idx):
        new_carry, _ = cl.episode_step(cfg, scen, ref, traj_len, occ, carry,
                                       cycle_idx, solver_iters=SOLVER_ITERS)
        return new_carry.pos, new_carry.vel

    return fn, (cl.init_carry(cfg, scen, device=dev), 0)
