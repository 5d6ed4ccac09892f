"""Episode visualization: the array-world equivalent of the reference's
RViz publishers (SURVEY §5 observability: MPC trajectories, predictor
rollouts, obstacle boxes, history paths — mpcPlanner.cpp:1338-1621,
dynamicPredictor.cpp:569-852).

Renders a recorded episode to PNG: top-down corridor view with obstacle
positions at selected times and the flown path. matplotlib is imported
inside the function, so the package imports without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from intent_mpc_torch.models.world import Scenario, obstacle_state
from intent_mpc_torch.utils.config import IntentMPCConfig


def plot_episode(cfg: IntentMPCConfig, scenario: Scenario,
                 path: np.ndarray, out_path: str,
                 snapshot_times: Optional[list] = None,
                 title: str = "") -> None:
    """Top-down (x, y) episode plot of one scenario (unbatched leaves,
    (N, ...)). path (C, 3) per-cycle positions."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = np.asarray(path)
    scenario = Scenario(*(torch.as_tensor(a).cpu() for a in scenario))
    cycle_dt = cfg.engine.control_dt * cfg.engine.ticks_per_cycle
    if snapshot_times is None:
        t_end = path.shape[0] * cycle_dt
        snapshot_times = list(np.linspace(0, t_end, 5))

    fig, ax = plt.subplots(figsize=(14, 4.5))
    # corridor bounds
    ax.axhline(cfg.planner.y_range[0], color="k", lw=0.8, ls="--", alpha=0.5)
    ax.axhline(cfg.planner.y_range[1], color="k", lw=0.8, ls="--", alpha=0.5)

    stat = scenario.is_static.numpy()
    bbox = scenario.bbox.numpy()
    for i, t in enumerate(snapshot_times):
        pos, _ = obstacle_state(scenario, torch.tensor(float(t)))
        pos = pos.numpy()
        alpha = 0.15 + 0.65 * i / max(len(snapshot_times) - 1, 1)
        dyn = ~stat
        ax.scatter(pos[dyn, 0], pos[dyn, 1], s=14, c="tab:red",
                   alpha=alpha * 0.6, edgecolors="none",
                   label=f"dynamic t={t:.0f}s" if i == len(snapshot_times) - 1
                   else None)
    for c, b in zip(scenario.origin.numpy()[stat], bbox[stat]):
        ax.add_patch(plt.Rectangle((c[0] - b[0] / 2, c[1] - b[1] / 2),
                                   b[0], b[1], color="tab:blue", alpha=0.5))

    ax.plot(path[:, 0], path[:, 1], "g-", lw=2, label="flown path")
    ax.plot(*cfg.start[:2], "go", ms=8)
    ax.plot(*cfg.goal[:2], "r*", ms=14, label="goal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title or "Intent-MPC episode (top-down)")
    ax.legend(loc="upper left", fontsize=8)
    ax.set_xlim(-3, max(cfg.goal[0] + 5, path[:, 0].max() + 5))
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
