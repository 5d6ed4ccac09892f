"""Traffic generation: the seeded DYNUS worlds a cell flies and the
straight-line reference trajectory, from `--seed` and the traffic file.

The world generator is a frozen copy of the DYNUS benchmark's
(dynus_obstacles_node.cpp:73-152): std::mt19937 seeded per world,
libstdc++'s uniform_real_distribution<double>, draw order x, y, z for
every obstacle and sx, sy, sz, offset, slower for the dynamic ones. Here
it runs vectorized over many worlds at once (one Mersenne Twister state
per row); `tests/test_mpcbench_generator.py` holds it to the program's
own generator world for world.
"""

from __future__ import annotations

import numpy as np

_N, _M = 624, 397
_U32 = np.uint64(0xFFFFFFFF)


def _twist(mt: np.ndarray) -> None:
    """One Mersenne Twister regeneration of every row of mt (R, 624),
    uint64 holding 32-bit words, in place."""
    up, lo = np.uint64(0x80000000), np.uint64(0x7FFFFFFF)
    a = np.uint64(0x9908B0DF)
    one = np.uint64(1)
    for s, e in ((0, _N - _M), (_N - _M, 2 * (_N - _M)), (2 * (_N - _M), _N - 1),
                 (_N - 1, _N)):
        i = np.arange(s, e)
        y = (mt[:, i] & up) | (mt[:, (i + 1) % _N] & lo)
        mt[:, i] = mt[:, (i + _M) % _N] ^ (y >> one) ^ np.where(
            (y & one) == one, a, np.uint64(0))


def mt19937_words(seeds, count: int) -> np.ndarray:
    """The first `count` outputs of std::mt19937(seed) for each seed:
    (R, count) uint64."""
    seeds = np.asarray(seeds, dtype=np.uint64) & _U32
    R = seeds.shape[0]
    mt = np.empty((R, _N), dtype=np.uint64)
    mt[:, 0] = seeds
    for i in range(1, _N):
        p = mt[:, i - 1]
        mt[:, i] = (np.uint64(1812433253) * (p ^ (p >> np.uint64(30)))
                    + np.uint64(i)) & _U32
    out = []
    while sum(o.shape[1] for o in out) < count:
        _twist(mt)
        y = mt.copy()
        y ^= y >> np.uint64(11)
        y ^= (y << np.uint64(7)) & np.uint64(0x9D2C5680)
        y ^= (y << np.uint64(15)) & np.uint64(0xEFC60000)
        y ^= y >> np.uint64(18)
        out.append(y & _U32)
    return np.concatenate(out, axis=1)[:, :count]


def worlds(seeds, w: dict) -> dict:
    """DYNUS worlds for the given 32-bit seeds under the configuration's
    world section: (R, N, ...) numpy arrays in float32 (is_static bool)."""
    n = w["num_obstacles"]
    nd = int(n * w["dynamic_ratio"])
    ns = n - nd
    words = mt19937_words(seeds, 2 * (8 * nd + 3 * ns))
    u = (words[:, 0::2].astype(np.float64)
         + words[:, 1::2].astype(np.float64) * 4294967296.0) / 18446744073709551616.0
    u = np.where(u >= 1.0, np.nextafter(1.0, 0.0), u)
    R = u.shape[0]

    def rng(v, lohi):
        return v * (lohi[1] - lohi[0]) + lohi[0]

    dyn = u[:, :8 * nd].reshape(R, nd, 8)
    sta = u[:, 8 * nd:].reshape(R, ns, 3)
    origin = np.zeros((R, n, 3))
    scale = np.zeros((R, n, 3))
    offset = np.zeros((R, n))
    slower = np.zeros((R, n))
    bbox = np.zeros((R, n, 3))
    for j, key in enumerate(("x_range", "y_range", "z_range")):
        origin[:, :nd, j] = rng(dyn[..., j], w[key])
        origin[:, nd:, j] = rng(sta[..., j], w[key])
    for j in range(3):
        scale[:, :nd, j] = rng(dyn[..., 3 + j], w["scale_range"])
    offset[:, :nd] = rng(dyn[..., 6], w["offset_range"])
    slower[:, :nd] = rng(dyn[..., 7], w["slower_range"])
    bbox[:, :nd] = w["bbox_dynamic"]
    vert = np.arange(ns) < ns * w["percentage_vert"]
    bbox[:, nd:] = np.where(vert[:, None], w["bbox_static_vert"],
                            w["bbox_static_horiz"])
    origin[:, nd:, 2] = np.where(vert, w["bbox_static_vert"][2] / 2.0,
                                 origin[:, nd:, 2])
    is_static = np.zeros((R, n), dtype=bool)
    is_static[:, nd:] = True
    f = np.float32
    return dict(origin=origin.astype(f), scale=scale.astype(f),
                offset=offset.astype(f), slower=slower.astype(f),
                bbox=bbox.astype(f), is_static=is_static)


def world_seeds(seed: int, blocks: int, per_block: int) -> np.ndarray:
    """(blocks, per_block) 32-bit world seeds drawn from the run's seed."""
    ss = np.random.SeedSequence(int(seed))
    return ss.generate_state(blocks * per_block, dtype=np.uint32).reshape(
        blocks, per_block)


def straight_line(start, goal, spacing: float) -> np.ndarray:
    """ref_trajectory_dynus_benchmark.txt: waypoints every `spacing`
    metres from start to goal, float32 (L, 3)."""
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    n = max(2, int(np.ceil(float(np.linalg.norm(goal - start)) / spacing - 1e-9)) + 1)
    a = np.linspace(0.0, 1.0, n)[:, None]
    return (start[None] * (1 - a) + goal[None] * a).astype(np.float32)


def make(cfg: dict, traffic: dict, seed: int):
    """(list of world blocks as numpy dicts, reference trajectory)."""
    seeds = world_seeds(seed, traffic["blocks"], traffic["scenarios"])
    return ([worlds(s, cfg["world"]) for s in seeds],
            straight_line(cfg["start"], cfg["goal"], traffic["ref_spacing_m"]))
