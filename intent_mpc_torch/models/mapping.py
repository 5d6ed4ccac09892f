"""Occupancy mapping: log-odds voxel map, inflation, raycast, ESDF (port of
intent_mpc_tpu/models/mapping.py), batched over a leading scenario axis S.

Rebuild of map_manager (map_manager/include/map_manager/):

  * occupancyMap.cpp: log-odds grid fed by sensor point clouds. The
    reference walks each ray with Amanatides-Woo traversal and a per-frame
    hit/miss cache so every voxel updates at most once per frame
    (raycastUpdate :810-977). Here rays are sampled at sub-voxel fixed
    steps and deduplicated with a scatter-max of visit codes (one flat
    uint8 code per voxel, 1 missed and 2 hit, with a sentinel slot per
    scenario for masked samples): the same
    once-per-frame semantics, vectorised over scenarios x rays x steps.
  * inflateLocalMap (:1030+): robot-size box inflation == a max-pool of
    the occupancy grid with odd windows and SAME padding.
  * raycast.cpp (Amanatides-Woo): castRay == first-hit search along fixed
    samples.
  * ESDFMap.cpp (:69-120): 3-pass separable distance transform, each pass
    an exact broadcasted min-plus squared-distance transform, positive and
    negative fields.

The voxel of a ray sample is the floor of a product-plus-sum; it is
computed with the rounding of the JAX package's compiled CPU program at
the batch sizes a frame gives it (utils/rounding.py), so both packages,
and the card and the CPU, pick the same voxels. Divisions take the resolution as a tensor on the device: a
Python float divisor becomes a multiplication by its reciprocal on the
card.

A map's resolution is a Python float (the inflation window is shaped on
the host, with no device read); its origin is a (3,) tensor.

Config values mirror mapping_param.yaml (p_hit .70, p_miss .35, p_min .12,
p_max .97, p_occ .80, raycast_max_length 5.0).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from intent_mpc_torch.models.occupancy import OccupancyGrid, is_occupied
from intent_mpc_torch.utils.device import constant, f32, resolve_device
from intent_mpc_torch.utils.rounding import fma, norm3, recip32

# elements of the (rows, chunk, n) cost tensor of one min-plus chunk of the
# ESDF (1 GB of float32): the chunk along the axis is sized from it
ESDF_CHUNK_ELEMS = 1 << 28


class MappingConfig(NamedTuple):
    resolution: float = 0.15
    p_hit: float = 0.70
    p_miss: float = 0.35
    p_min: float = 0.12
    p_max: float = 0.97
    p_occ: float = 0.80
    raycast_max_len: float = 5.0
    robot_size: Tuple[float, float, float] = (0.5, 0.5, 0.3)

    @property
    def l_hit(self) -> float:
        return math.log(self.p_hit / (1 - self.p_hit))

    @property
    def l_miss(self) -> float:
        return math.log(self.p_miss / (1 - self.p_miss))

    @property
    def l_min(self) -> float:
        return math.log(self.p_min / (1 - self.p_min))

    @property
    def l_max(self) -> float:
        return math.log(self.p_max / (1 - self.p_max))

    @property
    def l_occ(self) -> float:
        return math.log(self.p_occ / (1 - self.p_occ))


class LogOddsMap(NamedTuple):
    log_odds: torch.Tensor   # (S, nx, ny, nz) float32
    origin: torch.Tensor     # (3,) float32 world position of voxel (0,0,0) corner
    resolution: float        # voxel edge, meters


def init_map(origin, size_m, cfg: MappingConfig, batch: int = 1,
             device=None) -> LogOddsMap:
    """S = batch empty maps (log-odds 0, the unobserved prior) of one
    origin and extent, on the card unless `device` names another."""
    dev = resolve_device(device)
    dims = tuple(int(math.ceil(s / cfg.resolution)) for s in size_m)
    return LogOddsMap(
        log_odds=torch.zeros((batch,) + dims, dtype=torch.float32,
                             device=dev),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
        resolution=float(np.float32(cfg.resolution)))


def _voxel(m: LogOddsMap, p: torch.Tensor) -> torch.Tensor:
    """int64 voxel indices of points p (..., 3): floor((p - origin) / res)."""
    res = f32(m.resolution, p.device)
    return torch.floor((p - m.origin) / res).to(torch.int64)


def _flat_idx(dims, idx: torch.Tensor) -> torch.Tensor:
    return (idx[..., 0] * dims[1] + idx[..., 1]) * dims[2] + idx[..., 2]


def _inside(dims, idx: torch.Tensor) -> torch.Tensor:
    hi = constant(tuple(dims), idx.device, torch.int64)
    return torch.all((idx >= 0) & (idx < hi), dim=-1)


def integrate_cloud(cfg: MappingConfig, m: LogOddsMap,
                    sensor_origin: torch.Tensor, points: torch.Tensor,
                    point_valid: torch.Tensor, samples_per_ray: int = 64
                    ) -> LogOddsMap:
    """One sensor frame per scenario: free-space misses along each ray, a
    hit at each endpoint.

    sensor_origin (S, 3); points (S, P, 3) world frame; point_valid (S, P).
    Points beyond raycast_max_len are clamped and treated as miss-only
    (occupancyMap.cpp raycastUpdate range handling). Each voxel updates at
    most once per frame, a hit before a miss."""
    S, P, _ = points.shape
    dims = m.log_odds.shape[1:]
    nflat = dims[0] * dims[1] * dims[2]
    dev = points.device
    o = sensor_origin[:, None, :]                                # (S,1,3)

    vec = points - o
    dist = norm3(vec)                                            # (S,P)
    in_range = dist <= cfg.raycast_max_len
    clamp = torch.clamp(dist, max=cfg.raycast_max_len)
    direction = vec / torch.clamp(dist, min=1e-9)[..., None]
    # the compiled CPU program rounds the ray end twice (product, then
    # sum) and each sample on it once (a fused multiply-add)
    end = o + direction * clamp[..., None]                       # (S,P,3)

    # sub-voxel sampling along each ray (the endpoint voxel excluded below)
    fr = (torch.arange(samples_per_ray, dtype=torch.float32, device=dev)
          + 0.5) / samples_per_ray
    pts = fma((end - o)[:, :, None, :], fr[:, None],
              sensor_origin[:, None, None, :])                   # (S,P,K,3)
    idx = _voxel(m, pts)
    inside = _inside(dims, idx)

    hit_idx = _voxel(m, end)                                     # (S,P,3)
    hit_valid = point_valid & in_range & _inside(dims, hit_idx)
    base = (torch.arange(S, device=dev) * (nflat + 1))[:, None]
    sentinel = base + nflat
    hit_flat = torch.where(hit_valid, base + _flat_idx(dims, hit_idx),
                           sentinel)                             # (S,P)

    is_hit_voxel = torch.all(idx == hit_idx[:, :, None, :], dim=-1)
    miss_valid = point_valid[..., None] & inside \
        & ~(is_hit_voxel & in_range[..., None])
    miss_flat = torch.where(miss_valid, base[..., None] + _flat_idx(dims, idx),
                            sentinel[..., None])                 # (S,P,K)

    # one visit code per voxel: 1 missed, 2 hit; the max keeps a voxel hit
    # by any ray a hit, not a miss (reference hit priority)
    code = torch.zeros(S * (nflat + 1), dtype=torch.uint8, device=dev)
    for flat, c in ((miss_flat, 1), (hit_flat, 2)):
        code.scatter_reduce_(0, flat.reshape(-1), torch.full(
            (flat.numel(),), c, dtype=torch.uint8, device=dev), "amax")
    code = code.reshape(S, nflat + 1)[:, :nflat].reshape(m.log_odds.shape)
    zero = f32(0.0, dev)
    delta = torch.where(code == 2, f32(cfg.l_hit, dev),
                        torch.where(code == 1, f32(cfg.l_miss, dev), zero))
    lo = torch.clamp(m.log_odds + delta, f32(cfg.l_min, dev),
                     f32(cfg.l_max, dev))
    return m._replace(log_odds=lo)


def occupancy(cfg: MappingConfig, m: LogOddsMap) -> torch.Tensor:
    """Binary occupancy (S, nx, ny, nz) int8: log-odds >= l_occ
    (isOccupied semantics)."""
    return (m.log_odds >= f32(cfg.l_occ, m.log_odds.device)).to(torch.int8)


def inflate_window(cfg: MappingConfig, resolution: float) -> Tuple[int, ...]:
    """The odd max-pool window of the robot-size box inflation."""
    return tuple(2 * int(math.ceil(s / 2.0 / resolution)) + 1
                 for s in cfg.robot_size)


def inflate(cfg: MappingConfig, occ: torch.Tensor,
            resolution: float) -> torch.Tensor:
    """Robot-size box inflation (inflateLocalMap) of occ (S, nx, ny, nz):
    a max-pool with odd windows and SAME padding."""
    ks = inflate_window(cfg, resolution)
    x = occ.to(torch.float32)[:, None]
    return F.max_pool3d(x, ks, stride=1, padding=tuple(k // 2 for k in ks)
                        )[:, 0].to(occ.dtype)


def to_occupancy_grid(cfg: MappingConfig, m: LogOddsMap,
                      inflated: bool = True) -> OccupancyGrid:
    """The per-scenario OccupancyGrid (S, nx, ny, nz) of the map, inflated
    by the robot size unless `inflated` is False."""
    occ = occupancy(cfg, m)
    if inflated:
        occ = inflate(cfg, occ, m.resolution)
    return OccupancyGrid(grid=occ, origin=m.origin,
                         resolution=f32(m.resolution, occ.device))


def first_hit(blocked, start: torch.Tensor, end: torch.Tensor,
              samples: int):
    """The first of `samples` evenly spaced points from start to end
    (S, 3), both included, where blocked(points (S, K, 3)) is true.
    Returns (hit (S,) bool, hit_point (S, 3); end where none)."""
    fr = linspace01(samples, start.device)
    pts = fma((end - start)[:, None, :], fr[:, None], start[:, None, :])
    occ = blocked(pts)                                           # (S, K)
    any_hit = torch.any(occ, dim=-1)
    first = torch.argmax(occ.to(torch.int32), dim=-1)
    p = pts[torch.arange(pts.shape[0], device=pts.device), first]
    return any_hit, torch.where(any_hit[:, None], p, end)


def cast_ray(grid: OccupancyGrid, start: torch.Tensor, end: torch.Tensor,
             samples: int = 256):
    """castRay (occupancyMap + raycast.cpp) for S rays: the first occupied
    sample between start and end (first_hit)."""
    return first_hit(lambda p: is_occupied(grid, p), start, end, samples)


def linspace01(n: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, n) bit for bit: i * (1 / (n - 1)) in float32."""
    return torch.arange(n, dtype=torch.float32, device=device) \
        * f32(recip32(max(n - 1, 1)), device)


def free_regions(occ: torch.Tensor, origin: torch.Tensor, resolution: float,
                 lowers: torch.Tensor, uppers: torch.Tensor) -> torch.Tensor:
    """Clear axis-aligned boxes in occupancy grids (dynamicMap::freeRegions,
    map_manager/dynamicMap.cpp:23-66): voxels whose center lies in a box
    around a detected dynamic obstacle are forced free, so moving obstacles
    do not smear into the static map. occ (S, nx, ny, nz); lowers/uppers
    (S, R, 3) world-space box corners (a box with lower > upper clears
    nothing). A center is inside a box when it is inside along each axis,
    so the test is three per-axis masks."""
    S = occ.shape[0]
    dev = occ.device
    res = f32(resolution, dev)
    masks = []
    for a in range(3):
        i = torch.arange(occ.shape[1 + a], dtype=torch.float32, device=dev)
        c = fma(i + 0.5, res, origin[a])                         # (n_a,)
        masks.append((c[None, None, :] >= lowers[..., a, None])
                     & (c[None, None, :] <= uppers[..., a, None]))  # (S,R,n)
    mx, my, mz = masks
    inside = torch.zeros(occ.shape, dtype=torch.bool, device=dev)
    for r in range(lowers.shape[1]):
        inside |= mx[:, r, :, None, None] & my[:, r, None, :, None] \
            & mz[:, r, None, None, :]
    return torch.where(inside, torch.zeros_like(occ), occ)


def save_map(path: str, m: LogOddsMap, scenario: int = 0) -> None:
    """Persist one scenario's map in the JAX package's .npz layout
    (log_odds (nx, ny, nz), origin (3,), resolution ()): the
    save_map_node / prebuilt_map_directory equivalent."""
    np.savez_compressed(
        path, log_odds=m.log_odds[scenario].detach().cpu().numpy(),
        origin=m.origin.detach().cpu().numpy(),
        resolution=np.asarray(m.resolution, np.float32))


def load_map(path: str, device=None) -> LogOddsMap:
    """A map saved by either package, as one scenario (S = 1)."""
    dev = resolve_device(device)
    d = np.load(path)
    lo = np.asarray(d["log_odds"], np.float32)
    return LogOddsMap(log_odds=torch.as_tensor(lo, device=dev)[None],
                      origin=torch.as_tensor(np.asarray(d["origin"],
                                                        np.float32),
                                             device=dev),
                      resolution=float(np.float32(d["resolution"])))


def _sq_dist_transform_1d(f: torch.Tensor) -> torch.Tensor:
    """Exact 1-D squared distance transform along the last axis:
    out[i] = min_j f[j] + (i - j)^2 (voxel units); a broadcasted min-plus in
    chunks of i sized so each chunk's cost tensor holds ESDF_CHUNK_ELEMS."""
    n = f.shape[-1]
    rows = f.numel() // n
    chunk = max(1, min(n, ESDF_CHUNK_ELEMS // max(rows * n, 1)))
    j = torch.arange(n, device=f.device)
    outs = []
    for c0 in range(0, n, chunk):
        i = torch.arange(c0, min(c0 + chunk, n), device=f.device)
        d2 = ((i[:, None] - j[None, :]) ** 2).to(torch.float32)
        outs.append(torch.amin(f[..., None, :] + d2, dim=-1))
    return torch.cat(outs, dim=-1)


def esdf(occ: torch.Tensor, resolution: float) -> torch.Tensor:
    """Signed Euclidean distance fields (S, nx, ny, nz) in meters: positive
    outside obstacles, negative inside (ESDFMap::updateESDF3D pos and neg
    passes)."""
    dev = occ.device
    big = f32(1e9, dev)
    res = f32(resolution, dev)

    def edt(grid_bool):
        f = torch.where(grid_bool, f32(0.0, dev), big)
        for ax in range(1, 4):
            f = torch.movedim(f, ax, -1).contiguous()
            f = _sq_dist_transform_1d(f)
            f = torch.movedim(f, -1, ax)
        return torch.sqrt(f) * res

    occ_b = occ > 0
    pos = edt(occ_b)
    neg = edt(~occ_b)
    return torch.where(occ_b, -neg, pos)


def load_pcd(path: str) -> np.ndarray:
    """Load an x/y/z point cloud from a .pcd file (the reference's
    prebuilt-map format, occupancyMap.cpp initPrebuiltMap :399-475 via
    pcl::io::loadPCDFile). Supports ASCII and binary little-endian PCD
    v0.7 with float32 x/y/z fields. Returns (P, 3) float32 numpy."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = [int(s) for s in header.get(
            "SIZE", " ".join(["4"] * len(fields))).split()]
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        mode = header["DATA"].split()[0]
        stride = sum(s * c for s, c in zip(sizes, counts))
        offs = {}
        off = 0
        for name, s, c in zip(fields, sizes, counts):
            offs[name] = off
            off += s * c
        if not all(k in offs for k in ("x", "y", "z")):
            raise ValueError(f"pcd missing x/y/z fields: {fields}")
        if mode == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            ix = [fields.index(k) for k in ("x", "y", "z")]
            return np.ascontiguousarray(rows[:, ix], np.float32)
        if mode == "binary":
            raw = np.frombuffer(f.read(n * stride), np.uint8,
                                count=n * stride).reshape(n, stride)
            out = np.zeros((n, 3), np.float32)
            for j, k in enumerate(("x", "y", "z")):
                out[:, j] = raw[:, offs[k]:offs[k] + 4].copy().view("<f4")[:, 0]
            return out
        raise ValueError(f"unsupported pcd DATA mode: {mode}")


def save_pcd(path: str, points) -> None:
    """Write an ASCII x/y/z .pcd (round-trip partner of load_pcd)."""
    pts = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                "COUNT 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\n"
                "VIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def prebuilt_map_from_points(cfg: MappingConfig, m: LogOddsMap,
                             points) -> LogOddsMap:
    """initPrebuiltMap semantics: each cloud point's voxel is set to the
    max log-odds (occupancyMap.cpp:428); robot-size inflation then comes
    from `inflate` / `to_occupancy_grid`. points: (P, 3), the same cloud
    for every scenario, or (S, P, 3); points outside the map are
    dropped."""
    lo = m.log_odds
    S = lo.shape[0]
    dims = lo.shape[1:]
    nflat = dims[0] * dims[1] * dims[2]
    dev = lo.device
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    if pts.dim() == 2:
        pts = pts[None].expand(S, -1, 3)
    idx = _voxel(m, pts)
    inside = _inside(dims, idx)
    hi = constant(tuple(d - 1 for d in dims), dev, torch.int64)
    idx = torch.minimum(torch.clamp(idx, min=0), hi)
    base = (torch.arange(S, device=dev) * nflat)[:, None]
    flat = (base + _flat_idx(dims, idx)).reshape(-1)
    # outside: -inf, a no-op under the max
    val = torch.where(inside, f32(cfg.l_max, dev),
                      f32(float("-inf"), dev)).reshape(-1)
    out = lo.reshape(-1).scatter_reduce(0, flat, val, "amax")
    return m._replace(log_odds=out.reshape(lo.shape))
