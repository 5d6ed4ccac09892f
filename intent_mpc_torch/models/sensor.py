"""Depth-camera sensor model: render the obstacle world into depth images
(port of intent_mpc_tpu/models/sensor.py), batched over a leading
scenario axis S.

The reference's perception stack consumes real depth frames (the Gazebo
camera plugins); this module closes the sensing loop: it renders the
obstacle boxes (and optionally a static voxel grid) into a pinhole depth
image so the real perception pipeline (models/perception.py,
models/real_detector.py) runs on synthesized sensor data.

One ray per pixel; every box is tested with the branch-free slab method
as a (pixels x boxes) broadcast, in chunks of boxes with a running
minimum (the minimum is exact and independent of order, so the chunking
changes no bit). Depth follows the camera-optical z-depth convention
that project_depth inverts: pixel ray direction ((u-cx)/fx, (v-cy)/fy, 1)
in the optical frame (x right, y down, z forward), stored value =
z * depth_scale, 0 where nothing is hit.
"""

from __future__ import annotations

import torch

from intent_mpc_torch.models.occupancy import OccupancyGrid, is_occupied
from intent_mpc_torch.models.perception import CameraIntrinsics
from intent_mpc_torch.utils.rounding import matmul3

# boxes per slab chunk of render_depth: at the DYNUS size (S = 32, 6144
# pixels) each (S, pixels, chunk, 3) intermediate stays near 0.1 GB
BOX_CHUNK = 50


def yaw_camera_rotation(yaw: torch.Tensor) -> torch.Tensor:
    """Camera-optical-frame -> world rotation (..., 3, 3) for a level
    camera facing along world yaw (...): optical z (forward) -> (cos yaw,
    sin yaw, 0), optical x (image right) -> (sin yaw, -cos yaw, 0),
    optical y (image down) -> world -z. cos and sin are taken in float64
    and rounded once, so the card and the CPU aim the camera alike (a
    pixel on a box edge hits or misses on the last bit of the ray)."""
    y64 = yaw.double()
    c, s = torch.cos(y64).float(), torch.sin(y64).float()
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    x_w = torch.stack([s, -c, zero], dim=-1)
    y_w = torch.stack([zero, zero, -one], dim=-1)
    z_w = torch.stack([c, s, zero], dim=-1)
    return torch.stack([x_w, y_w, z_w], dim=-1)


def _ray_dirs(intr: CameraIntrinsics, im_h: int, im_w: int,
              cam_rot: torch.Tensor) -> torch.Tensor:
    """World ray directions (S, im_h * im_w, 3), row-major pixels."""
    dev = cam_rot.device
    vv, uu = torch.meshgrid(torch.arange(im_h, device=dev),
                            torch.arange(im_w, device=dev), indexing="ij")
    dirs_cam = torch.stack([(uu - intr.cx) / intr.fx,
                            (vv - intr.cy) / intr.fy,
                            torch.ones_like(uu, dtype=torch.float32)], dim=-1)
    return matmul3(dirs_cam.reshape(-1, 3), cam_rot.transpose(-1, -2))


def render_depth(intr: CameraIntrinsics, im_h: int, im_w: int,
                 cam_pos: torch.Tensor, cam_rot: torch.Tensor,
                 centers: torch.Tensor, sizes: torch.Tensor,
                 active: torch.Tensor,
                 max_depth: float = 20.0) -> torch.Tensor:
    """Render AABBs into (S, im_h, im_w) raw depth images.

    cam_pos (S, 3); cam_rot (S, 3, 3) optical->world; centers/sizes
    (S, O, 3) world AABBs, active (S, O). Returns raw depth
    (z * depth_scale), 0 = no return."""
    dirs = _ray_dirs(intr, im_h, im_w, cam_rot)                   # (S,P,3)
    tiny = torch.where(dirs >= 0, torch.full_like(dirs, 1e-9),
                       torch.full_like(dirs, -1e-9))
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-9, tiny, dirs)
    inv = inv[:, :, None, :]                                      # (S,P,1,3)
    o = cam_pos[:, None, None, :]                                 # (S,1,1,3)
    z = None
    for b0 in range(0, centers.shape[1], BOX_CHUNK):
        c = centers[:, None, b0:b0 + BOX_CHUNK]                   # (S,1,B,3)
        h = sizes[:, None, b0:b0 + BOX_CHUNK] / 2.0
        t1 = (c - h - o) * inv
        t2 = (c + h - o) * inv
        t_enter = torch.amax(torch.minimum(t1, t2), dim=-1)       # (S,P,B)
        t_exit = torch.amin(torch.maximum(t1, t2), dim=-1)
        # a camera inside a box sees its interior at t=0+: no return
        hit = (t_enter <= t_exit) & (t_exit > 0.0) \
            & active[:, None, b0:b0 + BOX_CHUNK] & (t_enter > 1e-6)
        t = torch.where(hit, t_enter, torch.full_like(t_enter, float("inf")))
        zc = torch.amin(t, dim=-1)                                # (S,P)
        z = zc if z is None else torch.minimum(z, zc)
    z = torch.where(torch.isfinite(z) & (z <= max_depth), z,
                    torch.zeros_like(z))
    return (z * intr.depth_scale).reshape(-1, im_h, im_w)


def render_depth_grid(intr: CameraIntrinsics, im_h: int, im_w: int,
                      cam_pos: torch.Tensor, cam_rot: torch.Tensor,
                      occ: OccupancyGrid, max_depth: float = 10.0,
                      samples: int = 128) -> torch.Tensor:
    """Render a static occupancy grid by per-pixel ray marching (the first
    occupied sample) into (S, im_h, im_w) raw depth; a per-scenario grid
    is read per scenario. Cost: pixels x samples gathers."""
    dirs = _ray_dirs(intr, im_h, im_w, cam_rot)                   # (S,P,3)
    ts = (torch.arange(samples, device=dirs.device) + 0.5) / samples \
        * max_depth                                               # (T,)
    pts = cam_pos[:, None, None, :] + dirs[:, :, None, :] * ts[:, None]
    occ_hit = is_occupied(occ, pts)                               # (S,P,T)
    any_hit = torch.any(occ_hit, dim=-1)
    first = torch.argmax(occ_hit.to(torch.int32), dim=-1)
    z = torch.where(any_hit, ts[first], torch.zeros_like(ts[first]))
    return (z * intr.depth_scale).reshape(-1, im_h, im_w)
