"""No static map: the DYNUS benchmark's flights, in which every obstacle
is a box of the world and none a voxel of a map. One grid of a single
free voxel far from the worlds (the program's empty map), and no grid
for the real detector's static-map veto."""

from __future__ import annotations

import torch


def build(cfg: dict, block: dict, device):
    """(occ, veto_occ) of one block of worlds (`block`: the generator's
    numpy arrays), each None or a dict of the grid (int8, 1 occupied),
    the world position of voxel (0, 0, 0)'s corner and the voxel size."""
    occ = dict(grid=torch.zeros((1, 1, 1), dtype=torch.int8, device=device),
               origin=torch.full((3,), 1e9, dtype=torch.float32, device=device),
               resolution=torch.tensor(1.0, dtype=torch.float32, device=device))
    return occ, None
