"""Heightmap-driven voxel chunks (port of
svo_raytracer_tpu/models/heightmap.py, chunkgen-heightmap.comp).

The reference samples a 16-bit heightmap + material-index map per column:
solid iff ``posY <= height/65536*height_scale``; voxels within 4 of the
top take the surface material, everything below is stone
(``chunkgen-heightmap.comp:13-31``).

Called with ``height_scale = world_size // 2`` (the default of
models/bigworld.heightmap_brick_scene), the octree built from this chunk
and the brick world of the same heightmap hold the same solid voxels.
"""

from __future__ import annotations

import numpy as np
import torch


def _int32(a, dev):
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.int32)
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)


def generate_chunk_heightmap(heightmap, matmap, origin=(0, 0, 0),
                             chunk_size: int = 1024,
                             height_scale: int = 2048,
                             device=None) -> torch.Tensor:
    """(chunk_size,)*3 uint8 voxel grid [x, y, z] of the chunk at
    ``origin``, on ``device`` (default: a tensor heightmap's device, the
    card for a NumPy one; pass "cpu" to build on the CPU).

    heightmap: (H, W) uint16 sampled at world (x, z), NumPy or tensor;
    matmap: (H, W) int material ids.  Out-of-map columns are empty.
    """
    if device is None:
        device = (heightmap.device if isinstance(heightmap, torch.Tensor)
                  else "cuda")
    dev = torch.device(device)
    hm, mm = _int32(heightmap, dev), _int32(matmap, dev)
    ox, oy, oz = (int(v) for v in origin)
    ax = torch.arange(chunk_size, dtype=torch.int32, device=dev)
    wx = ax[:, None] + ox
    wz = ax[None, :] + oz
    Hm, Wm = hm.shape
    inside = (wx >= 0) & (wx < Hm) & (wz >= 0) & (wz < Wm)
    cx = wx.clamp(0, Hm - 1).long()
    cz = wz.clamp(0, Wm - 1).long()
    # int(sample / 65536.0 * height_scale) in float32, as the JAX package
    height = (hm[cx, cz].to(torch.float32) / 65536.0
              * float(height_scale)).to(torch.int32)
    height = torch.where(inside, height, torch.full_like(height, -1))
    surf = mm[cx, cz].to(torch.uint8)[:, None, :]
    wy = (ax + oy)[None, :, None]
    h = height[:, None, :]
    # uint8 throughout: a 1024^3 chunk is 1 GiB per grid
    return torch.where(wy <= h, torch.where((h - wy) <= 4, surf, 1), 0)
