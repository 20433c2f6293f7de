"""Shading helpers of the GI render mode (port of the render_mode 0 and 3
parts of svo_raytracer_tpu/ops/shade.py).  Constants keep the reference's
float32 values as written (e.g. ``2.0 * 3.14159265359``)."""

from __future__ import annotations

import numpy as np
import torch

#: shading palette keyed by voxel value (svotrace.comp:514-522):
#: 1 = stone, 2 = scree, 3 = grass
_PALETTE = {
    1: (0.84, 0.86, 0.78),
    2: (0.57, 0.50, 0.31),
    3: (0.37, 0.43, 0.27),
}

SKY_COLOR = (0.6725, 0.8784, 1.0)       # svotrace.comp:449
SKY_GRADIENT = (0.4, 0.4, 0.25)         # :450
# (1,1,1)/sqrt(3) in float32 arithmetic, as the JAX package computes it
SUN_DIR_GI = tuple(float(v) for v in
                   np.ones(3, np.float32) / np.sqrt(np.float32(3.0)))  # :546


def _vec(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def material_color(value, voxel_pos):
    """Albedo by voxel value; default = hitpoint-1 (svotrace.comp:511-522)."""
    col = voxel_pos - 1.0
    for v, rgb in _PALETTE.items():
        col = torch.where((value == v)[:, None], _vec(rgb, col), col)
    return col


def sky(dirs):
    """Primary-miss sky gradient (svotrace.comp:449-450, :629-631)."""
    return _vec(SKY_COLOR, dirs)[None, :] \
        - dirs[:, 1:2] * _vec(SKY_GRADIENT, dirs)[None, :]


def _normalize(v):
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def cosine_bounce(normal, r):
    """The reference's hemisphere sample (svotrace.comp:494-506):
    newdir = normalize(u cos(2πr) + v sin(2πr) + w (1-r))."""
    w = normal
    use_y = w[:, 0].abs() > 0.1
    axis = torch.where(use_y[:, None], _vec((0.0, 1.0, 0.0), w),
                       _vec((1.0, 0.0, 0.0), w))
    u = _normalize(_cross(axis, w))
    v = _cross(w, u)
    a = (2.0 * 3.14159265359) * r
    d = (u * torch.cos(a)[:, None] + v * torch.sin(a)[:, None]
         + w * (1.0 - r)[:, None])
    return _normalize(d)


def mirror_bounce(d, normal):
    """Perfect mirror reflection (svotrace.comp:500-504): d - 2 dot(d,n) n."""
    ndot = (d * normal).sum(dim=-1, keepdim=True)
    return d - 2.0 * ndot * normal


def pixel_dirs_device(cam5, width, height):
    """Unnormalized per-pixel ray directions, row-major (H*W, 3):
    dir = mix(mix(l1,l2,p.y), mix(r1,r2,p.y), p.x), p = (px+0.5)/size
    (svotrace.comp:662-664).  Row 0 = p.y~0 (the GL bottom row)."""
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    pxs = (torch.arange(width, dtype=torch.float32, device=cam5.device)
           + 0.5) / float(width)
    pys = (torch.arange(height, dtype=torch.float32, device=cam5.device)
           + 0.5) / float(height)
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = left[:, None, :] + (right - left)[:, None, :] * pxs[None, :, None]
    return dirs.reshape(-1, 3)
