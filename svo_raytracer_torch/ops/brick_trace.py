"""Hit-record decode and the direction clamp shared by the brick engines
(port of the torch-relevant parts of svo_raytracer_tpu/ops/brick_trace.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .hit import HitResult

# 1e-4, in lock-step with wavefront._DIR_EPS: smaller clamps let
# near-axis rays livelock below the f32 ulp of a 1024-scale coordinate
DIR_EPS = float(np.float32(1e-4))


def _clamp_dir(d):
    """Components with |d| < 1e-4 become +-1e-4; -0.0 takes +1e-4."""
    eps = torch.full_like(d, DIR_EPS)
    return torch.where(d.abs() < DIR_EPS, torch.where(d >= 0, eps, -eps), d)


def decode_hits(ws, origins, dirs, hit, attr, vx, vy, vz, t_vox, iters,
                node=None):
    """Assemble a HitResult from brick-path hit records.

    attr: packed value|raw_normal<<8|depth<<24; (vx,vy,vz): global voxel
    coords of the hit voxel; t_vox: hit distance in voxel units along
    ``dirs``.  Raw normal 555 decodes to the zero vector and normalizes to
    NaN — the reference shader's behaviour, kept on purpose.
    """
    value = attr & 0xFF
    raw = (attr >> 8) & 0xFFFF
    depth = (attr >> 24) & 0x1F
    nx = ((raw % 10) - 5).float()
    ny = (((raw % 100) - (raw % 10)) // 10 - 5).float()
    nz = ((raw - (raw % 100)) // 100 - 5).float()
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    has_n = raw != 0
    zero = torch.zeros_like(nx)
    nx = torch.where(has_n, nx / nlen, zero)
    ny = torch.where(has_n, ny / nlen, zero)
    nz = torch.where(has_n, nz / nlen, zero)
    normal = torch.stack([nx, ny, nz], dim=-1)

    t = t_vox / float(ws)
    scale_exp2 = torch.exp2(-depth.float())
    span = torch.full_like(depth, ws) >> depth.clamp(0, 30)
    span = span.clamp_min(1)
    cx = torch.div(vx, span, rounding_mode="floor") * span
    cy = torch.div(vy, span, rounding_mode="floor") * span
    cz = torch.div(vz, span, rounding_mode="floor") * span
    corner = torch.stack([cx, cy, cz], dim=-1).float() / float(ws) + 1.0
    voxel_pos = corner + normal * (scale_exp2 * 2 * 1.74)[:, None]
    o = origins.float()
    d = dirs.float()
    hit_pos = o + t[:, None] * d + normal * (scale_exp2 * 2)[:, None]

    value = torch.where(hit, value, torch.zeros_like(value))
    return HitResult(
        hit=hit, value=value, t=t, iters=iters, scale_exp2=scale_exp2,
        depth=torch.where(hit, depth, torch.zeros_like(depth)),
        normal=normal, hit_pos=hit_pos, voxel_pos=voxel_pos,
        node=(torch.full_like(vx, -1) if node is None else node),
    )
