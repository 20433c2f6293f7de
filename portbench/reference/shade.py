"""The reference frame: camera rays, hit decode and the shading of render
modes 0 (pathtraced GI) and 2 (direct light with a shadow ray), as the
reference shader computes them (svotrace.comp:443-646), for any set of
pixels.

Every value is float32 as the configuration states, written in the
shader's operation order; ``dt=torch.bfloat16`` computes the same in
bfloat16 (the precision control).  Hits come from ``walk.walk`` over the
reference world, their attributes from ``World.hit_attrs``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .walk import walk

#: shading palette keyed by voxel value (svotrace.comp:514-522)
PALETTE = {1: (0.84, 0.86, 0.78), 2: (0.57, 0.50, 0.31),
           3: (0.37, 0.43, 0.27)}
SKY_COLOR = (0.6725, 0.8784, 1.0)       # svotrace.comp:449
SKY_GRADIENT = (0.4, 0.4, 0.25)         # :450
SUN_DIR_GI = tuple(float(v) for v in
                   np.ones(3, np.float32) / np.sqrt(np.float32(3.0)))
SUN_DIR_DIRECT = tuple(float(v) for v in np.full(3, 0.5, np.float32)
                       / np.sqrt(np.float32(0.75)))
SQRT3 = float(np.float32(1.73205080757))
PENUMBRA_ITERS = 260    # svotrace.comp:615: penumbra past this many steps


class Hits(NamedTuple):
    hit: torch.Tensor        # bool (n,)
    value: torch.Tensor      # int (n,)
    t: torch.Tensor          # (n,) distance in world units
    scale_exp2: torch.Tensor  # (n,) edge of the hit leaf
    depth: torch.Tensor      # int (n,) leaf depth
    normal: torch.Tensor     # (n, 3)
    voxel_pos: torch.Tensor  # (n, 3) leaf corner + normal offset
    voxel: torch.Tensor      # int64 (n, 3), -1 on a miss
    leaf_edge: torch.Tensor  # int64 (n,) voxels per leaf edge (0 on a miss)


def _vec(values, like, dt):
    return torch.tensor(values, dtype=dt, device=like.device)


def sqrt32(x):
    """Correctly rounded square root: rooted in float64, rounded back."""
    return torch.sqrt(x.double()).to(x.dtype)


def unit_rows(v):
    x, y, z = v.unbind(-1)
    return v / sqrt32(x * x + y * y + z * z).unsqueeze(-1)


def trace(world, origins, dirs, active=None, dt=torch.float32, count=None):
    """Hits of (n, 3) world-space rays through the reference world."""
    fdt = torch.float64 if dt == torch.float32 else dt
    w = walk(world, origins, dirs, active, fdt=fdt, count=count)
    n = origins.shape[0]
    dev = origins.device
    hit = w.hit
    vox = torch.where(hit[:, None], w.voxel, torch.zeros_like(w.voxel))
    value, raw, depth = world.hit_attrs(vox)
    zi = torch.zeros_like(raw)
    value = torch.where(hit, value, zi)
    raw = torch.where(hit, raw, zi)
    depth = torch.where(hit, depth, zi)
    nx = ((raw % 10) - 5).to(dt)
    ny = (((raw % 100) - (raw % 10)) // 10 - 5).to(dt)
    nz = ((raw - (raw % 100)) // 100 - 5).to(dt)
    nlen = sqrt32(nx * nx + ny * ny + nz * nz)
    has_n = raw != 0
    zero = torch.zeros_like(nx)
    normal = torch.stack([torch.where(has_n, nx / nlen, zero),
                          torch.where(has_n, ny / nlen, zero),
                          torch.where(has_n, nz / nlen, zero)], -1)
    W = world.W
    t = w.t_vox.to(dt) / float(W)
    scale_exp2 = torch.exp2(-depth.to(dt))
    span = (torch.full_like(depth, W) >> depth.clamp(0, 30)).clamp_min(1)
    corner = (torch.div(vox, span[:, None], rounding_mode="floor")
              * span[:, None]).to(dt) / float(W) + 1.0
    voxel_pos = corner + normal * (scale_exp2 * 2 * 1.74)[:, None]
    return Hits(hit=hit, value=value, t=t, scale_exp2=scale_exp2,
                depth=depth, normal=normal, voxel_pos=voxel_pos,
                voxel=torch.where(hit[:, None], w.voxel,
                                  torch.full_like(w.voxel, -1)),
                leaf_edge=torch.where(hit, span, torch.zeros_like(span)))


# ----------------------------------------------------------------- camera
def pixel_rays(cam5, px, py, width, height, dt=torch.float32):
    """Origins and unit directions of pixels (px, py) (row 0 the bottom
    scanline): dir = mix(mix(l1, l2, v), mix(r1, r2, v), u) with
    u = (px + 0.5) / W, v = (py + 0.5) / H (svotrace.comp:662-664)."""
    cam = cam5.to(dt)
    pxf, pyf = px.to(dt), py.to(dt)
    u = (pxf + 0.5) / torch.full_like(pxf, float(width))
    v = (pyf + 0.5) / torch.full_like(pyf, float(height))
    l1, l2, r1, r2 = cam[1], cam[2], cam[3], cam[4]
    left = l1[None] + (l2 - l1)[None] * v[:, None]
    right = r1[None] + (r2 - r1)[None] * v[:, None]
    dirs = unit_rows(left + (right - left) * u[:, None])
    return cam[0].expand_as(dirs), dirs


def glsl_rand(x, y):
    """fract(sin(dot(co, (12.9898, 78.233))) * 43758.5453)."""
    s = torch.sin(x * 12.9898 + y * 78.233)
    v = s * 43758.5453
    return v - torch.floor(v)


def pixel_rand(px, py, frame, dt=torch.float32):
    """The per-pixel random of render mode 0 (svotrace.comp:486)."""
    px, py = px.to(dt), py.to(dt)
    fr = np.float32(frame)
    r1 = glsl_rand(px, torch.full_like(px, float(fr * np.float32(0.1))))
    r2 = glsl_rand(py, torch.full_like(py, float(fr * np.float32(0.02))))
    return glsl_rand(px + r1, py + r2)


# ---------------------------------------------------------------- shading
def sky(dirs, dt):
    return _vec(SKY_COLOR, dirs, dt)[None, :] \
        - dirs[:, 1:2] * _vec(SKY_GRADIENT, dirs, dt)[None, :]


def material_color(value, voxel_pos, dt):
    col = voxel_pos - 1.0
    for v, rgb in PALETTE.items():
        col = torch.where((value == v)[:, None], _vec(rgb, col, dt), col)
    return col


def material_color_direct(value, like, dt):
    col = torch.zeros(value.shape + (3,), dtype=dt, device=like.device)
    for v, rgb in PALETTE.items():
        col = torch.where((value == v)[:, None], _vec(rgb, col, dt), col)
    return col


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def cosine_bounce(normal, r, dt):
    """normalize(u cos(2 pi r) + v sin(2 pi r) + w (1 - r))
    (svotrace.comp:494-506)."""
    w = normal
    use_y = w[:, 0].abs() > 0.1
    axis = torch.where(use_y[:, None], _vec((0.0, 1.0, 0.0), w, dt),
                       _vec((1.0, 0.0, 0.0), w, dt))
    u = unit_rows(_cross(axis, w))
    v = _cross(w, u)
    a = (2.0 * 3.14159265359) * r
    d = (u * torch.cos(a)[:, None] + v * torch.sin(a)[:, None]
         + w * (1.0 - r)[:, None])
    return unit_rows(d)


def gi_pixels(world, cam5, px, py, width, height, frame, bounces,
              dt=torch.float32, counts=None):
    """Render mode 0 at pixels (px, py): the primary segment, then
    ``bounces`` diffuse bounces, the same per-pixel random in every
    segment (svotrace.comp:443-560).  Returns (colour, depth).
    ``counts`` (a list) gets one walk count per segment, with its rays."""
    o, d = pixel_rays(cam5, px, py, width, height, dt)
    r = pixel_rand(px, py, frame, dt)
    n = d.shape[0]
    dev = d.device
    accum = torch.zeros((n, 3), dtype=dt, device=dev)
    mask = torch.ones((n, 3), dtype=dt, device=dev)
    depth = torch.full((n,), -1.0, dtype=dt, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for seg in range(bounces + 1):
        count = None
        if counts is not None:
            count = {"rays": int(active.sum()), "camera": seg == 0}
            counts.append(count)
        res = trace(world, o, d, None if seg == 0 else active, dt, count)
        hit = active & res.hit
        miss = active & ~res.hit
        if seg == 0:
            accum = torch.where(miss[:, None], accum + sky(d, dt), accum)
        else:
            sun = _vec(SUN_DIR_GI, d, dt)
            sun_hit = torch.arccos(
                (d * sun[None, :]).sum(dim=-1).clamp(-1.0, 1.0)) < 0.4
            add = torch.where(sun_hit[:, None], mask * 7.0,
                              torch.zeros_like(mask)) + mask
            accum = torch.where(miss[:, None], accum + add, accum)
            depth = torch.where(miss, torch.zeros_like(depth), depth)
        normal = torch.nan_to_num(res.normal)
        newdir = cosine_bounce(normal, r, dt)
        newdir = torch.where(torch.isfinite(newdir), newdir, -d)
        matcolor = material_color(res.value, res.voxel_pos, dt)
        depth = torch.where(hit, res.t, depth)
        ndotl = (newdir * normal).sum(dim=-1, keepdim=True)
        mask = torch.where(hit[:, None], mask * matcolor * ndotl, mask)
        o = torch.where(hit[:, None], res.voxel_pos, o)
        d = torch.where(hit[:, None], newdir, d)
        active = hit
    return accum, depth


def direct_pixels(world, cam5, px, py, width, height, dt=torch.float32,
                  counts=None):
    """Render mode 2 at pixels (px, py) (svotrace.comp:572-632).  Returns
    (colour, depth, open): ``open`` marks pixels whose shadow ray missed,
    where the shader darkens the colour by 0.05 * iters / 100 when the
    shadow ray took more than 260 traversal steps.  That count is the
    traversal's own and a voxel walk has none, so ``colour`` leaves the
    darkening out and the comparison allows it (``direct_match``)."""
    o, dirs = pixel_rays(cam5, px, py, width, height, dt)
    c0 = None if counts is None else {"rays": o.shape[0], "camera": True}
    res = trace(world, o, dirs, None, dt, c0)
    sun = _vec(SUN_DIR_DIRECT, dirs, dt)
    c1 = None if counts is None else {"rays": int(res.hit.sum()),
                                      "camera": False}
    sh = trace(world, res.voxel_pos, sun.expand_as(res.voxel_pos), res.hit,
               dt, c1)
    if counts is not None:
        counts += [c0, c1]
    col = material_color_direct(res.value, dirs, dt)
    normal = torch.nan_to_num(res.normal)
    phong = (normal * sun[None, :]).sum(dim=-1) * 0.1
    flat = (_vec((0.0, 1.0, 0.0), dirs, dt) * sun).sum() * 0.1
    col = col + torch.where(res.depth >= 10, phong, flat)[:, None]
    lam = torch.exp(-0.5 * res.t[:, None]
                    * _vec((1.0, 2.0, 4.0), dirs, dt)[None, :])
    col = lam * col + (1.0 - lam)
    shadowed = sh.hit & (sh.t > sh.scale_exp2 * SQRT3)
    col = torch.where(shadowed[:, None], col - 0.2, col)
    col = torch.where(res.hit[:, None], col, sky(dirs, dt))
    depth = torch.where(res.hit, res.t, torch.zeros_like(res.t))
    return col, depth, res.hit & ~shadowed


def direct_match(col, ref, open_, tol):
    """(n,) bool: the frame's mode-2 colour agrees with the reference's
    within ``tol``, or, on an open pixel, lies below it by one amount
    0.05 * k / 100 in every channel for a whole k above 260 (the
    penumbra of a shadow ray that took k steps)."""
    gap = ref.float() - col.float()
    close = gap.abs().amax(1) <= tol
    k = gap.mean(1) / 0.0005
    whole = (k - k.round()).abs() <= 0.02
    same = (gap - gap.mean(1, keepdim=True)).abs().amax(1) <= tol
    pen = open_ & same & whole & (k.round() > PENUMBRA_ITERS)
    return close | pen
