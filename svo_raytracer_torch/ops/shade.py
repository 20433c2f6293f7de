"""Shading: the four render modes and the ESVO frame (port of
svo_raytracer_tpu/ops/shade.py).

Render modes (svotrace.comp:443-646):
  0 — pathtraced GI: primary + diffuse bounces, sky/sun miss shading
  1 — iteration-count heatmap
  2 — direct lighting: albedo + phong + per-channel exponential fog +
      shadow ray with penumbra heuristic (the app default, Main.java:125)
  3 — normal visualization

Each segment (primary ray, shadow ray, GI bounce) is one batched
traversal followed by elementwise shading.  :func:`render_image` renders
a frame through the ESVO octree traversal (ops/traverse.py, kernel KE on
the GPU), optionally seeded by the skip grid (ops/skip_grid.py, kernel
K2) or the beam prepass; ops/render_wave.py renders through the brick
wavefront and shares the shading here.  Constants keep the reference's
float32 values as written (e.g. ``2.0 * 3.14159265359``); only the
reference's sin-hash random (``rng_mode="glsl"``) is ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import constants as C
from . import rng, skip_grid, traverse

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
SUN_DIR_DIRECT = tuple(float(v) for v in                             # :587
                       np.full(3, 0.5, np.float32)
                       / np.sqrt(np.float32(0.75)))
SQRT3 = float(np.float32(C.SQRT3))


def _vec(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def material_color(value, voxel_pos):
    """Albedo by voxel value; default = hitpoint-1 (svotrace.comp:511-522)."""
    col = voxel_pos - 1.0
    for v, rgb in _PALETTE.items():
        col = torch.where((value == v)[:, None], _vec(rgb, col), col)
    return col


def material_color_direct(value):
    """Mode-2 albedo: 0 for values outside the palette (the GLSL local of
    svotrace.comp:577-586 has no default branch)."""
    col = torch.zeros(value.shape + (3,), dtype=torch.float32,
                      device=value.device)
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


def pixel_dirs_rows(cam5, width, height, row0, nrows):
    """Unnormalized ray directions of image rows [row0, row0 + nrows),
    row-major (nrows*W, 3): dir = mix(mix(l1,l2,p.y), mix(r1,r2,p.y), p.x),
    p = (px+0.5)/size (svotrace.comp:662-664).  Row 0 = p.y~0 (the GL
    bottom row)."""
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    pxs = (torch.arange(width, dtype=torch.float32, device=cam5.device)
           + 0.5) / float(width)
    pys = ((torch.arange(nrows, dtype=torch.float32, device=cam5.device)
            + float(row0) + 0.5) / float(height))
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = left[:, None, :] + (right - left)[:, None, :] * pxs[None, :, None]
    return dirs.reshape(-1, 3)


def pixel_dirs_device(cam5, width, height):
    """All per-pixel unnormalized directions, row-major (H*W, 3)."""
    return pixel_dirs_rows(cam5, width, height, 0, height)


# ------------------------------------------------------------ segment shading
def gi_update(first, mirror_values, accum, mask, depth, iters_out, active,
              o, d, r, res):
    """One segment of render mode 0 (svotrace.comp:443-560) given its hit
    record: miss shading, then the bounce ray of every hit.  Returns
    (accum, mask, depth, iters_out, hit, next origins, next dirs).

    Reference quirks kept: the per-pixel random ``r`` is the same in every
    segment, and depth is the last segment's hit distance (0 on a bounce
    miss, -1 on a primary miss)."""
    hit = active & res.hit
    miss = active & ~res.hit

    if first:  # primary miss -> sky gradient (svotrace.comp:448-452)
        accum = torch.where(miss[:, None], accum + sky(d), accum)
        iters_out = torch.where(active, res.iters, iters_out)
    else:  # bounce miss -> sun disk + ambient (svotrace.comp:536-557)
        sun = _vec(SUN_DIR_GI, d)
        sun_hit = torch.arccos(
            (d * sun[None, :]).sum(dim=-1).clamp(-1.0, 1.0)) < 0.4
        add = torch.where(sun_hit[:, None], mask * 7.0,
                          torch.zeros_like(mask)) + mask
        accum = torch.where(miss[:, None], accum + add, accum)
        depth = torch.where(miss, torch.zeros_like(depth), depth)
        iters_out = torch.where(hit, res.iters, iters_out)

    normal = torch.nan_to_num(res.normal)
    newdir = cosine_bounce(normal, r)
    if mirror_values:
        is_mirror = torch.zeros_like(active)
        for v in mirror_values:
            is_mirror = is_mirror | (res.value == v)
        newdir = torch.where(is_mirror[:, None], mirror_bounce(d, normal),
                             newdir)
    # a zero normal makes the bounce frame degenerate (NaN); bounce back
    newdir = torch.where(torch.isfinite(newdir), newdir, -d)
    matcolor = material_color(res.value, res.voxel_pos)

    depth = torch.where(hit, res.t, depth)
    ndotl = (newdir * normal).sum(dim=-1, keepdim=True)
    if mirror_values:  # mirrors attenuate by albedo only
        ndotl = torch.where(is_mirror[:, None], torch.ones_like(ndotl),
                            ndotl)
    mask = torch.where(hit[:, None], mask * matcolor * ndotl, mask)
    o = torch.where(hit[:, None], res.voxel_pos, o)
    d = torch.where(hit[:, None], newdir, d)
    return accum, mask, depth, iters_out, hit, o, d


def heatmap_colors(res):
    """Render mode 1 (svotrace.comp:561-571): hits 0.005*iter, misses
    0.01*iter.  Returns (col, depth, iters)."""
    it = res.iters.float()
    v = torch.where(res.hit, 0.005 * it, 0.01 * it)
    return (v[:, None].repeat(1, 3),
            torch.where(res.hit, res.t, torch.zeros_like(res.t)), res.iters)


def normal_colors(res):
    """Render mode 3 (svotrace.comp:633-642): normal*0.5 + 0.5 on hits.
    Returns (col, depth, iters)."""
    col = torch.where(res.hit[:, None], res.normal * 0.5 + 0.5,
                      torch.zeros_like(res.normal))
    return col, torch.where(res.hit, res.t, torch.zeros_like(res.t)), \
        res.iters


def direct_shade_math(dirs, res, sh, beam_dist):
    """The shading of render mode 2 given the primary (``res``) and shadow
    (``sh``) hit records (svotrace.comp:572-632).  Returns (col, depth,
    iters)."""
    col = material_color_direct(res.value)
    sun = _vec(SUN_DIR_DIRECT, dirs)
    normal = torch.nan_to_num(res.normal)
    phong = (normal * sun[None, :]).sum(dim=-1) * 0.1
    flat = (_vec((0.0, 1.0, 0.0), dirs) * sun).sum() * 0.1
    col = col + torch.where(res.depth >= 10, phong, flat)[:, None]
    # per-channel exponential fog toward white, coefficients 1/2/4
    # (svotrace.comp:595-604)
    true_dist = res.t + beam_dist
    lam = torch.exp(-0.5 * true_dist[:, None]
                    * _vec((1.0, 2.0, 4.0), dirs)[None, :])
    col = lam * col + (1.0 - lam)
    shadowed = sh.hit & (sh.t > sh.scale_exp2 * SQRT3)
    penumbra = ~shadowed & (sh.iters > 260)
    col = torch.where(shadowed[:, None], col - 0.2, col)
    col = torch.where(penumbra[:, None],
                      col - 0.05 * (sh.iters.float() / 100.0)[:, None], col)
    col = torch.where(res.hit[:, None], col, sky(dirs))
    depth = torch.where(res.hit, res.t, torch.zeros_like(res.t))
    return col, depth, res.iters


# ----------------------------------------------------------- the ESVO frame
def _isect(tree, intersect_fn):
    return intersect_fn or functools.partial(traverse.intersect_octree, tree)


def shade_gi(tree, origins, dirs, px, py, frame_number, gi_bounces=1,
             max_depth=C.MAX_DEPTH, max_iterations=C.MAX_RAYCAST_ITERATIONS,
             mirror_values=(), intersect_fn=None):
    """Render mode 0: primary + ``gi_bounces`` segments, with the
    per-pixel sin-hash random of pixel (px, py).  ``intersect_fn``
    replaces the traversal (signature of traverse.intersect_octree minus
    the tree).  Returns (col, depth, iters)."""
    isect = _isect(tree, intersect_fn)
    B, dev = origins.shape[0], origins.device
    accum = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    mask = torch.ones((B, 3), dtype=torch.float32, device=dev)
    depth = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
    iters_out = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    r = rng.pixel_rand(px.float(), py.float(), frame_number)
    o, d = origins, dirs
    for seg in range(gi_bounces + 1):
        # dead rays leave the traversal batch ("dead rays culled")
        res = isect(o, d, max_depth=max_depth, cone_trace=seg > 0,
                    max_iterations=max_iterations, active=active)
        accum, mask, depth, iters_out, active, o, d = gi_update(
            seg == 0, tuple(mirror_values), accum, mask, depth, iters_out,
            active, o, d, r, res)
    return accum, depth, iters_out


def shade_direct(tree, origins, dirs, beam_dist=None, max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, intersect_fn=None):
    """Render mode 2: the primary hit, then a shadow ray from the hit voxel
    toward the sun (svotrace.comp:606-619), active on hits only."""
    isect = _isect(tree, intersect_fn)
    res = isect(origins, dirs, max_depth=max_depth,
                max_iterations=max_iterations)
    sun = _vec(SUN_DIR_DIRECT, dirs).expand_as(res.voxel_pos)
    sh = isect(res.voxel_pos, sun, max_depth=max_depth,
               max_iterations=max_iterations, active=res.hit)
    bd = torch.zeros_like(res.t) if beam_dist is None else beam_dist
    return direct_shade_math(dirs, res, sh, bd)


def shade_heatmap(tree, origins, dirs, max_depth=C.MAX_DEPTH,
                  max_iterations=C.MAX_RAYCAST_ITERATIONS, intersect_fn=None):
    """Render mode 1 over the traversal."""
    return heatmap_colors(_isect(tree, intersect_fn)(
        origins, dirs, max_depth=max_depth, max_iterations=max_iterations))


def shade_normals(tree, origins, dirs, max_depth=C.MAX_DEPTH,
                  max_iterations=C.MAX_RAYCAST_ITERATIONS, intersect_fn=None):
    """Render mode 3 over the traversal."""
    return normal_colors(_isect(tree, intersect_fn)(
        origins, dirs, max_depth=max_depth, max_iterations=max_iterations))


def beam_prepass(tree, cam5, width, height, beam_tile=4,
                 max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, packed=None):
    """Coarse-ray prepass (svobeam.comp:618-636): one cone-traced ray per
    beam_tile x beam_tile tile seeds a conservative start distance; returns
    (H // tile, W // tile) t, 0 on a miss.

    Reference quirks kept: the coarse direction is the unnormalized corner
    mix (so its t undershoots along the fine unit direction), and the
    coarse pixel is the tile's corner, not its centre."""
    bw, bh = width // beam_tile, height // beam_tile
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    ar = dict(dtype=torch.float32, device=cam5.device)
    pxs = (torch.arange(bw, **ar) * beam_tile + 0.5) / float(width)
    pys = (torch.arange(bh, **ar) * beam_tile + 0.5) / float(height)
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = (left[:, None, :]
            + (right - left)[:, None, :] * pxs[None, :, None]).reshape(-1, 3)
    res = traverse.intersect_octree(tree, cam5[0].expand_as(dirs), dirs,
                                    max_depth=max_depth, cone_trace=True,
                                    max_iterations=max_iterations,
                                    packed=packed)
    return torch.where(res.hit, res.t, torch.zeros_like(res.t)).reshape(
        bh, bw)


def render_image(tree, cam5, width, height, render_mode=2, frame_number=1,
                 gi_bounces=1, use_beam=False, beam_tile=4,
                 max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, mirror_values=(),
                 packed=None, skip_tab=None, skip_grid_size=32, stats=None):
    """Render one frame through the ESVO traversal of a DeviceOctree.

    ``cam5`` is the (5,3) camera uniform (position, then the l1, l2, r1,
    r2 corner directions) on the tree's device.  ``packed`` is the cached
    traverse.make_packed_table; ``skip_tab`` the (rows, 128) int32 skip
    grid (brick_scene.table_rows of skip_grid.build_skip_grid) of
    ``skip_grid_size`` cells per edge.  ``stats`` (a list) collects one
    intersect_octree profile per traversal segment (the beam prepass
    aside).  Returns (color (H,W,3), depth (H,W), iters (H,W)); row 0 is
    the GL bottom scanline."""
    if render_mode not in (0, 1, 2, 3):
        raise ValueError(f"unknown render mode {render_mode}")
    cam5 = cam5.to(torch.float32)
    if packed is None:
        packed = traverse.make_packed_table(tree)
    dirs = _normalize(pixel_dirs_device(cam5, width, height))
    origins = cam5[0].expand_as(dirs)

    # every segment traces the W*H pixel rays in 8x4 pixel tiles
    tiles = traverse.tile_order(width, height, cam5.device)

    def isect(o, d, **kw):
        prof = None if stats is None else {}
        res = traverse.intersect_octree(tree, o, d, packed=packed,
                                        profile=prof, order=tiles, **kw)
        if stats is not None:
            stats.append(prof)
        return res

    if skip_tab is not None:
        isect = skip_grid.make_skipping_isect(isect, skip_tab,
                                              grid_size=skip_grid_size)
    beam = None
    if use_beam:
        bt = beam_prepass(tree, cam5, width, height, beam_tile, max_depth,
                          max_iterations, packed=packed)
        # fine pixel (x, y) reads beam cell (x // tile, y // tile)
        # (svotrace.comp:656-658), clamped at a ragged edge
        dev = cam5.device
        by = (torch.arange(height, device=dev) // beam_tile).clamp_max(
            bt.shape[0] - 1)
        bx = (torch.arange(width, device=dev) // beam_tile).clamp_max(
            bt.shape[1] - 1)
        beam = bt[by[:, None], bx[None, :]].reshape(-1)
        origins = origins + dirs * beam[:, None]

    kw = dict(max_depth=max_depth, max_iterations=max_iterations,
              intersect_fn=isect)
    if render_mode == 0:
        px = torch.arange(width, dtype=torch.float32,
                          device=cam5.device).repeat(height)
        py = torch.arange(height, dtype=torch.float32,
                          device=cam5.device).repeat_interleave(width)
        col, depth, iters = shade_gi(tree, origins, dirs, px, py,
                                     frame_number, gi_bounces,
                                     mirror_values=mirror_values, **kw)
    elif render_mode == 1:
        col, depth, iters = shade_heatmap(tree, origins, dirs, **kw)
    elif render_mode == 2:
        col, depth, iters = shade_direct(tree, origins, dirs, beam, **kw)
    else:
        col, depth, iters = shade_normals(tree, origins, dirs, **kw)
    return (col.reshape(height, width, 3), depth.reshape(height, width),
            iters.reshape(height, width))
