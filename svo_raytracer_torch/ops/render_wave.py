"""Frame rendering through the wavefront engine (port of
svo_raytracer_tpu/ops/render_wave.py, render modes 0, 1 and 3).

A frame is a few traversal segments (``wavefront.intersect_wavefront``,
one launch of kernel K1 each on the GPU) with elementwise shading between
them.  Rays are generated in 32x32-pixel block-major order, as in the JAX
package, so that one warp's rays are neighbouring pixels; ``_unblock``
turns the flat result back into an image.  The JAX engine's static
schedule replay and camera-mode segments have no counterpart here: each
segment is one kernel launch over explicit rays.
"""

from __future__ import annotations

import torch

from . import rng, shade, wavefront

BLK = 32


def _use_block(width):
    """Block-major order needs whole 32-pixel columns; odd widths fall
    back to row-major."""
    return width % BLK == 0


def _frame_B(width, height):
    """Ray-array length of a frame (32-padded height in block mode)."""
    if not _use_block(width):
        return width * height
    return width * (-(-height // BLK) * BLK)


def _frame_rays(cam5, width, height):
    """(origins, unit dirs, px, py) of a frame in block-major order: index
    i walks 32x32-pixel blocks (row-major blocks, row-major pixels within
    a block).  Pad rows (py >= height) reuse the last real row's
    direction and are cropped by _unblock."""
    dev = cam5.device
    if not _use_block(width):
        dirs = shade._normalize(shade.pixel_dirs_device(cam5, width, height))
        px = torch.arange(width, dtype=torch.float32,
                          device=dev).repeat(height)
        py = torch.arange(height, dtype=torch.float32,
                          device=dev).repeat_interleave(width)
        return cam5[0].expand_as(dirs), dirs, px, py
    nbx = width // BLK
    nby = -(-height // BLK)
    shp = (nby, nbx, BLK, BLK)
    ar = torch.arange(BLK, dtype=torch.int32, device=dev)
    by = torch.arange(nby, dtype=torch.int32, device=dev)[:, None, None, None]
    bx = torch.arange(nbx, dtype=torch.int32, device=dev)[None, :, None, None]
    ly = ar[None, None, :, None]
    lx = ar[None, None, None, :]
    px = (bx * BLK + lx).expand(shp).reshape(-1).float()
    py = (by * BLK + ly).expand(shp).reshape(-1).float()
    u = (px + 0.5) / float(width)
    v = (py.clamp_max(float(height - 1)) + 0.5) / float(height)
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    left = l1[None] + (l2 - l1)[None] * v[:, None]
    right = r1[None] + (r2 - r1)[None] * v[:, None]
    dirs = shade._normalize(left + (right - left) * u[:, None])
    return cam5[0].expand_as(dirs), dirs, px, py


def _unblock(a, width, height):
    """Block-major flat array -> (height, width, ...) image."""
    if not _use_block(width):
        return a.reshape(height, width, *a.shape[1:])
    nbx = width // BLK
    nby = a.shape[0] // (width * BLK)
    x = a.reshape(nby, nbx, BLK, BLK, *a.shape[1:])
    x = torch.movedim(x, 2, 1)
    return x.reshape(nby * BLK, width, *a.shape[1:])[:height]


def _gi_update(first, mirror_values, accum, mask, depth, iters_out, active,
               o, d, r, res):
    """One segment of render mode 0 (svotrace.comp:443-560) given its hit
    record: miss shading, then the bounce ray of every hit."""
    hit = active & res.hit
    miss = active & ~res.hit

    if first:
        accum = torch.where(miss[:, None], accum + shade.sky(d), accum)
        iters_out = torch.where(active, res.iters, iters_out)
    else:
        sun = shade._vec(shade.SUN_DIR_GI, d)
        sun_hit = torch.arccos(
            (d * sun[None, :]).sum(dim=-1).clamp(-1.0, 1.0)) < 0.4
        add = torch.where(sun_hit[:, None], mask * 7.0,
                          torch.zeros_like(mask)) + mask
        accum = torch.where(miss[:, None], accum + add, accum)
        depth = torch.where(miss, torch.zeros_like(depth), depth)
        iters_out = torch.where(hit, res.iters, iters_out)

    normal = torch.nan_to_num(res.normal)
    newdir = shade.cosine_bounce(normal, r)
    if mirror_values:
        is_mirror = torch.zeros_like(active)
        for v in mirror_values:
            is_mirror = is_mirror | (res.value == v)
        newdir = torch.where(is_mirror[:, None],
                             shade.mirror_bounce(d, normal), newdir)
    newdir = torch.where(torch.isfinite(newdir), newdir, -d)
    matcolor = shade.material_color(res.value, res.voxel_pos)

    depth = torch.where(hit, res.t, depth)
    ndotl = (newdir * normal).sum(dim=-1, keepdim=True)
    if mirror_values:
        ndotl = torch.where(is_mirror[:, None], torch.ones_like(ndotl),
                            ndotl)
    mask = torch.where(hit[:, None], mask * matcolor * ndotl, mask)
    o = torch.where(hit[:, None], res.voxel_pos, o)
    d = torch.where(hit[:, None], newdir, d)
    return accum, mask, depth, iters_out, hit, o, d


def _heat_post(res):
    it = res.iters.float()
    v = torch.where(res.hit, 0.005 * it, 0.01 * it)
    return (v[:, None].repeat(1, 3),
            torch.where(res.hit, res.t, torch.zeros_like(res.t)), res.iters)


def _norm_post(res):
    col = torch.where(res.hit[:, None], res.normal * 0.5 + 0.5,
                      torch.zeros_like(res.normal))
    return col, torch.where(res.hit, res.t, torch.zeros_like(res.t)), \
        res.iters


def _segment(wscene, o, d, active, stats):
    """One traversal segment; ``stats`` (a list or None) gets its
    intersect_wavefront profile."""
    profile = None if stats is None else {}
    res = wavefront.intersect_wavefront(wscene, o, d, active=active,
                                        profile=profile)
    if stats is not None:
        stats.append(profile)
    return res


def _render_gi(wscene, cam5, width, height, gi_bounces, mirror_values,
               rand, stats=None):
    """Render mode 0 given the per-pixel random ``rand`` (length
    ``_frame_B``, block-major).  Returns flat block-major (col, depth,
    iters)."""
    origins, dirs, _, _ = _frame_rays(cam5, width, height)
    B = dirs.shape[0]
    dev = dirs.device
    accum = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    mask = torch.ones((B, 3), dtype=torch.float32, device=dev)
    depth = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
    iters_out = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    o, d = origins, dirs
    for seg in range(gi_bounces + 1):
        res = _segment(wscene, o, d, None if seg == 0 else active, stats)
        accum, mask, depth, iters_out, active, o, d = _gi_update(
            seg == 0, tuple(mirror_values), accum, mask, depth, iters_out,
            active, o, d, rand, res)
    return accum, depth, iters_out


def render_frame_wavefront(wscene, cam5, width, height, render_mode=0,
                           frame_number=1, gi_bounces=1, mirror_values=(),
                           stats=None):
    """Render one frame through the wavefront engine.

    ``cam5`` is the (5,3) camera uniform (position, then the l1, l2, r1,
    r2 corner directions) as a float32 tensor on the scene's device.
    Returns (color (H,W,3), depth (H,W), iters (H,W)); row 0 is the GL
    bottom scanline.  Modes: 0 pathtraced GI (glsl random), 1 iteration
    heatmap, 3 normals.  ``stats`` (a list) collects one dict per
    traversal segment.
    """
    cam5 = cam5.to(torch.float32)
    if render_mode == 0:
        _, _, px, py = _frame_rays(cam5, width, height)
        rand = rng.pixel_rand(px, py, frame_number)
        col, depth, it = _render_gi(wscene, cam5, width, height, gi_bounces,
                                    mirror_values, rand, stats)
    elif render_mode in (1, 3):
        origins, dirs, _, _ = _frame_rays(cam5, width, height)
        res = _segment(wscene, origins, dirs, None, stats)
        col, depth, it = (_heat_post(res) if render_mode == 1
                          else _norm_post(res))
    elif render_mode == 2:
        raise NotImplementedError("render mode 2 (direct light + shadow "
                                  "rays) is not ported yet")
    else:
        raise ValueError(f"unknown render mode {render_mode}")
    return (_unblock(col, width, height), _unblock(depth, width, height),
            _unblock(it, width, height))
