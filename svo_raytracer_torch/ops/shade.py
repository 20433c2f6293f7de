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
K2) or the beam prepass; :func:`render_frame_staged` is the JAX
package's production ESVO frame (the beam prepass on, its coarse rays
through the skip grid) over the same kernels, and
:func:`render_progressive` averages threefry mode-0 samples.
ops/render_wave.py renders through the brick wavefront and shares the
shading here.  Constants keep the reference's float32
values as written (e.g. ``2.0 * 3.14159265359``).  Mode 0 draws its
random from the reference's sin hash (``rng_mode="glsl"``) or from
threefry (``"threefry"``, ops/rng.py).

Mode 0's shading of a segment, :func:`gi_update`, runs kernel GI_SHADE
(``csrc/gi_shade.cu`` over ``csrc/gi_shade.cuh``, one launch a segment)
on CUDA tensors and its plain version :func:`gi_update_plain` on CPU
tensors; the two are bit-equal on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import constants as C
from . import fp, kernel_build, rng, skip_grid, traverse

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
    """(B,3) rows over their length, correctly rounded (ops/fp.py)."""
    return fp.unit_rows(v)


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
    # true divisions: on the card, a tensor divided by a Python scalar is
    # multiplied by the scalar's reciprocal, which rounds differently
    xs = torch.arange(width, dtype=torch.float32, device=cam5.device) + 0.5
    ys = (torch.arange(nrows, dtype=torch.float32, device=cam5.device)
          + float(row0) + 0.5)
    pxs = xs / torch.full_like(xs, float(width))
    pys = ys / torch.full_like(ys, float(height))
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = left[:, None, :] + (right - left)[:, None, :] * pxs[None, :, None]
    return dirs.reshape(-1, 3)


def pixel_dirs_device(cam5, width, height):
    """All per-pixel unnormalized directions, row-major (H*W, 3)."""
    return pixel_dirs_rows(cam5, width, height, 0, height)


# ------------------------------------------------------------ segment shading
_P, _I = ctypes.c_void_p, ctypes.c_int
GI_SHADE = kernel_build.Kernel(
    "gi_shade", ["gi_shade.cu"], "gi_shade",
    [_I, _I, ctypes.POINTER(ctypes.c_uint32)] + [_P] * 5
    + [_P, _I, _I, _P, _I, _I] + [_P] * 15)


def gi_update(first, mirror_values, accum, mask, depth, iters_out, active,
              o, d, r, res):
    """One segment of render mode 0 (svotrace.comp:443-560) given its hit
    record: miss shading, then the bounce ray of every hit.  Returns
    (accum, mask, depth, iters_out, hit, next origins, next dirs), fresh
    tensors.

    Reference quirks kept: the per-pixel random ``r`` is the same in every
    segment, and depth is the last segment's hit distance (0 on a bounce
    miss, -1 on a primary miss).  Kernel GI_SHADE for CUDA tensors
    (:func:`gi_update_kernel`), the plain version for CPU tensors."""
    if accum.device.type != "cuda":
        return gi_update_plain(first, mirror_values, accum, mask, depth,
                               iters_out, active, o, d, r, res)
    # the kernel reads packed rows (a no-op for every engine's record); a
    # record merged from columns of wider tensors (parallel/bricks.py) is
    # packed here.  Origins and directions it reads through their strides.
    res = res._replace(**{f: getattr(res, f).contiguous() for f in
                          ("hit", "value", "iters", "t", "normal",
                           "voxel_pos")})
    accum, mask, depth, iters_out, active, r = (
        x.contiguous() for x in (accum, mask, depth, iters_out, active, r))
    return gi_update_kernel(first, mirror_values, accum, mask, depth,
                            iters_out, active, o, d, r, res)


def _mirror_words(mirror_values):
    """The 256-bit mask of the mirror materials, as 8 uint32 words."""
    words = (ctypes.c_uint32 * 8)()
    for v in mirror_values:
        v = int(v)
        if not 0 <= v <= 255:
            raise ValueError(f"mirror value {v}: materials are bytes")
        words[v >> 5] |= 1 << (v & 31)
    return words


def gi_update_kernel(first, mirror_values, accum, mask, depth, iters_out,
                     active, o, d, r, res):
    """Kernel GI_SHADE on the card: same contract as
    :func:`gi_update_plain`, one launch and no other device work.  The
    per-ray tensors are contiguous on one device: accum, mask,
    ``res.normal`` and ``res.voxel_pos`` (B,3) float32; depth, r and
    ``res.t`` (B,) float32; iters_out and ``res.iters`` (B,) int32;
    ``res.value`` (B,) int32; active and ``res.hit`` (B,) bool.  ``o`` and
    ``d`` are (B,3) float32 of any strides (a frame's origins are the
    camera row expanded), read in place.  ``mirror_values`` are material
    bytes, 0..255."""
    B, dev = accum.shape[0], accum.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    kernel_build.check_tensors(
        dev, ("accum", accum, (B, 3), f32), ("mask", mask, (B, 3), f32),
        ("depth", depth, (B,), f32), ("iters_out", iters_out, (B,), i32),
        ("active", active, (B,), b8), ("r", r, (B,), f32),
        ("res.hit", res.hit, (B,), b8), ("res.value", res.value, (B,), i32),
        ("res.iters", res.iters, (B,), i32), ("res.t", res.t, (B,), f32),
        ("res.normal", res.normal, (B, 3), f32),
        ("res.voxel_pos", res.voxel_pos, (B, 3), f32),
        strided=[("o", o, (B, 3), f32), ("d", d, (B, 3), f32)])
    words = _mirror_words(mirror_values)
    out = (torch.empty_like(accum), torch.empty_like(mask),
           torch.empty_like(depth), torch.empty_like(iters_out),
           torch.empty_like(active), torch.empty((B, 3), dtype=f32,
                                                 device=dev),
           torch.empty((B, 3), dtype=f32, device=dev))
    if B:
        GI_SHADE.launch(dev, B, int(bool(first)), words, active.data_ptr(),
                        accum.data_ptr(), mask.data_ptr(), depth.data_ptr(),
                        iters_out.data_ptr(), o.data_ptr(), *o.stride(),
                        d.data_ptr(), *d.stride(), r.data_ptr(),
                        res.hit.data_ptr(), res.value.data_ptr(),
                        res.iters.data_ptr(), res.t.data_ptr(),
                        res.normal.data_ptr(), res.voxel_pos.data_ptr(),
                        *[x.data_ptr() for x in out])
    return out


def gi_update_plain(first, mirror_values, accum, mask, depth, iters_out,
                    active, o, d, r, res):
    """Plain PyTorch version of kernel GI_SHADE: :func:`gi_update`'s
    contract, in eager ops on either device."""
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
             rng_mode="glsl", rng_key=None, mirror_values=(),
             intersect_fn=None):
    """Render mode 0: primary + ``gi_bounces`` segments.  ``rng_mode``
    "glsl" takes the per-pixel sin-hash random of pixel (px, py), the
    same in every segment; "threefry" draws ray i's random anew after
    each segment's traversal, as element i of
    rng.threefry_uniform(rng_key, arange(B), frame_number, segment, 1).
    ``intersect_fn`` replaces the traversal (signature of
    traverse.intersect_octree minus the tree).  Returns (col, depth,
    iters)."""
    if rng_mode not in ("glsl", "threefry"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if rng_mode == "threefry" and rng_key is None:
        raise ValueError("rng_mode='threefry' needs an rng_key")
    isect = _isect(tree, intersect_fn)
    B, dev = origins.shape[0], origins.device
    accum = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    mask = torch.ones((B, 3), dtype=torch.float32, device=dev)
    depth = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
    iters_out = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    if rng_mode == "glsl":
        r = rng.pixel_rand(px.float(), py.float(), frame_number)
    o, d = origins, dirs
    for seg in range(gi_bounces + 1):
        # dead rays leave the traversal batch ("dead rays culled")
        res = isect(o, d, max_depth=max_depth, cone_trace=seg > 0,
                    max_iterations=max_iterations, active=active)
        if rng_mode == "threefry":
            r = rng.threefry_uniform(
                rng_key, torch.arange(B, device=dev), int(frame_number),
                seg, 1)[:, 0]
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


def _beam_dirs(cam5, width, height, beam_tile):
    """The beam prepass's (bh * bw, 3) coarse directions: the
    unnormalized corner mix at each tile's corner pixel."""
    bw, bh = width // beam_tile, height // beam_tile
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    ar = dict(dtype=torch.float32, device=cam5.device)
    xs = torch.arange(bw, **ar) * float(beam_tile) + 0.5
    ys = torch.arange(bh, **ar) * float(beam_tile) + 0.5
    # true divisions, as in pixel_dirs_rows
    pxs = xs / torch.full_like(xs, float(width))
    pys = ys / torch.full_like(ys, float(height))
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    return (left[:, None, :]
            + (right - left)[:, None, :] * pxs[None, :, None]).reshape(-1, 3)


def _beam_image(res, width, height, beam_tile):
    """The (H // tile, W // tile) beam image of the coarse rays' record:
    t on a hit, 0 on a miss."""
    return torch.where(res.hit, res.t, torch.zeros_like(res.t)).reshape(
        height // beam_tile, width // beam_tile)


def _beam_rows(bt, width, height, beam_tile):
    """The beam distance of each pixel, row-major: pixel (x, y) reads beam
    cell (x // tile, y // tile) (svotrace.comp:656-658), clamped at a
    ragged edge as XLA clamps the JAX package's gather."""
    dev = bt.device
    by = (torch.arange(height, device=dev)
          // beam_tile).clamp_max(bt.shape[0] - 1)
    bx = (torch.arange(width, device=dev) // beam_tile).clamp_max(
        bt.shape[1] - 1)
    return bt[by[:, None], bx[None, :]].reshape(-1)


def beam_prepass(tree, cam5, width, height, beam_tile=4,
                 max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, packed=None):
    """Coarse-ray prepass (svobeam.comp:618-636): one cone-traced ray per
    beam_tile x beam_tile tile seeds a conservative start distance; returns
    (H // tile, W // tile) t, 0 on a miss.

    Reference quirks kept: the coarse direction is the unnormalized corner
    mix (so its t undershoots along the fine unit direction), and the
    coarse pixel is the tile's corner, not its centre."""
    dirs = _beam_dirs(cam5, width, height, beam_tile)
    res = traverse.intersect_octree(tree, cam5[0].expand_as(dirs), dirs,
                                    max_depth=max_depth, cone_trace=True,
                                    max_iterations=max_iterations,
                                    packed=packed)
    return _beam_image(res, width, height, beam_tile)


def _profiled(isect, stats):
    """``isect`` appending each call's intersect_octree profile to
    ``stats`` (a list), or ``isect`` itself when ``stats`` is None."""
    if stats is None:
        return isect

    def wrapped(o, d, **kw):
        prof = {}
        res = isect(o, d, profile=prof, **kw)
        stats.append(prof)
        return res

    return wrapped


def _check_mode(render_mode):
    if render_mode not in (0, 1, 2, 3):
        raise ValueError(f"unknown render mode {render_mode}")


def _frame(isect, cam5, width, height, render_mode, bt, beam_tile,
           frame_number, gi_bounces, max_depth, max_iterations, rng_mode,
           rng_key, mirror_values):
    """One full-frame pass: the W*H unit pixel rays, started at the beam
    image ``bt``'s distances (None: no beam), shaded in mode
    ``render_mode`` through ``isect`` (KE in 8x4 pixel tiles).  Returns
    (color (H,W,3), depth (H,W), iters (H,W))."""
    dev = cam5.device
    dirs = _normalize(pixel_dirs_device(cam5, width, height))
    origins = cam5[0].expand_as(dirs)
    beam = None
    if bt is not None:
        beam = _beam_rows(bt, width, height, beam_tile)
        origins = origins + dirs * beam[:, None]
    # KE traces every segment's W*H pixel rays in 8x4 pixel tiles (K2,
    # bound by the rays' bytes, is faster in ray order)
    kw = dict(max_depth=max_depth, max_iterations=max_iterations,
              intersect_fn=functools.partial(
                  isect, order=traverse.tile_order(width, height, dev)))
    if render_mode == 0:
        px = torch.arange(width, dtype=torch.float32, device=dev).repeat(
            height)
        py = torch.arange(height, dtype=torch.float32,
                          device=dev).repeat_interleave(width)
        col, depth, iters = shade_gi(
            None, origins, dirs, px, py, frame_number, gi_bounces,
            rng_mode=rng_mode, rng_key=rng_key, mirror_values=mirror_values,
            **kw)
    elif render_mode == 1:
        col, depth, iters = shade_heatmap(None, origins, dirs, **kw)
    elif render_mode == 2:
        col, depth, iters = shade_direct(None, origins, dirs, beam, **kw)
    else:
        col, depth, iters = shade_normals(None, origins, dirs, **kw)
    return (col.reshape(height, width, 3), depth.reshape(height, width),
            iters.reshape(height, width))


def render_image(tree, cam5, width, height, render_mode=2, frame_number=1,
                 gi_bounces=1, use_beam=False, beam_tile=4,
                 max_depth=C.MAX_DEPTH,
                 max_iterations=C.MAX_RAYCAST_ITERATIONS, rng_mode="glsl",
                 rng_key=None, mirror_values=(), packed=None, skip_tab=None,
                 skip_grid_size=32, stats=None):
    """Render one frame through the ESVO traversal of a DeviceOctree.

    ``cam5`` is the (5,3) camera uniform (position, then the l1, l2, r1,
    r2 corner directions) on the tree's device.  ``packed`` is the cached
    traverse.make_packed_table; ``skip_tab`` the (rows, 128) int32 skip
    grid (brick_scene.table_rows of skip_grid.build_skip_grid) of
    ``skip_grid_size`` cells per edge.  Mode 0 takes ``rng_mode`` "glsl"
    or "threefry" with ``rng_key`` (rng.prng_key), as shade_gi.
    ``stats`` (a list) collects one intersect_octree profile per
    traversal segment (the beam prepass aside).  Returns (color (H,W,3),
    depth (H,W), iters (H,W)); row 0 is the GL bottom scanline."""
    _check_mode(render_mode)
    cam5 = cam5.to(torch.float32)
    if packed is None:
        packed = traverse.make_packed_table(tree)
    isect = _profiled(functools.partial(traverse.intersect_octree, tree,
                                        packed=packed), stats)
    if skip_tab is not None:
        isect = skip_grid.make_skipping_isect(isect, skip_tab,
                                              grid_size=skip_grid_size)
    bt = None
    if use_beam:
        bt = beam_prepass(tree, cam5, width, height, beam_tile, max_depth,
                          max_iterations, packed=packed)
    return _frame(isect, cam5, width, height, render_mode, bt, beam_tile,
                  frame_number, gi_bounces, max_depth, max_iterations,
                  rng_mode, rng_key, mirror_values)


def render_frame_staged(tree, cam5, width, height, render_mode=2,
                        frame_number=1, gi_bounces=1, use_beam=True,
                        beam_tile=4, max_depth=C.MAX_DEPTH,
                        max_iterations=C.MAX_RAYCAST_ITERATIONS,
                        packed=None, skip_tab=None, skip_grid_size=32,
                        stats=None):
    """The JAX package's production ESVO frame path (shade.py
    render_frame_staged): the beam prepass on by default, its coarse rays
    traced through traverse.intersect_octree_staged (kernel KE) and the
    skip grid (K2) when ``skip_tab`` is given, then one full-frame pass
    of :func:`render_image`'s shading through the same traversal; mode 0
    takes the sin-hash random.  JAX's ``row_block`` is not ported: its
    row blocks keep XLA:TPU gathers under ~0.5 M indices, and a block's
    pixels equal the full frame's (ROADMAP.md, "Do not port").
    ``stats`` (a list) collects one intersect_octree profile per
    traversal segment, the beam's first.  Every pixel equals
    :func:`render_image`'s with the same settings, but where the skip
    grid restarts a coarse beam ray, which moves its t by a few ulps.
    Returns (color (H,W,3), depth (H,W), iters (H,W))."""
    _check_mode(render_mode)
    cam5 = cam5.to(torch.float32)
    if packed is None:
        packed = traverse.make_packed_table(tree)
    isect = _profiled(functools.partial(traverse.intersect_octree_staged,
                                        tree, packed=packed,
                                        max_iterations=max_iterations),
                      stats)
    if skip_tab is not None:
        isect = skip_grid.make_skipping_isect(isect, skip_tab,
                                              grid_size=skip_grid_size)
    bt = None
    if use_beam:
        bdirs = _beam_dirs(cam5, width, height, beam_tile)
        bt = _beam_image(isect(cam5[0].expand_as(bdirs), bdirs,
                               max_depth=max_depth, cone_trace=True),
                         width, height, beam_tile)
    return _frame(isect, cam5, width, height, render_mode, bt, beam_tile,
                  frame_number, gi_bounces, max_depth, max_iterations,
                  "glsl", None, ())


def render_progressive(tree, cam5, width, height, spp=4, gi_bounces=1,
                       rng_key=None, mirror_values=(), max_depth=C.MAX_DEPTH,
                       max_iterations=C.MAX_RAYCAST_ITERATIONS):
    """Progressive pathtrace accumulation (shade.py render_progressive):
    ``spp`` mode-0 samples of :func:`render_image` with threefry random
    under ``rng_key`` (default rng.prng_key(0)), frame numbers 1..spp,
    averaged, all on the tree's cached packed table
    (DeviceOctree.packed_table; runtime/renderer.DeviceTree rebuilds it
    after every upload).  Returns (mean colour (H,W,3), the last sample's
    depth)."""
    if rng_key is None:
        rng_key = rng.prng_key(0)
    packed = tree.packed_table()
    accum = None
    for s in range(spp):
        col, depth, _ = render_image(
            tree, cam5, width, height, render_mode=0, frame_number=s + 1,
            gi_bounces=gi_bounces, max_depth=max_depth,
            max_iterations=max_iterations, rng_mode="threefry",
            rng_key=rng_key, mirror_values=mirror_values, packed=packed)
        accum = col if accum is None else accum + col
    # a true division: on the card, a tensor over a Python scalar is
    # multiplied by its reciprocal
    return accum / torch.full_like(accum, float(spp)), depth
