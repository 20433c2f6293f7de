"""Frame rendering through the wavefront engine (port of
svo_raytracer_tpu/ops/render_wave.py, render modes 0-3).

A frame is a few traversal segments (``wavefront.intersect_wavefront``,
one launch of kernel K1 each on the GPU) with elementwise shading between
them.  Rays are generated in 32x32-pixel block-major order, as in the JAX
package, so that one warp's rays are neighbouring pixels; ``_unblock``
turns the flat result back into an image.  Every primary segment runs in
camera mode, as the JAX package's do: K1 derives each primary ray from
its id and the camera, and the frame's explicit rays only decode the
hits and shade.  Bounce and shadow segments trace explicit rays.  The
JAX engine's static schedule replay has no counterpart here: each
segment is one kernel launch.

A frame starts with one launch of kernel RAYGEN on the card
(:func:`frame_start`): the unit directions, and in mode 0 the per-pixel
random and the shading state, all that the segments read before the
first.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import span
from . import kernel_build, rng, shade, wavefront

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
    a block); row-major when the width is not a multiple of 32.  Pad rows
    (py >= height) reuse the last real row's direction and are cropped by
    _unblock.  The directions are the camera-mode kernel's, operation for
    operation (wavefront.camera_rays), with true divisions: on the card a
    tensor divided by a Python scalar is multiplied by its reciprocal."""
    dev = cam5.device
    if _use_block(width):
        nbx = width // BLK
        nby = -(-height // BLK)
        shp = (nby, nbx, BLK, BLK)
        ar = torch.arange(BLK, dtype=torch.int32, device=dev)
        by = torch.arange(nby, dtype=torch.int32,
                          device=dev)[:, None, None, None]
        bx = torch.arange(nbx, dtype=torch.int32,
                          device=dev)[None, :, None, None]
        px = (bx * BLK + ar[None, None, None, :]).expand(shp).reshape(-1)
        py = (by * BLK + ar[None, None, :, None]).expand(shp).reshape(-1)
        px, py = px.float(), py.float()
    else:
        px = torch.arange(width, dtype=torch.float32,
                          device=dev).repeat(height)
        py = torch.arange(height, dtype=torch.float32,
                          device=dev).repeat_interleave(width)
    u = (px + 0.5) / torch.full_like(px, float(width))
    v = ((py.clamp_max(float(height - 1)) + 0.5)
         / torch.full_like(py, float(height)))
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    left = l1[None] + (l2 - l1)[None] * v[:, None]
    right = r1[None] + (r2 - r1)[None] * v[:, None]
    dirs = wavefront.unit_rows(left + (right - left) * u[:, None])
    return cam5[0].expand_as(dirs), dirs, px, py


class FrameStart(NamedTuple):
    """What a frame's segments read before the first: the rays, and in
    render mode 0 the per-pixel random and _render_gi's initial state
    (None in modes 1-3)."""
    origins: torch.Tensor            # (B,3), the camera row expanded
    dirs: torch.Tensor               # (B,3) unit directions
    rand: Optional[torch.Tensor] = None     # (B,) float32
    accum: Optional[torch.Tensor] = None    # (B,3) float32 zeros
    mask: Optional[torch.Tensor] = None     # (B,3) float32 ones
    depth: Optional[torch.Tensor] = None    # (B,) float32 -1
    iters: Optional[torch.Tensor] = None    # (B,) int32 zeros
    active: Optional[torch.Tensor] = None   # (B,) bool, all true


_P, _I = ctypes.c_void_p, ctypes.c_int
RAYGEN = kernel_build.Kernel(
    "raygen", ["raygen.cu"], "raygen",
    [_I] * 5 + [ctypes.c_float] * 2 + [_P, _I, _I] + [_P] * 7 + [_P])


def frame_start(cam5, width, height, frame_number=None):
    """The start of a frame (FrameStart) in _frame_rays' order from the
    (5,3) float32 camera uniform: the rays, and with ``frame_number``
    (render mode 0) the random and the shading state.  Kernel RAYGEN for
    a CUDA camera (:func:`_frame_start_kernel`, one launch), the plain
    version :func:`_frame_start_plain` for a CPU one; the two are
    bit-equal on the card."""
    if cam5.shape != (5, 3) or cam5.dtype != torch.float32:
        raise ValueError(f"cam5 must be a (5, 3) float32 tensor, not "
                         f"{tuple(cam5.shape)} {cam5.dtype}")
    if width < 1 or height < 1:
        raise ValueError(f"frame {width}x{height} has no pixels")
    if cam5.device.type == "cpu":
        return _frame_start_plain(cam5, width, height, frame_number)
    return _frame_start_kernel(cam5, width, height, frame_number)


def _frame_start_plain(cam5, width, height, frame_number):
    """Plain PyTorch version of kernel RAYGEN, on either device:
    :func:`_frame_rays`, :func:`rng.pixel_rand` of its pixels and the
    state's fills."""
    origins, dirs, px, py = _frame_rays(cam5, width, height)
    if frame_number is None:
        return FrameStart(origins, dirs)
    B, dev = dirs.shape[0], dirs.device
    return FrameStart(
        origins, dirs, rng.pixel_rand(px, py, frame_number),
        torch.zeros((B, 3), dtype=torch.float32, device=dev),
        torch.ones((B, 3), dtype=torch.float32, device=dev),
        torch.full((B,), -1.0, dtype=torch.float32, device=dev),
        torch.zeros((B,), dtype=torch.int32, device=dev),
        torch.ones((B,), dtype=torch.bool, device=dev))


def _frame_start_kernel(cam5, width, height, frame_number):
    """Kernel RAYGEN on the card: same contract as
    :func:`_frame_start_plain`, one launch and no other device work.
    ``cam5`` is read in place, through its strides."""
    dev = cam5.device
    kernel_build.check_tensors(
        dev, strided=[("cam5", cam5, (5, 3), torch.float32)])
    B = _frame_B(width, height)
    if B >= 2 ** 31:
        raise ValueError(f"frame {width}x{height}: {B} rays pass int32 ids")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = [empty(B, 3)]
    gi = frame_number is not None
    offsets = (0.0, 0.0)
    if gi:
        offsets = rng.frame_offsets(frame_number)
        out += [empty(B), empty(B, 3), empty(B, 3), empty(B),
                empty(B, dtype=torch.int32), empty(B, dtype=torch.bool)]
    ptrs = [x.data_ptr() for x in out] + [None] * (7 - len(out))
    RAYGEN.launch(dev, B, width, height,
                  width // BLK if _use_block(width) else 0, int(gi),
                  *offsets, cam5.data_ptr(), *cam5.stride(), *ptrs)
    return FrameStart(cam5[0].expand_as(out[0]), *out)


def _unblock(a, width, height):
    """Block-major flat array -> (height, width, ...) image."""
    if not _use_block(width):
        return a.reshape(height, width, *a.shape[1:])
    nbx = width // BLK
    nby = a.shape[0] // (width * BLK)
    x = a.reshape(nby, nbx, BLK, BLK, *a.shape[1:])
    x = torch.movedim(x, 2, 1)
    return x.reshape(nby * BLK, width, *a.shape[1:])[:height]


def make_isect(wscene):
    """An ``intersect_octree``-shaped callable over a WaveScene (the JAX
    package's make_isect): ``isect(origins, dirs, max_depth=...,
    cone_trace=..., max_iterations=..., active=None)`` traces through
    wavefront.intersect_wavefront.  The brick engine always resolves the
    finest leaf and retires rays at ITER_CAP, so ``max_depth``,
    ``cone_trace`` and ``max_iterations`` are accepted and ignored, as
    in the JAX package."""
    def isect(origins, dirs, max_depth=None, cone_trace=False,
              max_iterations=None, active=None):
        return wavefront.intersect_wavefront(wscene, origins, dirs,
                                             active=active)

    return isect


def _segment(wscene, o, d, active, stats, camera=None):
    """One traversal segment; ``stats`` (a list or None) gets its
    intersect_wavefront profile.  ``camera`` (cam5, W, H) traces the
    frame's primaries in camera mode."""
    profile = None if stats is None else {}
    cam_block = camera is not None and _use_block(camera[1])
    res = wavefront.intersect_wavefront(wscene, o, d, active=active,
                                        profile=profile, camera=camera,
                                        cam_block=cam_block)
    if stats is not None:
        stats.append(profile)
    return res


def _shadow_rays(res):
    """Mode-2 shadow rays: from each primary hit's voxel toward the sun,
    active on hits only."""
    sun = torch.tensor(shade.SUN_DIR_DIRECT, dtype=torch.float32,
                       device=res.voxel_pos.device)
    return res.voxel_pos, sun.expand_as(res.voxel_pos), res.hit


def _render_gi(wscene, cam5, width, height, gi_bounces, mirror_values,
               start, stats=None):
    """Render mode 0 from the frame's start (a mode-0 FrameStart of
    :func:`frame_start`, block-major).  Returns flat block-major (col,
    depth, iters)."""
    o, d, rand, accum, mask, depth, iters_out, active = start
    for seg in range(gi_bounces + 1):
        if seg == 0:
            res = _segment(wscene, o, d, None, stats, (cam5, width, height))
        else:
            res = _segment(wscene, o, d, active, stats)
        with span("svo.shade"):
            accum, mask, depth, iters_out, active, o, d = shade.gi_update(
                seg == 0, tuple(mirror_values), accum, mask, depth,
                iters_out, active, o, d, rand, res)
    return accum, depth, iters_out


def render_frame_wavefront(wscene, cam5, width, height, render_mode=0,
                           frame_number=1, gi_bounces=1, mirror_values=(),
                           stats=None, rng_mode="glsl"):
    """Render one frame through the wavefront engine.

    ``cam5`` is the (5,3) camera uniform (position, then the l1, l2, r1,
    r2 corner directions) as a float32 tensor on the scene's device.
    Returns (color (H,W,3), depth (H,W), iters (H,W)); row 0 is the GL
    bottom scanline.  Modes: 0 pathtraced GI (glsl random), 1 iteration
    heatmap, 2 direct light with a shadow ray toward the sun, 3 normals.
    ``stats`` (a list) collects one dict per traversal segment.  As in
    the JAX package, mode 0 takes only ``rng_mode="glsl"``: threefry
    frames render through shade.render_progressive.
    """
    if render_mode == 0 and rng_mode != "glsl":
        raise NotImplementedError("wavefront GI supports glsl rng; use "
                                  "shade.render_progressive for threefry")
    if render_mode not in (0, 1, 2, 3):
        raise ValueError(f"unknown render mode {render_mode}")
    with span("svo.frame"):
        with span("svo.assembly"):
            cam5 = cam5.to(torch.float32)
            start = frame_start(cam5, width, height,
                                frame_number if render_mode == 0 else None)
        origins, dirs = start.origins, start.dirs
        camera = (cam5, width, height)
        if render_mode == 0:
            col, depth, it = _render_gi(wscene, cam5, width, height,
                                        gi_bounces, mirror_values, start,
                                        stats)
        elif render_mode in (1, 3):
            res = _segment(wscene, origins, dirs, None, stats, camera)
            with span("svo.shade"):
                col, depth, it = (shade.heatmap_colors(res)
                                  if render_mode == 1
                                  else shade.normal_colors(res))
        else:
            res = _segment(wscene, origins, dirs, None, stats, camera)
            with span("svo.shade"):
                so, sd, sa = _shadow_rays(res)
            sh = _segment(wscene, so, sd, sa, stats)
            with span("svo.shade"):
                col, depth, it = shade.direct_shade_math(
                    dirs, res, sh, torch.zeros_like(res.t))
        with span("svo.assembly"):
            return (_unblock(col, width, height),
                    _unblock(depth, width, height),
                    _unblock(it, width, height))
