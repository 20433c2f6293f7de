"""Row-sharded rendering through the wavefront engine (port of
svo_raytracer_tpu/parallel/render_wave_sharded.py).

Each rank of the mesh's ``tiles`` axis traces its own rows of the image
through the brick wavefront (``wavefront.intersect_wavefront`` on explicit
rays: K1's keys, ``ray_order`` and kernel K1 on the card), with the
WaveScene replicated, and shades between segments as the single-card
frame does (``shade.gi_update``, ``direct_shade_math``).  By default rows
are interleaved (rank d traces rows d, d + n, ...): terrain frames divide
into sky and ground bands, which contiguous bands would hand to single
ranks.  The rows are all-gathered and put back in image order, so every
rank returns the whole image, and the rays that ran out of steps
(ITER_CAP retirements) are summed over ``tiles``.

The JAX package's static round ladders (``discover_schedules``,
``merge_schedules``) have no counterpart: K1 retires each ray on its own.
"""

from __future__ import annotations

import torch

from ..diff.render_diff import d_unit
from ..ops import rng, shade, wavefront
from ..ops.render_wave import _shadow_rays
from .render_sharded import row_band


def _shard_rays(cam5, width, height, rows, row0, stride=1):
    """(origins, unit dirs, px, py) of image rows ``row0, row0 + stride,
    ...`` (``rows`` of them), row-major.  ``stride=1`` is a contiguous
    band; ``stride=n`` interleaves rows round-robin over n ranks.  Bit for
    bit the JAX package's function called eagerly: each operation rounds
    on its own, and the rows are divided by their length as its jitted
    ``jnp.linalg.norm`` computes it (render_diff.d_unit)."""
    f32 = torch.float32
    dev = cam5.device
    ridx = (torch.arange(rows, dtype=f32, device=dev) * float(stride)
            + float(row0))
    xs = torch.arange(width, dtype=f32, device=dev) + 0.5
    pxs = xs / torch.full_like(xs, float(width))
    pys = (ridx + 0.5) / torch.full_like(ridx, float(height))
    l1, l2, r1, r2 = cam5[1], cam5[2], cam5[3], cam5[4]
    left = l1[None, :] + (l2 - l1)[None, :] * pys[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * pys[:, None]
    dirs = (left[:, None, :]
            + (right - left)[:, None, :] * pxs[None, :, None]).reshape(-1, 3)
    dirs = d_unit(dirs)
    origins = cam5[0].expand_as(dirs)
    px = torch.arange(width, dtype=f32, device=dev).repeat(rows)
    py = ridx.repeat_interleave(width)
    return origins, dirs, px, py


def shard_rows(mesh, height, interleave=True):
    """(first row, rows, stride) of this rank's rows over ``tiles``:
    interleaved (rank d: rows d, d + n, ...) or a contiguous band."""
    _, rows = row_band(mesh, height)
    if interleave:
        return mesh.rank("tiles"), rows, mesh.size("tiles")
    return mesh.rank("tiles") * rows, rows, 1


def gather_rows(mesh, local, width, height, interleave=True):
    """The whole (H, W, ...) image from each rank's (rows, W, ...) rows."""
    n = mesh.size("tiles")
    parts = mesh.all_gather(local, "tiles")       # (n, rows, W, ...)
    if interleave:
        # rank d produced rows d, d + n, ... -> image order
        parts = parts.transpose(0, 1)
    return parts.reshape(height, width, *local.shape[2:])


def make_wave_sharded_render(mesh, wscene, width: int, height: int,
                             render_mode=0, gi_bounces=1, interleave=True):
    """``render(wscene, cam5, frame_number=1, stats=None) -> (col, n_left)``
    with rows sharded over ``tiles`` and the wavefront engine per rank.
    ``col`` is the whole (H, W, 3) image on every rank; ``n_left`` the
    rays retired at ITER_CAP over every segment of every rank.  The
    render takes the WaveScene (``wscene`` here only checks its device),
    so an updated scene renders without a new closure.  ``stats`` (a
    list) collects each segment's intersect_wavefront profile with its
    ``origins``, ``dirs`` and ``active`` mask (this rank's rays).  Modes:
    0 pathtraced GI (glsl random), 1 heatmap, 2 direct light with the
    sun's shadow segment, 3 normals."""
    if render_mode not in (0, 1, 2, 3):
        raise ValueError(f"unknown render mode {render_mode}")
    if wscene.device != mesh.device:
        raise ValueError(f"scene on {wscene.device}, this rank's mesh on "
                         f"{mesh.device}")
    row0, rows, stride = shard_rows(mesh, height, interleave)

    def render(ws, cam5, frame_number=1, stats=None):
        cam5 = cam5.to(torch.float32)
        o, d, px, py = _shard_rays(cam5, width, height, rows, row0, stride)
        capped = []

        def trace(oo, dd, act):
            prof = {}
            res = wavefront.intersect_wavefront(ws, oo, dd, active=act,
                                                profile=prof)
            capped.append(prof["capped"])
            if stats is not None:
                stats.append(dict(prof, origins=oo, dirs=dd, active=act))
            return res

        B = d.shape[0]
        if render_mode == 0:
            r = rng.pixel_rand(px, py, frame_number)
            accum = torch.zeros((B, 3), dtype=torch.float32, device=d.device)
            mask = torch.ones((B, 3), dtype=torch.float32, device=d.device)
            depth = torch.full((B,), -1.0, dtype=torch.float32,
                               device=d.device)
            iters = torch.zeros(B, dtype=torch.int32, device=d.device)
            active = torch.ones(B, dtype=torch.bool, device=d.device)
            oo, dd = o, d
            for seg in range(gi_bounces + 1):
                res = trace(oo, dd, active if seg else None)
                accum, mask, depth, iters, active, oo, dd = shade.gi_update(
                    seg == 0, (), accum, mask, depth, iters, active, oo, dd,
                    r, res)
            col = accum
        elif render_mode == 2:
            res = trace(o, d, None)
            sh = trace(*_shadow_rays(res))
            col, _, _ = shade.direct_shade_math(d, res, sh,
                                                torch.zeros_like(res.t))
        else:
            res = trace(o, d, None)
            col = (shade.heatmap_colors(res) if render_mode == 1
                   else shade.normal_colors(res))[0]
        n_left = mesh.psum(torch.tensor(sum(capped), dtype=torch.int32,
                                        device=d.device), "tiles")
        return (gather_rows(mesh, col.reshape(rows, width, 3), width,
                            height, interleave), int(n_left))

    return render
