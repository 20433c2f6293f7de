"""Port frames vs the JAX package's render_frame_wavefront (Pallas kernel
in interpret mode, dynamic schedules) on terrain-64 at 64x40.  Both trace
every primary segment in camera mode (the kernel derives the rays from
the camera); mode 2's shadow segment traces explicit rays.

Mode 0 feeds both packages the same per-pixel random: the numbers the
JAX frame itself draws (its jitted _gi_init; XLA contracts the sin
argument into a fused multiply-add there, so even JAX's eager pixel_rand
differs from it).  Floor (tests/test_render_wave.py): colour within 2e-3
on >= 97% of pixels, depth on >= 97%.  Measured: 100% on every case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import render_wave as jrender_wave
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_tpu.utils.camera import Camera
from svo_raytracer_torch.ops import brick_scene, render_wave, rng, wavefront

W, H = 64, 40
FRAME = 3
# (render_mode, gi_bounces, width); mode 0 with mirror_values=(2,), mode 1
# the iteration heatmap, mode 2 direct light with shadow rays, mode 3
# normals.  Width 48 is not a multiple of 32: row-major rays instead of
# 32x32 blocks.
CASES = [(0, 3, W), (0, 1, W), (1, 1, W), (2, 1, W), (3, 1, W), (3, 1, 48)]


@pytest.fixture(scope="module")
def frames():
    tree = build_np.build_octree_np(make_terrain_voxels(64, seed=7))
    jws = jwavefront.prepare(jbrick_scene.brickify(tree))
    ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
    cam = Camera(pos=np.array([1.3, 1.62, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = cam.uniform().astype(np.float32)
    _, _, px, py = render_wave._frame_rays(torch.from_numpy(cam5), W, H)
    rand = jrender_wave._gi_init(jnp.asarray(px.numpy()),
                                 jnp.asarray(py.numpy()),
                                 jnp.float32(FRAME),
                                 jnp.zeros((px.shape[0], 3)))[-1]
    rand = torch.from_numpy(np.array(rand))
    out = {}
    for mode, bounces, width in CASES:
        ref = jrender_wave.render_frame_wavefront(
            jws, jnp.asarray(cam5), width, H, render_mode=mode,
            frame_number=FRAME, gi_bounces=bounces, mirror_values=(2,),
            interpret=True, use_static=False)
        if mode == 0:
            start = render_wave.frame_start(torch.from_numpy(cam5), W, H,
                                            FRAME)._replace(rand=rand)
            got = render_wave._render_gi(ws, torch.from_numpy(cam5), W, H,
                                         bounces, (2,), start)
            got = tuple(render_wave._unblock(a, W, H) for a in got)
        else:
            got = render_wave.render_frame_wavefront(
                ws, torch.from_numpy(cam5), width, H, render_mode=mode)
        out[mode, bounces, width] = (tuple(np.asarray(a) for a in ref),
                              tuple(a.numpy() for a in got))
    return out


@pytest.mark.parametrize("case", CASES)
def test_frame_matches_jax(frames, case):
    (rc, rd, ri), (gc, gd, gi) = frames[case]
    assert gc.shape == (H, case[2], 3) and gd.shape == (H, case[2])
    assert np.array_equal(np.isnan(rc), np.isnan(gc))
    close = (np.abs(np.nan_to_num(rc) - np.nan_to_num(gc)).max(-1) <= 2e-3)
    depth = np.abs(rd - gd) <= 2e-3
    print(f"{case}: colour {close.mean():.4f} depth {depth.mean():.4f} "
          f"iters {(ri == gi).mean():.4f}")
    assert close.mean() >= 0.97
    assert depth.mean() >= 0.97
    assert 0.02 < (gd > 0).mean() < 0.98   # both hits and sky in view


def test_pixel_rand_drives_mode_0():
    """render_frame_wavefront(mode 0) is _render_gi fed the port's own
    pixel_rand of the block-major pixel grid."""
    tree = build_np.build_octree_np(make_terrain_voxels(64, seed=7))
    ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
    cam = Camera(pos=np.array([1.3, 1.62, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.from_numpy(cam.uniform().astype(np.float32))
    stats = []
    col, depth, it = render_wave.render_frame_wavefront(
        ws, cam5, W, H, render_mode=0, frame_number=FRAME, gi_bounces=2,
        stats=stats)
    _, _, px, py = render_wave._frame_rays(cam5, W, H)
    start = render_wave.frame_start(cam5, W, H, FRAME)._replace(
        rand=rng.pixel_rand(px, py, FRAME))
    ref = render_wave._render_gi(ws, cam5, W, H, 2, (), start)
    assert torch.equal(col, render_wave._unblock(ref[0], W, H))
    assert len(stats) == 3 and stats[0]["rays"] == W * 64
    assert all(s["launches"] == 0 for s in stats)   # CPU: plain version
    # bounce rays start at the primary hits (minus NaN-normal voxel_pos)
    assert 0 < stats[1]["rays"] <= stats[0]["hits"]
