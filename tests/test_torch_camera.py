"""K1's camera mode in the port (wavefront.intersect_wavefront(...,
camera=...)) against its explicit mode, on terrain-64.

Camera mode derives each primary ray from its id and the camera in the
same float32 operations, in the same order, as render_wave._frame_rays
makes the explicit rays, so every record field is equal on every ray:
block-major frames (whose 32-padded pad rows reuse the last row's
direction) and row-major ones.  The JAX package's own contract for camera
mode (tests/test_wavefront.py test_camera_mode_matches_explicit: hit
equal, value equal on common hits, t within 1e-5) is implied."""

import numpy as np
import pytest
import torch

import chip_smoke
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.ops import brick_scene, render_wave, wavefront
from svo_raytracer_torch.utils.camera import Camera


@pytest.fixture(scope="module")
def scene():
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7))
    ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
    cam = Camera(pos=np.array([1.3, 1.62, 1.3]))
    cam.rotate(-0.5, 0.6)
    return ws, torch.tensor(cam.uniform(), dtype=torch.float32)


@pytest.mark.parametrize("W, H", [(64, 40), (48, 40)])
def test_camera_mode_equals_explicit(scene, W, H):
    """64x40: block-major, 64 rays per column over 40 rows (24 pad rows);
    48x40: row-major (48 is not a multiple of 32)."""
    ws, cam5 = scene
    origins, dirs, _, _ = render_wave._frame_rays(cam5, W, H)
    block = render_wave._use_block(W)
    assert origins.shape[0] == (W * 64 if block else W * H)
    o, d, alive = wavefront._rays(ws, origins, dirs)
    want = wavefront.trace(ws, o, d, alive)
    nbx = W // 32 if block else 0
    got = wavefront.trace_camera(ws, wavefront.cam16(cam5),
                                 origins.shape[0], W, H, nbx)
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    prof_e, prof_c = {}, {}
    exp = wavefront.intersect_wavefront(ws, origins, dirs, profile=prof_e)
    cam = wavefront.intersect_wavefront(ws, origins, dirs, profile=prof_c,
                                        camera=(cam5, W, H), cam_block=block)
    for field in exp._fields:
        a, b = getattr(exp, field), getattr(cam, field)
        assert torch.equal(a.isnan(), b.isnan()), field
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), field
    assert prof_c["camera"] and not prof_e["camera"]
    assert prof_c["rays"] == prof_e["rays"] == origins.shape[0]
    assert 0.05 < exp.hit.float().mean() < 0.95


def test_camera_mode_pad_rows_repeat_last_row(scene):
    """Block mode pads 40 rows to 64; each pad ray repeats the direction of
    row 39 of its column."""
    ws, cam5 = scene
    o, d = wavefront.camera_rays(ws, wavefront.cam16(cam5), 64 * 64, 64, 40,
                                 2)
    img = render_wave._unblock(d, 64, 64)         # (64 rows, 64, 3)
    assert torch.equal(img[40:], img[39:40].expand(24, 64, 3))
    assert torch.isfinite(d).all()
    assert torch.equal(o, ((cam5[0] - 1.0) * 64.0).expand(4096, 3))


def test_camera_mode_raises(scene):
    ws, cam5 = scene
    origins, dirs, _, _ = render_wave._frame_rays(cam5, 64, 40)
    with pytest.raises(ValueError, match="active"):
        wavefront.intersect_wavefront(
            ws, origins, dirs, active=torch.ones(origins.shape[0],
                                                 dtype=torch.bool),
            camera=(cam5, 64, 40), cam_block=True)
    with pytest.raises(ValueError):          # 64 x 40 is 2560, not 4096
        wavefront.intersect_wavefront(ws, origins, dirs,
                                      camera=(cam5, 64, 40))
    with pytest.raises(ValueError):          # 4096 rays cover 64 x 64
        wavefront.intersect_wavefront(ws, origins, dirs,
                                      camera=(cam5, 64, 80), cam_block=True)
    o48, d48, _, _ = render_wave._frame_rays(cam5, 48, 40)
    with pytest.raises(ValueError):          # block mode needs W % 32 == 0
        wavefront.intersect_wavefront(ws, o48, d48, camera=(cam5, 48, 40),
                                      cam_block=True)
