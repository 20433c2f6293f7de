"""Port frames on the paged 4096^3 scene vs the JAX package's
render_frame_wavefront (Pallas kernel in interpret mode, dynamic
schedules) at 96x64, camera of tests/test_paged.py
test_paged_frame_render: render mode 3 (normals) and mode 0 with one GI
bounce, the latter fed the per-pixel random JAX's own frame draws (see
tests/test_torch_render.py).

Floor (the frame floor of tests/test_torch_render.py): colour within 2e-3
on >= 97% of pixels with NaN positions equal (raw normal 555 decodes to
NaN by design), depth within 2e-3 on >= 97%."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svo_raytracer_tpu.ops import render_wave as jrender_wave
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_tpu.utils.camera import Camera
from svo_raytracer_torch.ops import render_wave, wavefront
from test_torch_bigworld import _jax_scene

W, H = 96, 64
FRAME = 3
CASES = [3, 0]      # render modes; mode 0 with gi_bounces=1


@pytest.fixture(scope="module")
def frames():
    scene = chip_smoke.sparse_paged_scene()
    jws = jwavefront.prepare(_jax_scene(scene))
    ws = wavefront.prepare(scene, "cpu")
    cam = Camera(pos=np.array([1.5, 1.40, 1.5]))
    cam.rotate(-0.9, 0.3)
    cam5 = cam.uniform().astype(np.float32)
    out = {}
    for mode in CASES:
        ref = jrender_wave.render_frame_wavefront(
            jws, jnp.asarray(cam5), W, H, render_mode=mode,
            frame_number=FRAME, gi_bounces=1, interpret=True,
            use_static=False)
        if mode == 0:
            _, _, px, py = render_wave._frame_rays(torch.from_numpy(cam5), W,
                                                   H)
            rand = jrender_wave._gi_init(jnp.asarray(px.numpy()),
                                         jnp.asarray(py.numpy()),
                                         jnp.float32(FRAME),
                                         jnp.zeros((px.shape[0], 3)))[-1]
            start = render_wave.frame_start(
                torch.from_numpy(cam5), W, H, FRAME)._replace(
                    rand=torch.from_numpy(np.array(rand)))
            got = render_wave._render_gi(ws, torch.from_numpy(cam5), W, H, 1,
                                         (), start)
            got = tuple(render_wave._unblock(a, W, H) for a in got)
        else:
            got = render_wave.render_frame_wavefront(
                ws, torch.from_numpy(cam5), W, H, render_mode=mode)
        out[mode] = (tuple(np.asarray(a) for a in ref),
                     tuple(a.numpy() for a in got))
    return out


@pytest.mark.parametrize("mode", CASES)
def test_paged_frame_matches_jax(frames, mode):
    (rc, rd, ri), (gc, gd, gi) = frames[mode]
    assert gc.shape == (H, W, 3) and gd.shape == (H, W)
    assert np.array_equal(np.isnan(rc), np.isnan(gc))
    close = np.abs(np.nan_to_num(rc) - np.nan_to_num(gc)).max(-1) <= 2e-3
    depth = np.abs(rd - gd) <= 2e-3
    print(f"mode {mode}: colour {close.mean():.4f} depth {depth.mean():.4f} "
          f"iters {(ri == gi).mean():.4f}, hit pixels {(gd > 0).mean():.3f}")
    assert close.mean() >= 0.97
    assert depth.mean() >= 0.97
    if mode == 3:
        assert 0.2 < (gd > 0).mean() < 0.9   # the uniform patch fills the view
