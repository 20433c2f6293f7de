"""The port's wavefront train step (svo_raytracer_torch.diff.wave_diff.
make_wave_train_step, on the CPU) against the JAX package's jitted
make_wave_train_step (the chain's Pallas kernel in interpret mode; its
first step compiles for ~80 s) on tests/test_wave_diff.py's two-wall
scene: 16x8 pixels, K = 2, lr 400, 8 steps from init density 4 toward a
black target.

Per-step losses within rtol 1e-4, the tables after step 1 within atol
1e-5, and the loss falling as in test_wave_diff.py's
test_wave_train_step_converges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.diff import wave_diff as jwd
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.diff import wave_diff as wd
from svo_raytracer_torch.ops import brick_scene, shade, wavefront

STEPS = 8


@pytest.fixture(scope="module")
def trained():
    v = chip_smoke.two_wall_voxels()
    jws = jwavefront.prepare(jbrick_scene.brickify(
        jbuild_np.build_octree_np(v)))
    ws = wavefront.prepare(brick_scene.brickify(build_np.build_octree_np(v)),
                           "cpu")
    cam5 = chip_smoke.two_wall_camera()
    W, H = chip_smoke.TWO_WALL_FRAME
    warr = (jws.l0_occ, jws.l0_mixed, jws.brick_slot, jws.occ_words,
            jws.attr_comb, jws.slot_cell, jws.sc_words, jws.l0_sc)
    jstep = jwd.make_wave_train_step(jws, W, H, K=2, lr=400.0,
                                     interpret=True)
    step = wd.make_wave_train_step(ws, W, H, K=2, lr=400.0)
    jparams = jwd.init_params(jws, init_density=4.0)
    params = wd.init_params(ws, init_density=4.0)
    target = np.zeros((H, W, 3), np.float32)
    out = dict(ws=ws, cam5=torch.from_numpy(cam5), W=W, H=H,
               init=params, losses=[], jlosses=[])
    for i in range(STEPS):
        jparams, jloss = jstep(jparams, warr, jnp.asarray(cam5),
                               jnp.asarray(target))
        params, loss = step(params, torch.from_numpy(cam5),
                            torch.from_numpy(target))
        out["losses"].append(float(loss))
        out["jlosses"].append(float(jloss))
        if i == 0:
            out["step1"] = params
            out["jstep1"] = jwd.WaveParams(*(np.asarray(a)
                                             for a in jparams))
    return out


def test_losses_match_jax(trained):
    np.testing.assert_allclose(trained["losses"], trained["jlosses"],
                               rtol=1e-4)


@pytest.mark.parametrize("field", ["density", "albedo"])
def test_tables_after_first_step_match_jax(trained, field):
    got = getattr(trained["step1"], field).numpy()
    want = getattr(trained["jstep1"], field)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    moved = got != getattr(trained["init"], field).numpy()
    assert moved.any()


def test_wave_train_step_converges(trained):
    losses = trained["losses"]
    assert losses[-1] < losses[0] * 0.97, losses
    assert all(a >= b for a, b in zip(losses, losses[1:])), losses
    assert all(np.isfinite(losses))


def test_step_leaves_its_input_tables(trained):
    """The step returns new tables: the initial ones stay at init."""
    init = trained["init"]
    assert (init.density == 4.0).all()
    fresh = wd.init_params(trained["ws"], init_density=4.0)
    assert torch.equal(init.albedo, fresh.albedo)


def test_render_wave_diff_gives_the_step_loss(trained):
    """render_wave_diff along the frame's rays gives the image whose
    loss the first step reports."""
    W, H, cam5 = trained["W"], trained["H"], trained["cam5"]
    dirs = wd.d_unit(shade.pixel_dirs_device(cam5, W, H))
    col = wd.render_wave_diff(trained["init"], trained["ws"],
                              cam5[0].expand_as(dirs), dirs, 2)
    assert col.shape == (W * H, 3)
    assert float(torch.mean(col ** 2)) == trained["losses"][0]
