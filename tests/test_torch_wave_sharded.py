"""The port's row-sharded wavefront render and K-hit train step
(svo_raytracer_torch.parallel.render_wave_sharded,
diff/wave_diff.make_wave_sharded_train_step) over 4 gloo ranks on the CPU
(K1's plain version; tests/torch_ranks.job_wave), on
tests/test_wave_sharded.py's terrain-64 (seed 7) and camera at 32x32.

* _shard_rays equals the JAX package's (called eagerly) bit for bit, for
  contiguous bands and interleaved rows, at 32x32 and 1920x1080;
* modes 3 and 0 (gi-1), interleaved and banded, and mode 2 interleaved,
  against the port's single-process render_frame_wavefront at
  test_wave_sharded.py's bar: pixels within 1e-5 on >= 0.999 of them
  (the rays are the same but for the last bit of a few directions:
  the single-process frame divides by the kernel's root,
  wavefront.unit_rows, the sharded one as JAX's jnp.linalg.norm), with
  n_left 0;
* the K = 2 train step against the port's single-process
  make_wave_train_step (loss rtol 1e-5, parameters atol 1e-5), every
  rank holding the same parameters.

Slow-marked, as the JAX package marks its own: mode 3 against JAX's
make_wave_sharded_render and the train step against JAX's
make_wave_sharded_train_step on its tile_mesh(4) (interpret mode).  Mode
0 is not held to JAX's sharded frame: it draws its random in jitted
code, where XLA fuses the sin hash's argument."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.parallel import render_wave_sharded as jrws
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.diff import render_diff as rd
from svo_raytracer_torch.diff import wave_diff as wd
from svo_raytracer_torch.ops import brick_scene, render_wave, shade
from svo_raytracer_torch.ops import wavefront
from svo_raytracer_torch.parallel import render_wave_sharded as rws
from svo_raytracer_torch.utils.camera import Camera

W = H = 32
LR = 100.0
CASES = ((3, True), (3, False), (0, True), (0, False), (2, True))


def _camera():
    cam = Camera(pos=np.array([1.4, 1.7, 1.3]))
    cam.rotate(-0.5, 0.8)
    return cam.uniform().astype(np.float32)


@pytest.mark.parametrize("size,rows,row0,stride", [
    ((32, 32), 8, 0, 1), ((32, 32), 8, 16, 1), ((32, 32), 8, 1, 4),
    ((32, 32), 8, 3, 4), ((1920, 1080), 270, 3, 4)])
def test_shard_rays_equal_jax(size, rows, row0, stride):
    width, height = size
    cam5 = _camera()
    got = rws._shard_rays(torch.from_numpy(cam5), width, height, rows, row0,
                          stride)
    want = jrws._shard_rays(jnp.asarray(cam5), width, height, rows,
                            jnp.asarray(row0, jnp.int32), stride)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def scene():
    jt = jbuild_np.build_octree_np(make_terrain_voxels(64, seed=7))
    tree = (jt.child, jt.mask, jt.value, jt.normal, jt.n_nodes,
            jt.world_size)
    ws = wavefront.prepare(brick_scene.brickify(octree.from_reference(
        *tree)), "cpu")
    return dict(jt=jt, tree=tree, ws=ws, cam5=torch.from_numpy(_camera()))


@pytest.fixture(scope="module")
def run(scene, tmp_path_factory):
    ws, cam5 = scene["ws"], scene["cam5"]
    dirs = rd.d_unit(shade.pixel_dirs_device(cam5, W, H))
    target = 0.8 * wd.render_wave_diff(wd.init_params(ws), ws,
                                       cam5[0].expand_as(dirs), dirs,
                                       2).reshape(H, W, 3)
    inp = dict(tree=tuple(torch.from_numpy(np.array(a)) if i < 4 else a
                          for i, a in enumerate(scene["tree"])),
               cam5=cam5, size=(W, H), lr=LR, target=target)
    d = tmp_path_factory.mktemp("wave")
    torch.save(inp, d / "in.pt")
    return dict(ranks=torch_ranks.run_ranks(torch_ranks.job_wave, 4, d),
                target=target)


@pytest.mark.parametrize("mode,interleave", CASES)
def test_wave_sharded_matches_single(scene, run, mode, interleave):
    col, n_left = run["ranks"][0][(mode, interleave)]
    assert n_left == 0
    ref, _, _ = render_wave.render_frame_wavefront(
        scene["ws"], scene["cam5"], W, H, render_mode=mode, frame_number=1,
        gi_bounces=1)
    a, b = col.numpy(), ref.numpy()
    assert a.shape == b.shape == (H, W, 3)
    frac = (np.abs(a - b) <= 1e-5).mean()
    assert frac >= 0.999, frac
    assert 0.1 < (b.sum(-1) != 0).mean()


def test_wave_sharded_train_step_matches_single(scene, run):
    step = wd.make_wave_train_step(scene["ws"], W, H, K=2, lr=LR)
    p, loss = step(wd.init_params(scene["ws"]), scene["cam5"], run["target"])
    got = run["ranks"][0]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    for f in ("albedo", "density"):
        np.testing.assert_allclose(got[f].numpy(), getattr(p, f).numpy(),
                                   atol=1e-5)
    assert bool((got["density"] != wd.init_params(scene["ws"]).density)
                .any())


def test_ranks_hold_the_same_results(run):
    first = run["ranks"][0]
    for other in run["ranks"][1:]:
        for k in CASES:
            assert torch.equal(other[k][0], first[k][0]), k
            assert other[k][1] == first[k][1]
        for k in ("albedo", "density", "loss"):
            assert torch.equal(other[k], first[k]), k


def _jax_scene(scene):
    from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
    from svo_raytracer_tpu.ops import wavefront as jwavefront
    return jwavefront.prepare(jbrick_scene.brickify(scene["jt"]))


@pytest.mark.slow
def test_wave_sharded_matches_jax(scene, run):
    from svo_raytracer_tpu.parallel import mesh as jmesh
    jws = _jax_scene(scene)
    m = jmesh.tile_mesh(4)
    cam5 = jnp.asarray(scene["cam5"].numpy())
    scheds = jrws.discover_schedules(jws, cam5, W, H, m, render_mode=3,
                                     gi_bounces=0, interpret=True)
    render = jrws.make_wave_sharded_render(m, jws, W, H, scheds,
                                           render_mode=3, gi_bounces=0,
                                           interpret=True)
    want, n_left = render(jrws._warrays(jws), cam5, 1)
    assert int(n_left) == 0
    got = run["ranks"][0][(3, True)][0].numpy()
    assert (np.abs(got - np.asarray(want)) <= 1e-5).mean() >= 0.999


@pytest.mark.slow
def test_wave_sharded_train_step_matches_jax(scene, run):
    from svo_raytracer_tpu.diff import wave_diff as jwd
    from svo_raytracer_tpu.parallel import mesh as jmesh
    jws = _jax_scene(scene)
    step = jwd.make_wave_sharded_train_step(jmesh.tile_mesh(4), jws, W, H,
                                            K=2, lr=LR, interpret=True)
    p, loss = step(jwd.init_params(jws), jrws._warrays(jws),
                   jnp.asarray(scene["cam5"].numpy()),
                   jnp.asarray(run["target"].numpy()))
    got = run["ranks"][0]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    for f in ("albedo", "density"):
        np.testing.assert_allclose(got[f].numpy(), np.asarray(getattr(p, f)),
                                   atol=1e-5)
