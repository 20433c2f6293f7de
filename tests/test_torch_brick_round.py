"""The port's v1 brick engine (ops/brick_pallas.py, kernel K3's plain
version on the CPU) against the JAX package's intersect_bricks_tpu
(Pallas kernel in interpret mode) and its XLA reference
brick_trace.intersect_bricks, at tests/test_brick_pallas.py's floors: hit
agreement >= 0.995, and value, depth, t (2e-4) and normal (1e-5) equal on
>= 98% of common hits.  JAX rays that overflow a bin's padding lose a
round, so only the port's per-ray answer is schedule-free.  Measured: hit
agreement 1.0 and every common hit strict against both."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_pallas as jbrick_pallas
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import brick_trace as jbrick_trace
from svo_raytracer_tpu.ops import shade as jshade
from svo_raytracer_tpu.utils.camera import Camera
from svo_raytracer_torch.ops import brick_pallas, brick_scene, shade
from test_traverse_batch import random_rays

SCENES = {"sphere-64": (lambda: make_sphere_voxels(64, radius=24), 11),
          "terrain-64": (lambda: make_terrain_voxels(64, seed=7), 12)}


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX device scene, port CPU scene)."""
    out = {}
    for name, (vox, _) in SCENES.items():
        tree = build_np.build_octree_np(vox())
        out[name] = (jbrick_scene.brickify(tree).to_device(),
                     brick_scene.brickify(tree).to_device("cpu"))
    return out


def _numpy(res):
    return {k: np.asarray(v) for k, v in res._asdict().items()}


def _agreement(ref, got):
    """(hit agreement, strict share of common hits), as
    tests/test_brick_pallas.py _compare."""
    both = ref["hit"] & got["hit"]
    strict = ((ref["value"] == got["value"]) & (ref["depth"] == got["depth"])
              & (np.abs(ref["t"] - got["t"]) <= 2e-4)
              & (np.abs(ref["normal"] - got["normal"]).max(-1) <= 1e-5))
    return (ref["hit"] == got["hit"]).mean(), strict[both].mean()


@pytest.mark.parametrize("name", SCENES)
def test_matches_jax(scenes, name):
    jscene, scene = scenes[name]
    o, d = random_rays(192, seed=SCENES[name][1])
    got = _numpy(brick_pallas.intersect_bricks_tpu(
        scene, torch.from_numpy(o), torch.from_numpy(d)))
    refs = {"intersect_bricks_tpu": jbrick_pallas.intersect_bricks_tpu(
                jscene, jnp.asarray(o), jnp.asarray(d), interpret=True),
            "intersect_bricks": jbrick_trace.intersect_bricks(
                jscene, jnp.asarray(o), jnp.asarray(d))}
    for ref_name, ref in refs.items():
        agree, strict = _agreement(_numpy(ref), got)
        print(f"{name} vs {ref_name}: hit agreement {agree:.4f}, strict "
              f"{strict:.4f}")
        assert agree >= 0.995, ref_name
        assert strict >= 0.98, ref_name
    assert 0 < got["hit"].sum() < 192


def test_active_mask_and_nan(scenes):
    _, scene = scenes["sphere-64"]
    o = torch.tensor([[0.5, 1.5, 1.5], [np.nan, 1.5, 1.5], [0.5, 1.5, 1.5]])
    d = torch.tensor([[1.0, 0.0, 0.0]] * 3)
    res = brick_pallas.intersect_bricks_tpu(
        scene, o, d, active=torch.tensor([True, True, False]))
    assert res.hit.tolist() == [True, False, False]
    assert res.iters.tolist()[1:] == [0, 0]


def test_max_rounds_cutoff(scenes):
    """Rays still pending after max_rounds rounds are misses; rays done by
    then are the same as with every round."""
    _, scene = scenes["terrain-64"]
    o, d = (torch.from_numpy(a) for a in random_rays(512, seed=13))
    full = brick_pallas.intersect_bricks_tpu(scene, o, d)
    cut = brick_pallas.intersect_bricks_tpu(scene, o, d, max_rounds=2)
    lost = full.hit & ~cut.hit
    assert lost.any()
    assert not (cut.hit & ~full.hit).any()
    kept = cut.hit
    for field in ("t", "value", "depth", "iters"):
        assert torch.equal(getattr(cut, field)[kept],
                           getattr(full, field)[kept]), field
    assert (cut.iters[lost] < full.iters[lost]).all()


def test_grid_limit():
    scene = brick_scene.BrickScene(world_size=2048, grid_size=64, n_mixed=0,
                                   l0_table=None, brick_slot=None,
                                   brick_attr=None, occ_words=None,
                                   attrs=None)
    with pytest.raises(ValueError, match="32"):
        brick_pallas.intersect_bricks_tpu(scene, torch.zeros(1, 3),
                                          torch.ones(1, 3))


@pytest.mark.parametrize("name", SCENES)
def test_to_device_tables_equal_jax(scenes, name):
    jscene, scene = scenes[name]
    for field in brick_scene.BrickScene.ARRAYS:
        a, b = np.asarray(getattr(jscene, field)), getattr(scene, field)
        assert b.dtype == torch.int32 and b.is_contiguous(), field
        assert np.array_equal(a, b.numpy()), field
    assert (scene.world_size, scene.grid_size, scene.n_mixed) == (
        jscene.world_size, jscene.grid_size, jscene.n_mixed)


def test_shade_direct_through_k3_matches_jax(scenes):
    """A 64x40 render-mode-2 frame (primary and shadow segments) through
    shade.shade_direct with K3's engine as intersect_fn, against JAX's
    with its interpret-mode intersect_bricks_tpu, on the same rays.
    Floor (tests/test_torch_render.py): colour within 2e-3 on >= 97% of
    pixels, depth on >= 97%."""
    jscene, scene = scenes["terrain-64"]
    cam = Camera(pos=np.array([1.3, 1.62, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    dun = jshade.pixel_dirs_device(cam5, 64, 40)
    dirs = np.asarray(dun / jnp.linalg.norm(dun, axis=-1, keepdims=True))
    origins = np.broadcast_to(np.asarray(cam5[0]), dirs.shape).copy()
    ref = jshade.shade_direct(
        None, jnp.asarray(origins), jnp.asarray(dirs),
        intersect_fn=functools.partial(jbrick_pallas.intersect_bricks_tpu,
                                       jscene, interpret=True))
    got = shade.shade_direct(
        None, torch.from_numpy(origins), torch.from_numpy(dirs),
        intersect_fn=functools.partial(brick_pallas.intersect_bricks_tpu,
                                       scene))
    (rc, rd, ri), (gc, gd, gi) = (tuple(np.asarray(a) for a in ref),
                                  tuple(a.numpy() for a in got))
    close = np.abs(rc - gc).max(-1) <= 2e-3
    depth = np.abs(rd - gd) <= 2e-3
    print(f"mode 2 through K3: colour {close.mean():.4f} depth "
          f"{depth.mean():.4f} iters {(ri == gi).mean():.4f}")
    assert close.mean() >= 0.97
    assert depth.mean() >= 0.97
    assert 0.02 < (gd > 0).mean() < 0.98
