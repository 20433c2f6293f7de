"""Port scene tables (svo_raytracer_torch) vs the JAX package: the brick
decomposition, the heightmap builder and the wavefront tables must equal
the reference arrays exactly."""

import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.models import bigworld as jbigworld
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import brick_scene, wavefront

BRICK_FIELDS = ("l0_table", "brick_slot", "brick_attr", "occ_words", "attrs")


def _assert_bricks_equal(ref, got):
    assert (ref.world_size, ref.grid_size, ref.n_mixed) == (
        got.world_size, got.grid_size, got.n_mixed)
    for f in BRICK_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _assert_wave_equal(ref, got):
    assert (ref.world_size, ref.grid_size, ref.n_mixed, ref.capacity) == (
        got.world_size, got.grid_size, got.n_mixed, got.capacity)
    for f in wavefront.WaveScene.ARRAYS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("scene", ["sphere-64", "terrain-64"])
def test_brickify_and_prepare_match(scene):
    vox = (make_sphere_voxels(64, radius=24) if scene == "sphere-64"
           else make_terrain_voxels(64, seed=7))
    tree = build_np.build_octree_np(vox)
    ref, got = jbrick_scene.brickify(tree), brick_scene.brickify(tree)
    _assert_bricks_equal(ref, got)
    _assert_wave_equal(jwavefront.prepare(ref), wavefront.prepare(got, "cpu"))


@pytest.mark.parametrize("size", [256, 512])
def test_heightmap_scene_matches(size):
    """256^3 is G = 8 (one supercell, so its distance nibble is 0 in any
    non-empty world); 512^3 is the smallest world with nonzero supercell
    nibbles, which the traversal's jump reads."""
    hm, mm = bigworld.fractal_heightmap(size, seed=3)
    ref = jbigworld.heightmap_brick_scene(hm, mm, size)
    got = bigworld.heightmap_brick_scene(hm, mm, size)
    _assert_bricks_equal(ref, got)
    ws = wavefront.prepare(got, "cpu")
    _assert_wave_equal(jwavefront.prepare(ref), ws)
    if size == 512:
        assert (ws.l0_sc != 0).any()


def test_from_reference_equals_prepare():
    tree = build_np.build_octree_np(make_terrain_voxels(64, seed=7))
    jws = jwavefront.prepare(jbrick_scene.brickify(tree))
    arrays = {f: np.asarray(getattr(jws, f))
              for f in wavefront.WaveScene.ARRAYS}
    meta = {k: getattr(jws, k) for k in ("world_size", "grid_size",
                                        "n_mixed", "capacity", "attr16")}
    got = wavefront.WaveScene.from_reference(arrays, meta, "cpu")
    want = wavefront.prepare(brick_scene.brickify(tree), "cpu")
    assert got.device == torch.device("cpu")
    _assert_wave_equal(jws, got)
    _assert_wave_equal(jws, want)


def test_unported_layouts_raise():
    """Layouts the JAX package rejects, the port rejects with ValueError,
    before reading any array: G > 256, a paged grid of partial pages, and
    a G = 64 world whose slot capacity passes 15 bits."""

    class Scene:
        def __init__(self, G, n_mixed=1):
            self.grid_size, self.world_size, self.n_mixed = G, G * 32, n_mixed

    # capacity = n_mixed + max(64, n_mixed // 8) passes 2^15 from 29128 on
    for scene in (Scene(512), Scene(96), Scene(64, n_mixed=29128)):
        with pytest.raises((ValueError, AssertionError)):
            jwavefront.prepare(scene)
        with pytest.raises(ValueError):
            wavefront.prepare(scene, "cpu")
        with pytest.raises(ValueError):
            wavefront.WaveScene.from_reference(
                {}, dict(world_size=scene.world_size,
                         grid_size=scene.grid_size, n_mixed=scene.n_mixed,
                         capacity=scene.n_mixed + max(64,
                                                      scene.n_mixed // 8)),
                "cpu")
    # the largest G = 64 capacity still passes the check
    wavefront._check_layout(64, (1 << 15) - 1)
