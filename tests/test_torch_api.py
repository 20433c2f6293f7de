"""The small API pieces of the port against the JAX package's:
DeviceOctree.packed_table (a cached make_packed_table, Octree.packed_table
in JAX) and its word semantics (tests/test_features.py),
octree.effective_normal_raw, camera.pixel_directions,
render_wave.make_isect (an intersect_octree-shaped callable over the
wavefront engine) and native.available.  Tolerance: none, every result is
equal."""

import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.core import octree as joctree
from svo_raytracer_tpu.runtime import native as jnative
from svo_raytracer_tpu.utils import camera as jcamera
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import render_wave, shade, traverse, wavefront
from svo_raytracer_torch.runtime import native
from svo_raytracer_torch.utils import camera
from test_traverse_batch import random_rays


@pytest.fixture(scope="module")
def scene():
    v = make_sphere_voxels(32)
    v[:, :4, :] = 3
    jt = build_np.build_octree_np(v)
    tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")
    return jt.to_device(), tree


def test_packed_table_matches_jax_and_is_cached(scene):
    jtree, tree = scene
    packed = tree.packed_table()
    assert packed is tree.packed_table()
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jtree.packed_table()))
    assert torch.equal(packed, traverse.make_packed_table(tree))


def test_packed_table_semantics(scene):
    """tests/test_features.py's check on the port: a branch's word holds
    its child base, a leaf's 0; bit 0 is value != 0."""
    _, tree = scene
    packed = tree.packed_table().numpy()
    child, mask, value, _ = (a.numpy() for a in tree.arrays())
    assert packed[0] >> 1 == child[0]
    assert (packed[0] & 1) == int(value[0] != 0)
    for p in np.nonzero(child)[0][:200]:
        for k in range(8):
            ci = child[p] + k
            tag = (mask[p] >> (2 * k)) & 3
            assert packed[ci] >> 1 == (child[ci] if tag == 0 else 0)
            assert (packed[ci] & 1) == int(value[ci] != 0)


def test_effective_normal_raw_matches_jax():
    gen = np.random.default_rng(4)
    tag = gen.integers(0, 4, 1000).astype(np.int32)
    base, mask, normal = (gen.integers(0, 1 << 16, 1000).astype(np.int32)
                          for _ in range(3))
    ref = np.asarray(joctree.effective_normal_raw(tag, base, mask, normal))
    np.testing.assert_array_equal(
        octree.effective_normal_raw(tag, base, mask, normal), ref)
    got = octree.effective_normal_raw(*(torch.from_numpy(a) for a in
                                        (tag, base, mask, normal)))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (64, 40)])
def test_pixel_directions_match_jax(size):
    cam = camera.Camera(pos=np.array([1.2, 1.7, 1.4]))
    cam.rotate(-0.3, 0.8)
    got = camera.pixel_directions(cam.corners(), *size)
    assert got.dtype == np.float32 and got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(
        got, jcamera.pixel_directions(cam.corners(), *size))


def test_make_isect_equals_intersect_wavefront():
    hm, mm = bigworld.fractal_heightmap(64, seed=0)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 64), "cpu")
    o, d = (torch.from_numpy(a) for a in random_rays(512, seed=6))
    act = torch.from_numpy(np.random.default_rng(1).random(512) < 0.8)
    isect = render_wave.make_isect(ws)
    got = isect(o, d, max_depth=3, cone_trace=True, max_iterations=5,
                active=act)
    ref = wavefront.intersect_wavefront(ws, o, d, active=act)
    for f in ref._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert bool(((a == b) | (a.isnan() & b.isnan())).all()), f
    assert 0 < int(got.hit.sum()) < 512
    # as the traversal of the ESVO shading (JAX: parallel/bricks.py)
    px = torch.arange(512, dtype=torch.float32) % 32
    py = torch.div(torch.arange(512), 32, rounding_mode="floor").float()
    col, depth, _ = shade.shade_gi(None, o, d, px, py, 1, gi_bounces=2,
                                   intersect_fn=render_wave.make_isect(ws))
    assert col.shape == (512, 3) and bool(torch.isfinite(col).all())


def test_native_available_matches_jax():
    assert native.available() is True
    assert native.available() == jnative.available()
