"""The port's own octree builder and camera (svo_raytracer_torch.core,
.utils) against the JAX package's: node tables and cam5 uniforms equal."""

import numpy as np
import pytest

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.utils.camera import Camera as JCamera
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.utils.camera import Camera


@pytest.mark.parametrize("scene", [
    "sphere-64", "terrain-64", "terrain-32", "empty-32"])
def test_build_octree_np_matches(scene):
    kind, size = scene.split("-")
    size = int(size)
    vox = {"sphere": lambda: make_sphere_voxels(size, radius=size * 3 // 8),
           "terrain": lambda: make_terrain_voxels(size, seed=7),
           "empty": lambda: np.zeros((size,) * 3, np.uint8)}[kind]()
    ref = jbuild_np.build_octree_np(vox)
    got = build_np.build_octree_np(vox)
    assert (ref.n_nodes, ref.world_size) == (got.n_nodes, got.world_size)
    for f in ("child", "mask", "value", "normal"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_build_octree_np_rejects_bad_grids():
    with pytest.raises(ValueError):
        build_np.build_octree_np(np.zeros((8, 8, 4), np.uint8))
    with pytest.raises(ValueError):
        build_np.build_octree_np(np.zeros((12, 12, 12), np.uint8))


@pytest.mark.parametrize("pos,turns", [
    ((1.5, 1.5, 2.0), []),
    ((1.2, 1.1496, 1.8), [(-0.35, 0.4)]),
    ((1.3, 1.62, 1.3), [(-0.5, 0.7), (-2.0, 7.0)]),   # pitch clamps, yaw wraps
])
def test_camera_uniform_matches(pos, turns):
    ref, got = JCamera(pos=np.array(pos)), Camera(pos=np.array(pos))
    for dp, dy in turns:
        ref.rotate(dp, dy)
        got.rotate(dp, dy)
    assert (ref.pitch, ref.yaw) == (got.pitch, got.yaw)
    a, b = ref.uniform(), got.uniform()
    assert a.dtype == b.dtype and np.array_equal(a, b)
