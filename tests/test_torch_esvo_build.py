"""The port's octree world against the JAX package's: heightmap chunks voxel
for voxel, the device octree build node for node up to n_nodes (the JAX
build's own cases, tests/test_build_jax.py), and the packed traversal
table word for word.  All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_jax
from svo_raytracer_tpu.models import heightmap as jheightmap
from svo_raytracer_tpu.ops import traverse as jtraverse
from svo_raytracer_torch.core import build_device, octree
from svo_raytracer_torch.models import bigworld, heightmap
from svo_raytracer_torch.ops import traverse


def _heightmap_chunk(size=64, seed=1):
    hm, mm = bigworld.fractal_heightmap(size, seed=seed)
    return heightmap.generate_chunk_heightmap(
        hm, mm, chunk_size=size, height_scale=size // 2,
        device="cpu").numpy()


def _voxels(case):
    if case == "sphere":
        return make_sphere_voxels(32)
    if case == "terrain":
        return make_terrain_voxels(32)
    if case == "checkerboard":
        return (np.indices((16, 16, 16)).sum(0) % 2).astype(np.uint8)
    if case == "empty":
        return np.zeros((16, 16, 16), np.uint8)
    if case == "full":
        return np.ones((16, 16, 16), np.uint8)
    if case == "multi-material":
        v = np.random.default_rng(11).integers(0, 4, (16, 16, 16))
        v[:8] = 0
        v[8:, :8] = 2
        return v.astype(np.uint8)
    if case == "single-voxel":
        v = np.zeros((8, 8, 8), np.uint8)
        v[3, 4, 2] = 5
        return v
    if case == "edge-touching":
        v = np.zeros((16, 16, 16), np.uint8)
        v[0, :, :] = 1
        v[:, 15, :] = 2
        v[7, 0, 15] = 3
        return v
    return _heightmap_chunk()


@pytest.mark.parametrize("origin", [(0, 0, 0), (16, -8, 40)])
def test_heightmap_chunk_matches(origin):
    hm, mm = bigworld.fractal_heightmap(64, seed=1)
    ref = np.asarray(jheightmap.generate_chunk_heightmap(
        jnp.asarray(hm), jnp.asarray(mm), jnp.asarray(origin),
        chunk_size=64, height_scale=32))
    got = heightmap.generate_chunk_heightmap(hm, mm, origin, chunk_size=64,
                                             height_scale=32, device="cpu")
    assert got.dtype == torch.uint8
    assert np.array_equal(ref, got.numpy())
    assert 0.05 < (ref != 0).mean() < 0.95


@pytest.mark.parametrize("case,max_lod", [
    ("sphere", None), ("terrain", None), ("checkerboard", None),
    ("empty", None), ("full", None), ("multi-material", None),
    ("single-voxel", None), ("edge-touching", None), ("heightmap-64", None),
    ("sphere", 3), ("terrain", 4)])
def test_device_build_matches_jax(case, max_lod):
    vox = _voxels(case)
    child, mask, value, normal, n = build_jax.build_octree_jax(
        vox, max_lod=max_lod, capacity=1 << 16)
    n = int(n)
    got = build_device.build_octree_device(torch.from_numpy(vox),
                                           max_lod=max_lod)
    assert got.n_nodes == n
    for name, ref, a in zip(("child", "mask", "value", "normal"),
                            (child, mask, value, normal), got.arrays()):
        assert a.dtype == torch.int32 and a.shape == (n,), name
        assert np.array_equal(np.asarray(ref)[:n], a.numpy()), name


def test_build_from_a_tensor_and_limits():
    vox = torch.from_numpy(make_sphere_voxels(16).astype(np.int64))
    ref = build_device.build_octree_device(
        torch.from_numpy(make_sphere_voxels(16)))
    got = build_device.build_octree_device(vox, world_size=64)
    assert got.world_size == 64 and got.n_nodes == ref.n_nodes
    assert all(torch.equal(a, b) for a, b in zip(ref.arrays(),
                                                 got.arrays()))
    for bad in (np.zeros((8, 8, 4), np.uint8), np.zeros((12,) * 3, np.uint8),
                np.full((8,) * 3, 300)):
        with pytest.raises(ValueError):
            build_device.build_octree_device(torch.from_numpy(bad))
    # 2048^3 would overflow the int32 raster key (a zero-stride view: no
    # memory behind it)
    with pytest.raises(ValueError, match="raster key"):
        build_device.build_octree_device(
            torch.zeros(1, dtype=torch.uint8).expand(2048, 2048, 2048))


@pytest.mark.parametrize("case", ["sphere", "terrain", "heightmap-64"])
def test_packed_table_and_reference_tree(case):
    vox = _voxels(case)
    jt = build_jax.build_octree(vox, capacity=1 << 16)
    ref = np.asarray(jtraverse.make_packed_table(jt.arrays()))[:jt.n_nodes]
    tree = octree.from_reference(
        *(np.asarray(a) for a in jt.arrays()), jt.n_nodes,
        jt.world_size).to_device("cpu")
    assert tree.n_nodes == jt.n_nodes and tree.world_size == vox.shape[0]
    got = traverse.make_packed_table(tree)
    assert got.dtype == torch.int32 and np.array_equal(ref, got.numpy())
    dev = build_device.build_octree_device(torch.from_numpy(vox))
    assert torch.equal(traverse.make_packed_table(dev), got)
    with pytest.raises(ValueError):
        octree.from_reference(*(np.asarray(a)[:4] for a in jt.arrays()),
                              jt.n_nodes, jt.world_size)
