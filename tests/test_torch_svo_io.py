"""The port's .svo codec, node-table validation, ByteCache and material
registry against the JAX package's.

The port's Python codec (core/svo_format.export_svo / import_svo, the
plain version) writes the JAX package's bytes and reads its arrays, on
sphere, terrain and SDF-edited trees (tombstones, subdividable leaves);
the native codec (runtime/native.py over csrc/svo_codec.cc, built with
the host C++ compiler) equals the Python codec both ways; truncated
input raises; a file written and read through the native codec round
trips.  All exact."""

import struct

import numpy as np
import pytest

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import bytecache as jbytecache
from svo_raytracer_tpu.core import materials as jmaterials
from svo_raytracer_tpu.core import svo_format as jsvo_format
from svo_raytracer_tpu.core import validate as jvalidate
from svo_raytracer_torch.core import build_np, bytecache, materials, octree
from svo_raytracer_torch.core import sdf, svo_format, validate
from svo_raytracer_torch.runtime import native


def _edited(size=32):
    v = make_terrain_voxels(size, seed=5)
    t, _ = sdf.use_sdf_brush(build_np.build_octree_np(v),
                             sdf.Sphere((12, 10, 12), 9), 2)
    t, _ = sdf.use_sdf_brush(t, sdf.Sphere((14, 6, 14), 11), 0)
    return t


TREES = {
    "sphere": lambda: build_np.build_octree_np(make_sphere_voxels(32)),
    "terrain": lambda: build_np.build_octree_np(make_terrain_voxels(32)),
    "edited": _edited,
}


def _jax_tree(t):
    """The same node table as the JAX package's Octree."""
    from svo_raytracer_tpu.core.octree import Octree
    return Octree(child=t.child.copy(), mask=t.mask.copy(),
                  value=t.value.copy(), normal=t.normal.copy(),
                  n_nodes=t.n_nodes, world_size=t.world_size)


def _assert_arrays_equal(a, b):
    assert a.n_nodes == b.n_nodes and a.world_size == b.world_size
    for x, y in zip(a.arrays(), b.arrays()):
        np.testing.assert_array_equal(np.asarray(x)[:a.n_nodes],
                                      np.asarray(y)[:b.n_nodes])


@pytest.mark.parametrize("name", list(TREES))
def test_python_codec_equals_jax(name):
    t = TREES[name]()
    data = svo_format.export_svo(t)
    assert data == jsvo_format.export_svo(_jax_tree(t))
    _assert_arrays_equal(svo_format.import_svo(data, world_size=32),
                         jsvo_format.import_svo(data, world_size=32))


@pytest.mark.parametrize("name", list(TREES))
def test_native_codec_equals_python(name):
    t = TREES[name]()
    data = native.export_svo(t)
    assert data == svo_format.export_svo(t)
    _assert_arrays_equal(native.import_svo(data, world_size=32),
                         svo_format.import_svo(data, world_size=32))
    # a device table exports the same bytes
    assert native.export_svo(t.to_device("cpu", pad_to=t.n_nodes + 40)) \
        == data


def test_truncated_input_raises():
    data = native.export_svo(TREES["sphere"]())
    for cut in (3, 20, len(data) // 2):
        with pytest.raises(ValueError):
            native.import_svo(data[:cut])


def test_file_round_trip(tmp_path):
    t = TREES["edited"]()
    path = str(tmp_path / "level1.svo")
    svo_format.write_svo_file(t, path)
    raw = open(path, "rb").read()
    (length,) = struct.unpack(">i", raw[:4])
    assert length == len(raw) - 4
    back = svo_format.read_svo_file(path, world_size=32)
    assert svo_format.export_svo(back) == svo_format.export_svo(t)
    # the JAX package reads the port's file into the same arrays
    _assert_arrays_equal(back, jsvo_format.read_svo_file(path,
                                                         world_size=32))
    with open(path, "r+b") as f:
        f.truncate(len(raw) - 5)
    with pytest.raises(ValueError):
        svo_format.read_svo_file(path, world_size=32)


def _corrupt(t, kind):
    child = t.child.copy()
    if kind == "range":
        child[int(np.nonzero(child)[0][-1])] = t.n_nodes + 100
    elif kind == "shared":
        br = np.nonzero(child)[0]
        child[br[-1]] = child[br[-2]]
    return octree.Octree(child, t.mask.copy(), t.value.copy(),
                         t.normal.copy(), t.n_nodes, t.world_size)


@pytest.mark.parametrize("kind", ["ok", "range", "shared"])
def test_validate_equals_jax(kind):
    t = _corrupt(TREES["edited"](), kind)
    got = validate.validate_tree(t)
    ref = jvalidate.validate_tree(_jax_tree(t))
    assert (got.ok, got.n_nodes, got.reachable, got.errors) == (
        ref.ok, ref.n_nodes, ref.reachable, ref.errors)
    assert got.ok == (kind == "ok")


def test_octree_accessors_equal_jax():
    from svo_raytracer_tpu.core import octree as joctree
    for make in TREES.values():
        t = make()
        j = _jax_tree(t)
        assert t.node_counts() == j.node_counts()
        assert t.capacity == j.capacity
        for p in range(0, t.n_nodes, 97):
            for k in range(8):
                assert (t.child_tag(p, k), t.child_index(p, k)) == (
                    j.child_tag(p, k), j.child_index(p, k))
    e, je = octree.empty(16, 64), joctree.empty(16, 64)
    _assert_arrays_equal(e, je)
    assert e.capacity == je.capacity == 16


def test_bytecache_and_materials_equal_jax():
    a, b = bytecache.ByteCache(3), jbytecache.ByteCache(3)
    for v in (1, 1, 1, 2, -7, 5, 9):
        a.append_byte(v)
        b.append_byte(v)
        assert a.get_first() == b.get_first() and a.start == b.start
    np.testing.assert_array_equal(a.get_buffer(), b.get_buffer())
    materials.init_materials("./assets")
    jmaterials.init_materials("./assets")
    assert materials.get_num_mats() == jmaterials.get_num_mats() == 4
    for i in range(6):
        m, j = materials.get_material(i), jmaterials.get_material(i)
        assert (m is None) == (j is None)
        if m is not None:
            assert (m.value, m.name, m.type, m.matmap_file_path,
                    m.has_matmap()) == (j.value, j.name, j.type,
                                        j.matmap_file_path, j.has_matmap())
