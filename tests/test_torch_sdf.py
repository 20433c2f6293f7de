"""The port's SDF brushes and octree editor (svo_raytracer_torch/core/sdf.py)
against the JAX package's, on the eight scenarios of tests/test_sdf_edit.py
and a chained pair of edits at the viewer's default max_lod: the edited
node tables are equal exactly, and so are the brushes' distances and
normals and the mathutil helpers they use.  The ChangeBounds windows are
equal too, except where a brush fully contains a branch: the JAX
package's existing-node window leaves out the tombstoned children it
writes, the port's covers them.  Every slot an edit writes lies in one of
the port's windows, in every scenario."""

import numpy as np
import pytest
import torch

from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.core import sdf as jsdf
from svo_raytracer_tpu.ops import traverse as jtraverse
from svo_raytracer_tpu.utils import mathutil as jmathutil
from svo_raytracer_torch.core import build_np, sdf
from svo_raytracer_torch.ops import traverse
from svo_raytracer_torch.utils import constants as C
from svo_raytracer_torch.utils import mathutil


def _flat_world():
    v = np.zeros((32, 32, 32), np.uint8)
    v[:, :8, :] = 1
    return v


def _solid16():
    return np.ones((16, 16, 16), np.uint8)


# name -> (voxels, brush maker (module -> brush), value, max_lod);
# the scenarios of tests/test_sdf_edit.py in its order
SCENARIOS = {
    "add_sphere": (_flat_world, lambda m: m.Sphere((16, 16, 16), 6), 2, 5),
    "subtract_sphere": (_flat_world, lambda m: m.Sphere((16, 7, 16), 4), 0,
                        5),
    "edit_traversal": (_flat_world, lambda m: m.Sphere((16, 20, 16), 5), 3,
                       5),
    "noop_outside": (_flat_world, lambda m: m.Sphere((1000, 1000, 1000), 5),
                     1, 5),
    "same_value_paint": (_solid16, lambda m: m.Sphere((8, 8, 8), 3), 1, 4),
    "tombstones": (_flat_world, lambda m: m.Sphere((16, 0, 16), 26), 2, 5),
    "box_inert": (_flat_world, lambda m: m.Box((16, 12, 16), 5, 3, 4), 2, 5),
    "dirty_ranges": (_flat_world, lambda m: m.Sphere((16, 10, 16), 5), 2, 5),
}


def _assert_tree_equal(jt, pt):
    assert jt.n_nodes == pt.n_nodes and jt.world_size == pt.world_size
    for name in ("child", "mask", "value", "normal"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jt, name))[:jt.n_nodes],
            np.asarray(getattr(pt, name))[:pt.n_nodes], err_msg=name)


def _edit_both(voxels, make, value, max_lod):
    jt0, pt0 = jbuild_np.build_octree_np(voxels), build_np.build_octree_np(
        voxels)
    _assert_tree_equal(jt0, pt0)
    jt, jcb = jsdf.use_sdf_brush(jt0, make(jsdf), value, max_lod=max_lod)
    pt, pcb = sdf.use_sdf_brush(pt0, make(sdf), value, max_lod=max_lod)
    _assert_tree_equal(jt, pt)
    assert (jcb.start1, jcb.end1) == (pcb.start1, pcb.end1)
    # every slot the edit wrote lies in one of the port's windows
    for a, b in zip(pt0.arrays(), pt.arrays()):
        diff = np.nonzero(a[:pt0.n_nodes] != b[:pt0.n_nodes])[0]
        assert ((diff >= pcb.start0) & (diff < pcb.end0)).all()
    return pt0, pt, pcb, jt, jcb


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_edit_equals_jax(name):
    voxels, make, value, max_lod = SCENARIOS[name]
    t0, t, cb, jt, jcb = _edit_both(voxels(), make, value, max_lod)
    vals = t.value[:t.n_nodes]
    if name == "tombstones":
        # JAX's window leaves out the tombstoned children (40 value
        # writes here); the port's covers them
        outside = np.nonzero((vals[:t0.n_nodes] != t0.value)
                             & ~((np.arange(t0.n_nodes) >= jcb.start0)
                                 & (np.arange(t0.n_nodes) < jcb.end0)))[0]
        assert len(outside) and (vals[outside] == C.DELETE_VALUE).all()
        assert cb.start0 <= jcb.start0 and cb.end0 > jcb.end0
    else:
        assert (cb.start0, cb.end0) == (jcb.start0, jcb.end0)
    if name == "add_sphere":
        assert t.n_nodes > t0.n_nodes and cb.end1 == t.n_nodes
    elif name in ("noop_outside", "same_value_paint"):
        assert t.n_nodes == t0.n_nodes
    elif name == "tombstones":
        assert (vals == C.DELETE_VALUE).any()
    elif name == "dirty_ranges":
        assert t.n_nodes == cb.end1
    elif name == "edit_traversal":
        o = np.asarray([[1.5, 1.95, 1.5]], np.float32)
        d = np.asarray([[0.0, -1.0, 0.0]], np.float32)
        ref = jtraverse.intersect_octree(jt.to_device().arrays(), o, d)
        got = traverse.intersect_octree(t.to_device("cpu"),
                                        torch.from_numpy(o),
                                        torch.from_numpy(d))
        assert bool(got.hit[0]) and int(got.value[0]) == 3
        assert float(got.t[0]) == float(np.asarray(ref.t)[0])
        assert int(got.value[0]) == int(np.asarray(ref.value)[0])


def test_chained_edits_at_default_lod():
    """Two edits in a row on terrain at the viewer's max_lod (13): the
    editor appends past the first edit's growth."""
    v = make_terrain_voxels(32, seed=3)
    jt, pt = jbuild_np.build_octree_np(v), build_np.build_octree_np(v)
    for center, r, value in (((10, 14, 12), 4, 1), ((12, 12, 12), 5, 0)):
        jt, jcb = jsdf.use_sdf_brush(jt, jsdf.Sphere(center, r), value)
        pt, pcb = sdf.use_sdf_brush(pt, sdf.Sphere(center, r), value)
        _assert_tree_equal(jt, pt)
        assert vars(jcb) == vars(pcb)     # no full containment here


def test_brushes_and_mathutil_equal_jax():
    gen = np.random.default_rng(0)
    pts = gen.integers(-4, 40, (200, 3))
    for make in (lambda m: m.Sphere((16, 12, 9), 7),
                 lambda m: m.Box((16, 12, 16), 5, 3, 4)):
        jb, pb = make(jsdf), make(sdf)
        np.testing.assert_array_equal(jb.min, pb.min)
        np.testing.assert_array_equal(jb.max, pb.max)
        for p in pts:
            assert jb.distance(p) == pb.distance(p)
            for out in (True, False):
                assert jb.normal(p, out) == pb.normal(p, out)
    for raw in range(0, 1000, 7):
        np.testing.assert_array_equal(jmathutil.unpack_normal(raw),
                                      mathutil.unpack_normal(raw))
    for n in gen.normal(size=(50, 3)):
        u = n / np.linalg.norm(n)
        assert jmathutil.pack_normal(u) == mathutil.pack_normal(u)
        np.testing.assert_array_equal(jmathutil.normalize(n),
                                      mathutil.normalize(n))
    w = gen.uniform(0.9, 2.1, (50, 3))
    np.testing.assert_array_equal(jmathutil.to_voxel_space(w, 1024),
                                  mathutil.to_voxel_space(w, 1024))
    for a, b in gen.integers(0, 9, (40, 2, 3)):
        args = (a, a + 2, b, b + 3)
        assert jmathutil.intersect_aabb(*args) == mathutil.intersect_aabb(
            *args)
    for i in range(8):
        np.testing.assert_array_equal(jmathutil.child_offset(i),
                                      mathutil.child_offset(i))
