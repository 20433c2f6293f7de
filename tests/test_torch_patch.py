"""Incremental scene edits of the port (brick_scene.brickify_patch and
wavefront.apply_patch) against the JAX package's, on the CPU.

  * brickify_patch on the two edits of tests/test_brick_patch.py gives
    JAX's ScenePatch and host BrickScene, field for field;
  * apply_patch gives JAX's WaveScene arrays, on a G = 2 terrain scene
    and a G = 64 scene (a 64^3 terrain placed in a 2048^3 world);
    ``slot_cell`` is compared on the live slots [0, n_mixed) only;
  * where the JAX package prepares in full (a patch past the capacity,
    paged, attr16 and 2-D scenes) so does the port, and the result
    equals a fresh prepare and JAX's;
  * the reference's slot_cell hazard: JAX scatters a cell that turned
    uniform into slot_cell[capacity - 1]; the port writes nothing there;
  * rays through a patched scene equal rays through a full re-prepare of
    the edited tree in hit, value, t, normal and depth.
All exact."""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import sdf as jsdf
from svo_raytracer_tpu.core.octree import Octree as JOctree
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.core import build_np, sdf
from svo_raytracer_torch.core.octree import Octree
from svo_raytracer_torch.ops import brick_scene, wavefront
from svo_raytracer_torch.utils import constants as C

SCENE_FIELDS = ("n_mixed", "l0_table", "brick_slot", "brick_attr",
                "occ_words", "attrs")
PATCH_FIELDS = ("cells", "cell_slot", "cell_attr", "upd_slots", "occ_rows",
                "attr_rows", "n_mixed")


def embed(tree, levels):
    """``tree`` placed at the low corner of a world 2^levels times wider:
    a chain of branches whose other seven children are air leaves (NumPy
    arrays: (child, mask, value, normal, n_nodes))."""
    top = 8 + 8 * levels
    off = top - 8
    n = top + tree.n_nodes - 8
    child, mask, value, normal = (np.zeros(n, np.int32) for _ in range(4))
    air = sum(C.TAG_NON_SURFACE_LEAF << (2 * k) for k in range(1, 8))
    value[0], parent = 1, 0
    for lvl in range(levels):
        base = 8 + 8 * lvl
        child[parent], mask[parent], value[base] = base, air, 1
        parent = base
    t = [np.asarray(a) for a in (tree.child, tree.mask, tree.value,
                                 tree.normal)]
    child[top:] = np.where(t[0][8:] > 0, t[0][8:] + off, 0)
    mask[top:], value[top:], normal[top:] = t[1][8:], t[2][8:], t[3][8:]
    child[parent] = t[0][0] + off if t[0][0] else 0
    mask[parent], value[parent] = t[1][0], t[2][0]
    return child, mask, value, normal, n


def trees(voxels, levels=0):
    """(JAX Octree, port Octree) of the voxels, embedded ``levels`` deep."""
    t = build_np.build_octree_np(voxels)
    ws = voxels.shape[0] << levels
    a = embed(t, levels)
    return (JOctree(*(x.copy() for x in a[:4]), n_nodes=a[4], world_size=ws),
            Octree(*a[:4], n_nodes=a[4], world_size=ws))


def edit_both(jt, pt, value, center, radius):
    jt, _ = jsdf.use_sdf_brush(jt, jsdf.Sphere(np.asarray(center), radius),
                               value)
    ball = sdf.Sphere(np.asarray(center), radius)
    pt, _ = sdf.use_sdf_brush(pt, ball, value)
    return jt, pt, ball


def assert_fields_equal(a, b, fields, what):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{what}.{f}")


def assert_wave_equal(jws, ws):
    assert (jws.n_mixed, jws.capacity, jws.attr16, jws.grid_size) == (
        ws.n_mixed, ws.capacity, ws.attr16, ws.grid_size)
    for f in wavefront.WaveScene.ARRAYS:
        want, got = np.asarray(getattr(jws, f)), getattr(ws, f).numpy()
        if f == "slot_cell":     # the live slots (module docstring)
            want, got = want[:ws.n_mixed], got[:ws.n_mixed]
        np.testing.assert_array_equal(got, want, err_msg=f)


EDITS = (((40, 30, 40), 10, 1), ((40, 34, 40), 12, 0))


def test_brickify_patch_equals_jax():
    jt, pt = trees(make_terrain_voxels(64, seed=7))
    jscene, scene = jbrick_scene.brickify(jt), brick_scene.brickify(pt)
    assert_fields_equal(jscene, scene, SCENE_FIELDS, "scene")
    for center, radius, value in EDITS:
        jt, pt, ball = edit_both(jt, pt, value, center, radius)
        jp = jbrick_scene.brickify_patch(jt, jscene, ball.min, ball.max)
        p = brick_scene.brickify_patch(pt, scene, ball.min, ball.max)
        assert_fields_equal(jp, p, PATCH_FIELDS, "patch")
        assert_fields_equal(jscene, scene, SCENE_FIELDS, "scene")


@pytest.mark.parametrize("case", ["terrain-64", "g64"])
def test_apply_patch_equals_jax(case):
    if case == "g64":   # 64^3 terrain in the corner of a 2048^3 world
        jt, pt = trees(make_terrain_voxels(64, seed=9), levels=5)
        edits = (((32, 36, 32), 9, 1), ((30, 20, 34), 12, 0))
    else:
        jt, pt = trees(make_terrain_voxels(64, seed=9))
        edits = (((32, 36, 32), 9, 1), ((20, 24, 44), 12, 0))
    jscene, scene = jbrick_scene.brickify(jt), brick_scene.brickify(pt)
    jws = jwavefront.prepare(copy.deepcopy(jscene))
    ws = wavefront.prepare(scene, "cpu")
    assert ws.grid_size == (64 if case == "g64" else 2)
    assert_wave_equal(jws, ws)
    for center, radius, value in edits:
        jt, pt, ball = edit_both(jt, pt, value, center, radius)
        jp = jbrick_scene.brickify_patch(jt, jscene, ball.min, ball.max)
        p = brick_scene.brickify_patch(pt, scene, ball.min, ball.max)
        jws = jwavefront.apply_patch(jws, jscene, jp)
        stats = {}
        ws = wavefront.apply_patch(ws, scene, p, stats=stats)
        assert not stats["full"] and 0 < stats["bytes"]
        assert_wave_equal(jws, ws)
        # the patched tables equal a fresh prepare of the patched host
        # scene at the same capacity (slot_cell on its live slots)
        assert_wave_equal(wavefront.prepare(scene, "cpu",
                                            capacity=ws.capacity), ws)


@pytest.mark.parametrize("layout", ["overflow", "paged", "attr16", "attr2d"])
def test_full_prepare_where_jax_prepares(layout):
    # 4096^3 (G = 128) is paged; at 128^3 (G = 4) most bricks are air
    levels = {"paged": 6, "overflow": 1}.get(layout, 0)
    jt, pt = trees(make_terrain_voxels(64, seed=9), levels=levels)
    jscene, scene = jbrick_scene.brickify(jt), brick_scene.brickify(pt)
    kw = dict(attr16=layout == "attr16")
    if layout == "attr2d":
        kw["attr2d"] = True
    if layout == "overflow":
        kw["capacity"] = scene.n_mixed
    jws = jwavefront.prepare(copy.deepcopy(jscene), **kw)
    ws = wavefront.prepare(scene, "cpu", **kw)
    jt, pt, ball = edit_both(jt, pt, 1, (32, 36, 32), 9)
    if layout == "overflow":    # a sphere in the air: new mixed bricks
        jt, pt, ball2 = edit_both(jt, pt, 1, (100, 100, 100), 6)
        ball.max = np.maximum(ball.max, ball2.max)
    jp = jbrick_scene.brickify_patch(jt, jscene, ball.min, ball.max)
    p = brick_scene.brickify_patch(pt, scene, ball.min, ball.max)
    assert p.n_mixed > ws.capacity or layout != "overflow"
    stats = {}
    got = wavefront.apply_patch(ws, scene, p, stats=stats)
    assert stats["full"]
    assert_wave_equal(jwavefront.apply_patch(jws, jscene, jp), got)
    fresh = wavefront.prepare(scene, "cpu", capacity=got.capacity,
                              attr16=kw["attr16"])
    for f in wavefront.WaveScene.ARRAYS:
        assert torch.equal(getattr(fresh, f), getattr(got, f)), f


def test_slot_cell_hazard():
    """A subtract sphere containing a whole mixed brick (cell (2,0,2) of a
    G = 4 world) promotes its node to a leaf: the cell turns uniform
    (cell_slot -1).  JAX's ``slot_cell.at[cell_slot].set(cells,
    mode="drop")`` normalises -1 to the last slot and writes a touched
    uniform cell's id into slot_cell[capacity - 1]; the port drops it."""
    v = np.zeros((128, 128, 128), np.uint8)
    v[70:75, 5:9, 70:75] = 1          # in the brick that turns uniform
    v[5:9, 100:104, 5:9] = 2          # a brick far from the brush
    # a brick the brush's box touches, outside the sphere: JAX's
    # apply_patch raises on a patch without mixed bricks
    v[105:109, 40:44, 105:109] = 3
    jt, pt = trees(v)
    jscene, scene = jbrick_scene.brickify(jt), brick_scene.brickify(pt)
    jws = jwavefront.prepare(copy.deepcopy(jscene))
    ws = wavefront.prepare(scene, "cpu")
    cap = ws.capacity
    jt, pt, ball = edit_both(jt, pt, 0, (80, 16, 80), 30)
    jp = jbrick_scene.brickify_patch(jt, jscene, ball.min, ball.max)
    p = brick_scene.brickify_patch(pt, scene, ball.min, ball.max)
    uniform = set(p.cells[p.cell_slot < 0].tolist())
    assert (2 * 4 + 0) * 4 + 2 in uniform and 0 not in uniform
    jws = jwavefront.apply_patch(jws, jscene, jp)
    ws = wavefront.apply_patch(ws, scene, p)
    assert int(np.asarray(jws.slot_cell)[cap - 1]) in uniform
    assert int(ws.slot_cell[cap - 1]) == 0
    assert_wave_equal(jws, ws)
    # every live slot maps back to its cell
    live = np.nonzero(scene.brick_slot >= 0)[0]
    np.testing.assert_array_equal(
        ws.slot_cell.numpy()[scene.brick_slot[live]], live)


def test_patch_without_mixed_bricks():
    """Subtracting in the air changes no voxel, and every brick the box
    touches stays uniform: the patch has no payload rows (JAX's
    apply_patch raises ValueError in _cr_split on it; the port's writes
    the touched cells alone)."""
    _, pt = trees(make_terrain_voxels(64, seed=9), levels=1)
    scene = brick_scene.brickify(pt)
    ws = wavefront.prepare(scene, "cpu")
    pt, pt0 = sdf.use_sdf_brush(pt, sdf.Sphere((100, 100, 100), 6), 0)[0], pt
    p = brick_scene.brickify_patch(pt, scene, (94, 94, 94), (106, 106, 106))
    assert len(p.upd_slots) == 0 and len(p.cells) > 0
    ws = wavefront.apply_patch(ws, scene, p)
    assert_wave_equal(wavefront.prepare(brick_scene.brickify(pt0), "cpu"),
                      ws)


@pytest.mark.parametrize("case", ["terrain-64", "g64"])
def test_patched_rays_equal_full_prepare(case):
    levels = 5 if case == "g64" else 0
    _, pt = trees(make_terrain_voxels(64, seed=9), levels=levels)
    scene = brick_scene.brickify(pt)
    ws = wavefront.prepare(scene, "cpu")
    for center, radius, value in (((32, 36, 32), 9, 1),
                                  ((30, 20, 34), 12, 0)):
        ball = sdf.Sphere(np.asarray(center), radius)
        pt, _ = sdf.use_sdf_brush(pt, ball, value)
        p = brick_scene.brickify_patch(pt, scene, ball.min, ball.max)
        ws = wavefront.apply_patch(ws, scene, p)
    full = wavefront.prepare(brick_scene.brickify(pt), "cpu")
    o, d = chip_smoke.random_rays(2048, seed=3)
    if levels:      # aim into the 64^3 corner of the 2048^3 world
        o = 1.0 + (o - 1.0) / 32.0
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    a = wavefront.intersect_wavefront(ws, o, d)
    b = wavefront.intersect_wavefront(full, o, d)
    assert 0.1 < a.hit.float().mean() < 0.9
    for f in ("hit", "value", "t", "normal", "depth", "iters"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
