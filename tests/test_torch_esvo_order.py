"""The order in which kernel KE traces a render's rays on the CPU:
traverse.tile_order's documented layout, that render_image hands it to
every segment, that the order changes no record, and the port's
intersect_octree in that order against the JAX package's
intersect_octree.

KE's thread k traces ray order[k] and writes its record to slot
order[k]; here intersect_plain run over the rays in tile order and
written back through the permutation must equal intersect_plain in frame
order in every field (tolerance: equality, NaN equal to NaN).  The CPU
path of traverse.trace checks the order and traces in ray order.  Against
JAX the contract is tests/test_torch_traverse.py's: hit masks
equal on every ray and a strict-agreement share of at least MIN_STRICT
(XLA contracts multiply-adds that the port does not form).  The scenes:
sphere-64, terrain-64 and checker-16 octrees.  The binned schedule of
cone-traced segments is held in tests/test_torch_kernel_source.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import traverse as jtraverse
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import brick_scene, shade, skip_grid, traverse
from svo_raytracer_torch.utils.camera import Camera
from test_torch_traverse import MIN_STRICT, _agreement, _np
from test_traverse_batch import random_rays

SCENES = ("sphere-64", "terrain-64", "checker-16")
W, H = 64, 48


def _voxels(name):
    if name == "sphere-64":
        return make_sphere_voxels(64, radius=24)
    if name == "terrain-64":
        return make_terrain_voxels(64, seed=7)
    return (np.indices((16,) * 3).sum(0) % 2).astype(np.uint8)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name in SCENES:
        jt = build_np.build_octree_np(_voxels(name))
        out[name] = (jt, octree.from_reference(
            jt.child, jt.mask, jt.value, jt.normal, jt.n_nodes,
            jt.world_size).to_device("cpu"))
    return out


def _rays(seed=31):
    """W*H world-space rays with non-finite and inactive ones among them."""
    o, d = random_rays(W * H, seed=seed)
    o[::97] = np.nan
    d[3::89, 1] = -np.inf
    act = np.ones(W * H, dtype=bool)
    act[11::37] = False
    return o, d, act


@pytest.mark.parametrize("width,height", [(64, 48), (61, 50), (8, 4),
                                          (1, 1), (1920, 1080)])
def test_tile_order_layout(width, height):
    """Row-major pixel ids in 8x4 tiles: tiles row-major, pixels row-major
    within a tile, the last tile column and row cut at the edge."""
    order = traverse.tile_order(width, height, "cpu")
    assert order.dtype == torch.int64 and order.shape == (width * height,)
    want = []
    for ty in range(0, height, traverse.TILE_H):
        for tx in range(0, width, traverse.TILE_W):
            for y in range(ty, min(ty + traverse.TILE_H, height)):
                for x in range(tx, min(tx + traverse.TILE_W, width)):
                    want.append(y * width + x)
    assert torch.equal(order, torch.tensor(want, dtype=torch.int64))


def test_tile_order_is_cached():
    """One permutation per image size and device, built once."""
    a = traverse.tile_order(W, H, "cpu")
    assert traverse.tile_order(W, H, torch.device("cpu")) is a
    assert traverse.tile_order(W + 8, H, "cpu") is not a


def _same(a, b):
    return (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() \
        else a == b


@pytest.mark.parametrize("name", SCENES)
def test_tile_order_trace_equals_frame_order(trees, name):
    """intersect_plain over the rays in tile order, written back through
    the permutation, equals intersect_plain in frame order in every field
    (cone-traced too), as does traverse.trace given the order (on the
    CPU, in ray order)."""
    _, tree = trees[name]
    packed = traverse.make_packed_table(tree)
    o, d, alive = (torch.from_numpy(a) for a in _rays())
    order = traverse.tile_order(W, H, "cpu")
    for kw in (dict(), dict(cone_trace=True, max_depth=5)):
        want = traverse.intersect_plain(packed, o, d, alive, **kw)
        perm = traverse.intersect_plain(packed, o[order], d[order],
                                        alive[order], **kw)
        got = traverse.trace(packed, o, d, alive, order=order, **kw)
        for field, a in want.items():
            back = torch.empty_like(a)
            back[order] = perm[field]
            assert bool(_same(a, back).all()), (field, kw)
            assert bool(_same(a, got[field]).all()), (field, kw)
        assert (want["done"] == 1).any() and (want["iters"] > 0).any()


@pytest.mark.parametrize("name", SCENES)
def test_ordered_intersect_matches_jax(trees, name):
    """intersect_octree(..., order=tile_order(...)) on the CPU against the
    JAX package's intersect_octree on the same rays, plain and
    cone-traced as the bounce segments are: hit masks equal, strict
    share >= MIN_STRICT."""
    jt, tree = trees[name]
    o, d, act = _rays(seed=7)
    ot, dt, at = (torch.from_numpy(a) for a in (o, d, act))
    order = traverse.tile_order(W, H, "cpu")
    for kw in (dict(), dict(cone_trace=True)):
        ref = _np(jtraverse.intersect_octree(
            jt.to_device().arrays(), jnp.asarray(o), jnp.asarray(d),
            active=jnp.asarray(act), **kw))
        got = _np(traverse.intersect_octree(tree, ot, dt, active=at,
                                            order=order, **kw))
        hit_eq, strict = _agreement(ref, got)
        assert hit_eq and strict >= MIN_STRICT, (kw, strict)
        assert got["hit"].any() and not got["hit"].all()


def test_order_rejects_bad_permutations(trees):
    """An order of the wrong length, type or layout raises."""
    _, tree = trees["terrain-64"]
    o, d, alive = (torch.from_numpy(a) for a in _rays())
    B = o.shape[0]
    for bad in (torch.arange(B - 1), torch.arange(B, dtype=torch.int32),
                torch.arange(2 * B)[::2]):
        with pytest.raises(ValueError):
            traverse.intersect_octree(tree, o, d, active=alive, order=bad)


@pytest.mark.parametrize("mode,skip", [(0, False), (2, True)])
def test_render_traces_every_segment_in_tile_order(mode, skip):
    """render_image hands every traversal segment (primary, bounce or
    shadow; with or without the skip grid) the cached tile permutation of
    its image size; the beam prepass's coarse rays keep their order."""
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7))
    tree = octree.from_reference(tree.child, tree.mask, tree.value,
                                 tree.normal, tree.n_nodes,
                                 tree.world_size).to_device("cpu")
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32)
    kw = dict(render_mode=mode, gi_bounces=1, use_beam=True)
    if skip:
        kw.update(skip_tab=torch.from_numpy(brick_scene.table_rows(
            skip_grid.build_skip_grid(tree, 32))), skip_grid_size=32)
    with chip_smoke.capture(traverse, "trace") as calls:
        shade.render_image(tree, cam5, W, H, **kw)
    tiles = traverse.tile_order(W, H, "cpu")
    beam = [k.get("order") for a, k in calls if a[1].shape[0] != W * H]
    segs = [k.get("order") for a, k in calls if a[1].shape[0] == W * H]
    assert beam == [None] and len(segs) == 2
    assert all(s is tiles for s in segs)
