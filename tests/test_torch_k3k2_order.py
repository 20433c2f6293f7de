"""The orders in which kernels K3 and K2 trace their rays, on the CPU.

K3 (brick_pallas.trace_kernel) traces ray order[k] at position k and
writes its record to that ray's slot; K2 (brick_dda.coarse_dda_kernel)
hands each resident block the rays of a grid stride.  Either schedule is
right only if a ray's record does not depend on where in the batch it is
traced: the plain versions over the rays in a permutation, written back
through it, must equal them in ray order in every field (tolerance:
equality, NaN equal to NaN).  K3's CPU path checks the order and traces
in ray order.  Against the JAX package the contracts are the existing
ones: tests/test_torch_brick_round.py's floors for intersect_bricks_tpu
(hit agreement >= 0.995, strict >= 0.98 of common hits) and
tests/test_torch_skip.py's for the skip distances (hit equal, t within
T_TOL on >= MIN_AGREE of rays: XLA contracts multiply-adds that the port
rounds twice).  render_image hands KE the tile permutation and K2 the
rays in ray order (K2, bound by the rays' bytes, is faster so).  The
schedules themselves (the blocks, the grid stride) are held by the g++
builds of the kernels' sources in tests/test_torch_kernel_source.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_dda as jbrick_dda
from svo_raytracer_tpu.ops import brick_pallas as jbrick_pallas
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import skip_grid as jskip_grid
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import brick_dda, brick_pallas, brick_scene
from svo_raytracer_torch.ops import shade, skip_grid, traverse
from svo_raytracer_torch.utils.camera import Camera
from test_torch_brick_round import _agreement, _numpy
from test_torch_skip import MIN_AGREE, T_TOL
from test_traverse_batch import random_rays

W, H = 24, 16          # 384 rays: three 8x4 tile rows, ragged nowhere
SCENES = {"sphere-64": (lambda: make_sphere_voxels(64, radius=24), 11),
          "terrain-64": (lambda: make_terrain_voxels(64, seed=7), 12)}


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX tree, JAX device BrickScene, port CPU BrickScene,
    port CPU octree)."""
    out = {}
    for name, (vox, _) in SCENES.items():
        jt = build_np.build_octree_np(vox())
        tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                     jt.n_nodes, jt.world_size)
        out[name] = (jt, jbrick_scene.brickify(jt).to_device(),
                     brick_scene.brickify(jt).to_device("cpu"),
                     tree.to_device("cpu"))
    return out


def _rays(seed):
    """W*H world-space rays, non-finite and inactive ones among them."""
    o, d = random_rays(W * H, seed=seed)
    o[::61] = np.nan
    act = np.ones(W * H, dtype=bool)
    act[5::37] = False
    return o, d, act


def _same(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all()
                if a.is_floating_point() else (a == b).all())


def _written_back(rec, order):
    out = {}
    for f, a in rec.items():
        out[f] = torch.empty_like(a)
        out[f][order] = a
    return out


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("max_rounds", [24, 2])
def test_k3_records_do_not_depend_on_the_order(scenes, name, max_rounds):
    """trace_plain over the rays in tile order, written back through the
    permutation, equals it in ray order in every field, with every round
    and cut at 2; trace given the order equals it too."""
    _, _, scene, _ = scenes[name]
    o, d, act = _rays(SCENES[name][1])
    ov = ((torch.from_numpy(o) - 1.0) * scene.world_size).contiguous()
    dv = torch.from_numpy(d)
    alive = torch.from_numpy(act) & torch.isfinite(ov).all(1)
    order = traverse.tile_order(W, H, "cpu")
    want = brick_pallas.trace_plain(scene, ov, dv, alive, max_rounds)
    back = _written_back(brick_pallas.trace_plain(
        scene, ov[order], dv[order], alive[order], max_rounds), order)
    got = brick_pallas.trace(scene, ov, dv, alive, max_rounds, order)
    for f, a in want.items():
        assert _same(a, back[f]) and _same(a, got[f]), f
    assert want["hit"].any() and not want["hit"].all()


@pytest.mark.parametrize("name", SCENES)
def test_ordered_intersect_bricks_matches_unordered_and_jax(scenes, name):
    """intersect_bricks_tpu(..., order=tile_order) equals the unordered
    call in every HitResult field, and the JAX package's
    intersect_bricks_tpu (interpret mode) at its floors."""
    _, jscene, scene, _ = scenes[name]
    o, d, act = _rays(SCENES[name][1] + 1)
    ot, dt, at = (torch.from_numpy(a) for a in (o, d, act))
    order = traverse.tile_order(W, H, "cpu")
    got = brick_pallas.intersect_bricks_tpu(scene, ot, dt, active=at,
                                            order=order)
    plain = brick_pallas.intersect_bricks_tpu(scene, ot, dt, active=at)
    for f in got._fields:
        assert _same(getattr(got, f), getattr(plain, f)), f
    ref = jbrick_pallas.intersect_bricks_tpu(
        jscene, jnp.asarray(o), jnp.asarray(d), active=jnp.asarray(act),
        interpret=True)
    agree, strict = _agreement(_numpy(ref), _numpy(got))
    assert agree >= 0.995 and strict >= 0.98, (agree, strict)
    assert got.hit.any() and not got.hit.all()


@pytest.mark.parametrize("G", [1, 32, 64])
def test_k2_records_do_not_depend_on_the_order(G):
    """coarse_dda_plain over the rays in a permutation, written back,
    equals it in ray order in every field, so K2's blocks may take the
    rays in any split; coarse_dda equals it too, and given an expanded
    direction row and no active mask (as the shadow and primary segments
    pass them) equals the plain version on the packed rows."""
    rng = np.random.default_rng(G + 40)
    tab = torch.from_numpy(brick_scene.table_rows(
        brick_scene.pack_occupancy(rng.random((G,) * 3) < 0.04)))
    B = 777
    o = torch.from_numpy(rng.uniform(-G, 2 * G, (B, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    alive = torch.from_numpy(rng.random(B) < 0.9)
    order = torch.from_numpy(rng.permutation(B))
    want = brick_dda.coarse_dda_plain(tab, o, d, G, 3 * G, alive)
    back = _written_back(brick_dda.coarse_dda_plain(
        tab, o[order], d[order], G, 3 * G, alive[order]), order)
    got = brick_dda.coarse_dda(tab, o, d, G, active=alive)
    for f, a in want.items():
        assert _same(a, back[f]) and _same(a, got[f]), f
    row = d[3].expand(B, 3)
    full = brick_dda.coarse_dda_plain(tab, o, row.contiguous(), G, 3 * G,
                                      torch.ones(B, dtype=torch.bool))
    got = brick_dda.coarse_dda(tab, o, row, G)
    for f, a in full.items():
        assert _same(a, got[f]), f
    if G > 1:
        assert want["hit"].any() and not want["hit"].all()


@pytest.mark.parametrize("G", [16, 32])
def test_shadow_layout_skip_distances_match_packed_and_jax(scenes, G):
    """skip_distances of world rays toward one sun direction, given as
    the shadow segment passes it (one row expanded over the batch, no
    active mask), equals the call on packed rows with every ray active,
    and the JAX package's skip_distances (Pallas K2 in interpret mode)
    on the same rays and grid."""
    jt, _, _, tree = scenes["terrain-64"]
    words = skip_grid.build_skip_grid(tree, G)
    tab = torch.from_numpy(brick_scene.table_rows(words))
    o, _, _ = _rays(3)
    o[::61] = 1.5                  # K2's NaN rays are held elsewhere
    sun = np.asarray(shade.SUN_DIR_DIRECT, np.float32)
    d = np.broadcast_to(sun, o.shape).copy()
    ot = torch.from_numpy(o)
    row = torch.from_numpy(sun).expand(o.shape[0], 3)
    skip, maybe = skip_grid.skip_distances(tab, ot, row, grid_size=G)
    skip0, maybe0 = skip_grid.skip_distances(
        tab, ot, torch.from_numpy(d), grid_size=G,
        active=torch.ones(o.shape[0], dtype=torch.bool))
    assert torch.equal(skip, skip0) and torch.equal(maybe, maybe0)
    jskip, jmaybe = jskip_grid.skip_distances(
        jbrick_dda.table_rows(jnp.asarray(words)), jnp.asarray(o),
        jnp.asarray(d), grid_size=G, interpret=True)
    assert np.array_equal(np.asarray(jmaybe), maybe.numpy())
    close = np.abs(np.asarray(jskip) - skip.numpy()) <= T_TOL
    assert close.mean() >= MIN_AGREE
    assert maybe.any() and not maybe.all() and (skip > 0).any()


@pytest.mark.parametrize("mode", [0, 2])
def test_render_gives_ke_the_tiles_and_k2_ray_order(scenes, mode):
    """With a skip grid, render_image hands every KE segment the cached
    tile permutation of its image size, and every K2 batch its rays in
    ray order (coarse_dda takes no permutation)."""
    _, _, _, tree = scenes["terrain-64"]
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32)
    tab = torch.from_numpy(brick_scene.table_rows(
        skip_grid.build_skip_grid(tree, 32)))
    with chip_smoke.capture(traverse, "trace") as ke, \
            chip_smoke.capture(brick_dda, "coarse_dda") as k2:
        shade.render_image(tree, cam5, W, H, render_mode=mode, gi_bounces=1,
                           skip_tab=tab, skip_grid_size=32)
    tiles = traverse.tile_order(W, H, "cpu")
    assert len(ke) == 2 and len(k2) == 2
    assert all(k["order"] is tiles for _, k in ke)
    assert all("order" not in k for _, k in k2)


def test_k3_order_rejects_bad_permutations(scenes):
    """An order of the wrong length, type or layout raises, through
    intersect_bricks_tpu and through trace."""
    _, _, scene, _ = scenes["terrain-64"]
    o, d, act = _rays(9)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    B = ot.shape[0]
    alive = torch.ones(B, dtype=torch.bool)
    for bad in (torch.arange(B - 1), torch.arange(B, dtype=torch.int32),
                torch.arange(2 * B)[::2]):
        with pytest.raises(ValueError):
            brick_pallas.intersect_bricks_tpu(scene, ot, dt, order=bad)
        with pytest.raises(ValueError):
            brick_pallas.trace(scene, ot, dt, alive, 24, bad)


def test_k2_row_strides():
    """K2 takes directions in packed rows or one row expanded over the
    batch as they are, and any other layout after a copy."""
    a = torch.zeros(5, 3)
    assert brick_dda._row_stride(a) == 3
    assert brick_dda._row_stride(a[0].expand(5, 3)) == 0
    assert brick_dda._row_stride(a[:1]) == 0
    assert brick_dda._row_stride(torch.zeros(5, 4)[:, :3]) is None
    assert brick_dda._row_stride(torch.zeros(1, 6)[:, ::2]) is None
    assert brick_dda._row_stride(a.double()) is None
