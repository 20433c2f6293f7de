"""The staged ESVO drivers in the port: traverse.intersect_octree_staged
and shade.render_frame_staged, against the port's intersect_octree and
render_image and against the JAX package's staged drivers, on the 32^3
terrain of tests/conftest.py.  The port's staged frame is one full-frame
pass; JAX's is rendered in row blocks (8 rows here, and 2 and 24 in one
test), whose pixels equal the full frame's.

The port's staged traversal is KE over the whole batch (the JAX driver's
rounds and compaction serve TPU lock-step batches), so it equals the
port's intersect_octree in every field.  Against JAX's staged traversal
it meets JAX's own contract (tests/test_traverse_batch.py:165-188): hit
and value exact, every integer field equal on >= 95% of rays, floats
within 1e-4.  Staged frames meet tests/test_shade.py:204-230's bar
against JAX's: colour and depth within 1e-4 (relative and absolute) on
every pixel, iters within 8; mode 0 on both sides takes JAX's sin-hash
random (the frameworks' ``sin`` differ by an ulp, tests/test_torch_shade
.py).  Against the port's render_image with the same settings a staged
frame is equal on every pixel, except with both the skip grid and the
beam: as in the JAX package, the staged beam traces its coarse rays
through the skip grid, which restarts each at its skip distance and
moves its t by a few ulps, so pixels under a moved beam cell differ in
colour and depth by up to 1e-6 (9.5e-7 measured here), their hits and
iteration counts equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import rng as jrng
from svo_raytracer_tpu.ops import shade as jshade
from svo_raytracer_tpu.ops import traverse as jtraverse
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import brick_scene, rng, shade, skip_grid
from svo_raytracer_torch.ops import traverse
from svo_raytracer_torch.utils.camera import Camera
from test_traverse_batch import _staged_test_rays

W, H = 48, 24
SKIP_G = 8
FRAME_TOL = 1e-4
ITERS_DRIFT = 8
SKIP_BEAM_TOL = 1e-6


@pytest.fixture(scope="module")
def world():
    jt = build_np.build_octree_np(make_terrain_voxels(32))
    tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")
    words = skip_grid.build_skip_grid(tree, SKIP_G)
    cam = Camera(pos=np.array([1.5, 1.7, 1.85]))
    cam.rotate(-0.5, 0.25)
    return dict(jarr=jt.to_device().arrays(), tree=tree,
                tab=brick_scene.table_rows(words),
                cam5=cam.uniform().astype(np.float32))


def _rays():
    o, d = _staged_test_rays()
    return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


def _equal(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        same = (x == y) | (x.isnan() & y.isnan()) if x.is_floating_point() \
            else x == y
        assert bool(same.all()), f"{what}: {f} differs"


@pytest.mark.parametrize("masked", [False, True])
def test_staged_equals_intersect_octree(world, masked):
    o, d = _rays()
    act = None
    if masked:
        act = torch.from_numpy(np.random.default_rng(3).random(len(o)) < 0.7)
    got = traverse.intersect_octree_staged(world["tree"], o, d, active=act)
    ref = traverse.intersect_octree(world["tree"], o, d, active=act)
    _equal(got, ref, "staged vs intersect_octree")
    if masked:
        assert not bool(got.hit[~act].any())


def test_staged_matches_jax_staged(world):
    o, d = _rays()
    ref = jtraverse.intersect_octree_staged(world["jarr"], jnp.asarray(o),
                                            jnp.asarray(d), round_steps=32,
                                            min_rows=1)
    got = traverse.intersect_octree_staged(world["tree"], o, d)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_array_equal(got["value"], ref["value"])
    for f in ("iters", "depth", "node", "scale_exp2", "normal"):
        a, b = got[f], ref[f]
        agree = (a == b) if a.ndim == 1 else (a == b).all(axis=-1)
        assert agree.mean() >= 0.95, f"{f}: {agree.mean():.3f}"
    for f in ("t", "hit_pos", "voxel_pos"):
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-4, atol=1e-4,
                                   err_msg=f)


def test_staged_respects_active_mask(world):
    o = torch.full((8, 3), 1.5)
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(8, 1)
    act = torch.tensor([True, False] * 4)
    res = traverse.intersect_octree_staged(world["tree"], o, d, active=act)
    assert not bool(res.hit[1::2].any()) and bool(res.hit[::2].all())


def _jax_rand(px, py, frame):
    return torch.from_numpy(np.array(jrng.pixel_rand(
        jnp.asarray(px.numpy()), jnp.asarray(py.numpy()), frame)))


def _frames(world, mode, beam, skip, width=W, height=H, row_block=8):
    jkw, kw = dict(render_mode=mode, use_beam=beam), dict(
        render_mode=mode, use_beam=beam)
    if skip:
        jkw.update(skip_tab=jnp.asarray(world["tab"]),
                   skip_grid_size=SKIP_G)
        kw.update(skip_tab=torch.from_numpy(world["tab"]),
                  skip_grid_size=SKIP_G)
    ref = jshade.render_frame_staged(world["jarr"], jnp.asarray(
        world["cam5"]), width, height, row_block=row_block, round_steps=32,
        **jkw)
    got = shade.render_frame_staged(world["tree"], torch.from_numpy(
        world["cam5"]), width, height, **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("mode", [0, 2, 3])
def test_render_frame_staged_matches_jax(world, monkeypatch, mode, beam,
                                         skip):
    monkeypatch.setattr(rng, "pixel_rand", _jax_rand)
    ref, got = _frames(world, mode, beam, skip)
    for a, b, name in zip(ref, got, ("color", "depth")):
        np.testing.assert_allclose(b, a, rtol=FRAME_TOL, atol=FRAME_TOL,
                                   err_msg=f"mode={mode} {name}")
    assert np.abs(got[2].astype(np.int64) - ref[2]).max() <= ITERS_DRIFT
    miss = -1.0 if mode == 0 else 0.0
    assert 0.1 < (got[1] != miss).mean() < 0.95


@pytest.mark.parametrize("row_block", [2, 24])
@pytest.mark.parametrize("mode", [0, 2])
def test_one_pass_matches_jax_row_blocks(world, monkeypatch, mode,
                                         row_block):
    """The port renders the frame in one pass; JAX's row blocks of 2 and
    of 24 rows (the whole frame) give the same frame, to the same bar."""
    monkeypatch.setattr(rng, "pixel_rand", _jax_rand)
    ref, got = _frames(world, mode, True, False, row_block=row_block)
    for a, b, name in zip(ref, got, ("color", "depth")):
        np.testing.assert_allclose(b, a, rtol=FRAME_TOL, atol=FRAME_TOL,
                                   err_msg=f"mode={mode} {name}")
    assert np.abs(got[2].astype(np.int64) - ref[2]).max() <= ITERS_DRIFT


def test_render_frame_staged_ragged_beam_matches_jax(world):
    """Height 26 is no multiple of the beam tile: the last rows read the
    last beam row, as XLA clamps JAX's gather."""
    ref, got = _frames(world, 2, True, False, height=26)
    assert got[0].shape == (26, W, 3)
    for a, b, name in zip(ref, got, ("color", "depth")):
        np.testing.assert_allclose(b, a, rtol=FRAME_TOL, atol=FRAME_TOL,
                                   err_msg=name)
    assert np.abs(got[2].astype(np.int64) - ref[2]).max() <= ITERS_DRIFT


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("mode", [0, 2, 3])
def test_staged_equals_render_image(world, mode, beam, skip):
    kw = dict(render_mode=mode, use_beam=beam)
    if skip:
        kw.update(skip_tab=torch.from_numpy(world["tab"]),
                  skip_grid_size=SKIP_G)
    c5 = torch.from_numpy(world["cam5"])
    stats = []
    a = shade.render_frame_staged(world["tree"], c5, W, H, stats=stats,
                                  **kw)
    b = shade.render_image(world["tree"], c5, W, H, **kw)
    segs = (2 if mode == 0 else 1) * (2 if mode == 2 else 1)
    assert len(stats) == (1 if beam else 0) + segs
    if not (skip and beam):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        return
    assert torch.equal(a[2], b[2])
    assert torch.equal(a[1] > 0, b[1] > 0)
    moved = (a[1] != b[1]).float().mean().item()
    print(f"pixels whose depth moved: {moved:.3f}")
    for x, y in zip(a[:2], b[:2]):
        assert float((x - y).abs().max()) <= SKIP_BEAM_TOL
