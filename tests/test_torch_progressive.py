"""Threefry rendering in the port against the JAX package: render_image
mode 0 with ``rng_mode="threefry"`` (shade_gi drawing each segment's
random anew) at 64x40 on terrain-64, gi 1 and 3, with and without
mirrors; render_progressive at spp 1 and 4 at 32x32; the progressive
variance property of tests/test_features.py; and the wavefront frame's
refusal of threefry, as JAX's.

The bar is tests/test_torch_esvo_render.py's: the primary hit mask equal
on every pixel, and colour and depth within 1e-4 on at least 98% of
pixels (XLA contracts multiply-adds in the traversal that the port does
not form, which moves a few grazing rays).  The random itself is
bit-equal (tests/test_torch_rng.py), so nothing is fed across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import shade as jshade
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import render_wave, rng, shade
from svo_raytracer_torch.ops import wavefront
from svo_raytracer_torch.utils.camera import Camera

TOL = 1e-4
MIN_CLOSE = 0.98


def _world(vox, pos, rot):
    jt = build_np.build_octree_np(vox)
    tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")
    cam = Camera(pos=np.array(pos))
    cam.rotate(*rot)
    return jt.to_device().arrays(), tree, cam.uniform().astype(np.float32)


@pytest.fixture(scope="module")
def terrain():
    # tests/test_torch_esvo_render.py's world and off-dyadic camera
    return _world(make_terrain_voxels(64, seed=7), [1.13, 1.93, 1.17],
                  (-0.6, 3.9))


def _check(ref_col, ref_depth, col, depth):
    ref_col, ref_depth = np.asarray(ref_col), np.asarray(ref_depth)
    col, depth = col.numpy(), depth.numpy()
    hit_ref, hit = ref_depth != -1.0, depth != -1.0
    close = ((np.abs(ref_col - col).max(-1) <= TOL)
             & (np.abs(ref_depth - depth) <= TOL))
    print(f"hit pixels {hit.mean():.3f}, within {TOL}: {close.mean():.4f}")
    assert np.array_equal(hit_ref, hit)
    assert close.mean() >= MIN_CLOSE
    assert np.isfinite(col).all()
    assert 0.1 < hit.mean() < 0.9


@pytest.mark.parametrize("gi,mirrors", [(1, ()), (3, ()), (1, (3,)),
                                        (3, (1,))])
def test_threefry_frame_matches_jax(terrain, gi, mirrors):
    jarr, tree, cam5 = terrain
    ref_col, ref_depth, _ = jshade.render_image(
        jarr, jnp.asarray(cam5), 64, 40, render_mode=0, frame_number=2,
        gi_bounces=gi, rng_mode="threefry", rng_key=jax.random.PRNGKey(3),
        mirror_values=mirrors)
    col, depth, _ = shade.render_image(
        tree, torch.from_numpy(cam5), 64, 40, render_mode=0, frame_number=2,
        gi_bounces=gi, rng_mode="threefry", rng_key=rng.prng_key(3),
        mirror_values=mirrors)
    _check(ref_col, ref_depth, col, depth)


def test_threefry_differs_from_glsl_and_needs_a_key(terrain):
    _, tree, cam5 = terrain
    c5 = torch.from_numpy(cam5)
    a, _, _ = shade.render_image(tree, c5, 16, 8, render_mode=0)
    b, _, _ = shade.render_image(tree, c5, 16, 8, render_mode=0,
                                 rng_mode="threefry",
                                 rng_key=rng.prng_key(0))
    assert bool(torch.isfinite(b).all()) and not torch.equal(a, b)
    with pytest.raises(ValueError):
        shade.render_image(tree, c5, 16, 8, render_mode=0,
                           rng_mode="threefry")
    with pytest.raises(ValueError):
        shade.render_image(tree, c5, 16, 8, render_mode=0, rng_mode="pcg")


@pytest.mark.parametrize("spp", [1, 4])
def test_render_progressive_matches_jax(terrain, spp):
    jarr, tree, cam5 = terrain
    ref_col, ref_depth = jshade.render_progressive(
        jarr, jnp.asarray(cam5), 32, 32, spp=spp,
        rng_key=jax.random.PRNGKey(7))
    col, depth = shade.render_progressive(
        tree, torch.from_numpy(cam5), 32, 32, spp=spp,
        rng_key=rng.prng_key(7))
    assert col.shape == (32, 32, 3) and depth.shape == (32, 32)
    _check(ref_col, ref_depth, col, depth)


def test_progressive_accumulation_reduces_variance():
    """tests/test_features.py's property on the port: spp-8 images of two
    keys agree better than spp 1 against spp 8."""
    v = make_sphere_voxels(32)
    v[:, :4, :] = 3
    _, tree, cam5 = _world(v, [1.5, 1.6, 2.3], (-0.3, 0.0))
    c5 = torch.from_numpy(cam5)
    one, _ = shade.render_progressive(tree, c5, 32, 32, spp=1,
                                      rng_key=rng.prng_key(7))
    many, _ = shade.render_progressive(tree, c5, 32, 32, spp=8,
                                       rng_key=rng.prng_key(7))
    other, _ = shade.render_progressive(tree, c5, 32, 32, spp=8,
                                        rng_key=rng.prng_key(8))
    d1 = (one - other).abs().mean()
    d8 = (many - other).abs().mean()
    assert d8 < d1


def test_wavefront_frame_refuses_threefry():
    hm, mm = bigworld.fractal_heightmap(64, seed=0)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 64), "cpu")
    cam5 = torch.from_numpy(Camera(pos=np.array([1.3, 1.7, 1.3]))
                            .uniform().astype(np.float32))
    with pytest.raises(NotImplementedError):
        render_wave.render_frame_wavefront(ws, cam5, 8, 8, render_mode=0,
                                           rng_mode="threefry")
    col, _, _ = render_wave.render_frame_wavefront(ws, cam5, 8, 8,
                                                   render_mode=2,
                                                   rng_mode="threefry")
    assert col.shape == (8, 8, 3)
