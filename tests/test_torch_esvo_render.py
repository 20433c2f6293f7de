"""The port's ESVO frame (shade.render_image on the CPU: the plain versions
of kernels KE and K2) against the JAX package's, on terrain-64 at 64x40.

The bar: the primary hit mask equal on every pixel, and colour and depth
within 1e-4 on at least 98% of pixels (XLA contracts multiply-adds in the
traversal that the port does not form, which moves iteration counts and
so the heatmap and penumbra colours on a few grazing rays).  Modes 1-3
run through JAX's jitted render_image.  Mode 0 runs against JAX's
shade_gi called eagerly on the same rays, both fed the same per-pixel
random (the sin hash differs by an ulp between the two frameworks on
~10% of pixels, tests/test_torch_shade.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import rng as jrng
from svo_raytracer_tpu.ops import shade as jshade
from svo_raytracer_tpu.ops import skip_grid as jskip_grid
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import brick_scene, shade, skip_grid
from svo_raytracer_torch.utils.camera import Camera

W, H = 64, 40
TOL = 1e-4
MIN_CLOSE = 0.98


@pytest.fixture(scope="module")
def world():
    jt = build_np.build_octree_np(make_terrain_voxels(64, seed=7))
    tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")
    words = skip_grid.build_skip_grid(tree, 32)
    assert np.array_equal(words, np.asarray(jskip_grid.build_skip_grid(jt,
                                                                       32)))
    cam = Camera(pos=np.array([1.13, 1.93, 1.17]))
    cam.rotate(-0.6, 3.9)
    return dict(jt=jt, jarr=jt.to_device().arrays(), tree=tree,
                words=words, cam5=cam.uniform().astype(np.float32))


def _check(ref_col, ref_depth, col, depth, miss_depth):
    ref_col, ref_depth = np.asarray(ref_col), np.asarray(ref_depth)
    col, depth = col.numpy(), depth.numpy()
    hit_ref, hit = ref_depth != miss_depth, depth != miss_depth
    close = ((np.abs(ref_col - col).max(-1) <= TOL)
             & (np.abs(ref_depth - depth) <= TOL))
    print(f"hit pixels {hit.mean():.3f}, hit mask equal "
          f"{(hit_ref == hit).mean():.4f}, within {TOL}: {close.mean():.4f}")
    assert np.array_equal(hit_ref, hit)
    assert close.mean() >= MIN_CLOSE
    assert np.isfinite(col).all()
    assert 0.1 < hit.mean() < 0.9


@pytest.mark.parametrize("mode,skip,beam", [(2, True, False),
                                            (3, False, True),
                                            (1, False, False)])
def test_render_image_matches_jax(world, mode, skip, beam):
    jkw, pkw = dict(use_beam=beam), dict(use_beam=beam)
    if skip:
        jkw["skip_tab"] = jnp.asarray(brick_scene.table_rows(world["words"]))
        pkw["skip_tab"] = torch.from_numpy(
            brick_scene.table_rows(world["words"]))
    ref_col, ref_depth, _ = jshade.render_image(
        world["jarr"], jnp.asarray(world["cam5"]), W, H, render_mode=mode,
        **jkw)
    stats = []
    col, depth, iters = shade.render_image(
        world["tree"], torch.from_numpy(world["cam5"]), W, H,
        render_mode=mode, stats=stats, **pkw)
    assert col.shape == (H, W, 3) and iters.shape == (H, W)
    assert len(stats) == (2 if mode == 2 else 1)
    _check(ref_col, ref_depth, col, depth, 0.0)


@pytest.mark.parametrize("bounces,mirrors", [(1, (2,)), (3, (2, 3))])
def test_shade_gi_matches_jax(world, monkeypatch, bounces, mirrors):
    """terrain-64 holds materials 1 and 3, so (2, 3) makes the grass a
    mirror and exercises the mirror bounce."""
    cam5 = torch.from_numpy(world["cam5"])
    dirs = shade._normalize(shade.pixel_dirs_device(cam5, W, H))
    origins = cam5[0].expand_as(dirs).contiguous()
    px = torch.arange(W, dtype=torch.float32).repeat(H)
    py = torch.arange(H, dtype=torch.float32).repeat_interleave(W)

    def jax_rand(x, y, frame):
        return torch.from_numpy(np.array(jrng.pixel_rand(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), frame)))

    monkeypatch.setattr(shade.rng, "pixel_rand", jax_rand)
    ref_col, ref_depth, _ = jshade.shade_gi(
        world["jarr"], jnp.asarray(origins.numpy()),
        jnp.asarray(dirs.numpy()), jnp.asarray(px.numpy()),
        jnp.asarray(py.numpy()), 3, gi_bounces=bounces,
        mirror_values=mirrors)
    col, depth, _ = shade.shade_gi(world["tree"], origins, dirs, px, py, 3,
                                   gi_bounces=bounces,
                                   mirror_values=mirrors)
    _check(ref_col, ref_depth, col, depth, -1.0)
