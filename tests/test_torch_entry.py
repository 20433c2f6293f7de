"""The entry point's analog (svo_raytracer_torch/entry.py) against
__graft_entry__.py: the 64^3 perlin scene's octree node for node and its
camera exactly, and the forward frame on the CPU against
``jax.jit(fn)(*args)`` of the JAX entry at the bar of
tests/test_torch_esvo_render.py: the primary hit mask (depth > 0) equal
on every pixel, and colour within 1e-4 on at least 98% of pixels.  The
camera's x = 1.5 is dyadic, so primaries start on a cube boundary, where
XLA's contracted multiply-adds take other step counts (ROADMAP.md §3);
the camera stays the reference's, and the measured share is printed."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from svo_raytracer_tpu.ops import shade as jshade
from svo_raytracer_torch import entry
from svo_raytracer_torch.ops import shade

TOL = 1e-4
MIN_CLOSE = 0.98


@pytest.fixture(scope="module")
def scenes():
    jtree, jcam5 = jentry._small_scene(64)
    tree, cam5 = entry.small_scene(64, "cpu")
    return jtree, jcam5, tree, cam5


def test_small_scene_matches_jax(scenes):
    jtree, jcam5, tree, cam5 = scenes
    assert tree.n_nodes == jtree.n_nodes and tree.device.type == "cpu"
    assert tree.world_size == jtree.world_size == 64
    for a, b in zip(tree.arrays(), jtree.arrays()):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b)[:jtree.n_nodes])
    np.testing.assert_array_equal(cam5.numpy(), np.asarray(jcam5))


def test_entry_forward_matches_jax(scenes):
    fn, args = jentry.entry()
    ref = np.asarray(jax.jit(fn)(*args))
    pfn, pargs = entry.entry("cpu")
    out = pfn(*pargs)
    assert tuple(out.shape) == (144, 256, 3) and out.dtype == torch.float32
    col = out.numpy()
    # mode 2 shades the sky on a primary miss; a hit's depth is > 0
    _, depth, _ = shade.render_image(*pargs, 256, 144, render_mode=2)
    _, jdepth, _ = jshade.render_image(*args, 256, 144, render_mode=2)
    hit, jhit = depth.numpy() > 0, np.asarray(jdepth) > 0
    close = np.abs(col - ref).max(-1) <= TOL
    print(f"hit pixels {hit.mean():.3f}; hit mask equal on "
          f"{(hit == jhit).mean():.5f}; colour within {TOL} on "
          f"{close.mean():.5f}")
    assert np.array_equal(hit, jhit)
    assert close.mean() >= MIN_CLOSE
    # the camera looks down on the terrain: every primary hits
    assert np.isfinite(col).all() and hit.mean() > 0.5


def test_entry_main_on_the_cpu(capsys):
    out = entry.main(["--cpu"])
    assert tuple(out.shape) == (144, 256, 3)
    assert "entry forward: (144, 256, 3) torch.float32" in capsys.readouterr().out
