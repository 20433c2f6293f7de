"""The port's canned scenes (svo_raytracer_torch/models/scenes.py) against
the JAX package's (svo_raytracer_tpu/models/scenes.py) at small scale, on
the CPU.

Tolerance: exact.  Each scene's node table equals JAX's slot for slot up
to n_nodes (scene_5_brick: every BrickScene table), and the camera
uniform and RenderConfig are the same.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svo_raytracer_tpu.models import scenes as jscenes
from svo_raytracer_torch.models import scenes
from test_torch_worldgen import _assert_tree_equal

CASES = [(1, 0.25), (2, 1 / 8), (3, 1 / 16), (4, 1 / 32), (5, 1 / 64)]


def _same_view(cam, jcam, cfg, jcfg):
    np.testing.assert_array_equal(cam.uniform(), jcam.uniform())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("n,scale", CASES)
def test_scene_equals_jax(n, scale):
    jtree, jcam, jcfg = jscenes.SCENES[n](scale=scale)
    tree, cam, cfg = scenes.SCENES[n](scale=scale, device="cpu")
    assert tree.device == torch.device("cpu")
    _assert_tree_equal(tree, jtree.to_numpy())
    _same_view(cam, jcam, cfg, jcfg)


def test_scene_5_brick_equals_jax():
    jscene, jcam, jcfg = jscenes.scene_5_brick(scale=1 / 64)
    scene, cam, cfg = scenes.scene_5_brick(scale=1 / 64)
    assert (scene.world_size, scene.grid_size, scene.n_mixed) == (
        jscene.world_size, jscene.grid_size, jscene.n_mixed)
    for f in ("l0_table", "brick_slot", "brick_attr", "occ_words", "attrs"):
        np.testing.assert_array_equal(np.asarray(getattr(scene, f)),
                                      np.asarray(getattr(jscene, f)),
                                      err_msg=f)
    _same_view(cam, jcam, cfg, jcfg)


def test_scene_5_brick_takes_an_array_heightmap():
    hm = scenes._fractal_heightmap(128, seed=3)
    scene, _, _ = scenes.scene_5_brick(scale=1 / 64, heightmap=hm)
    jscene, _, _ = jscenes.scene_5_brick(scale=1 / 64, heightmap=hm)
    np.testing.assert_array_equal(scene.attrs, np.asarray(jscene.attrs))
    with pytest.raises(ValueError, match="heightmap shape"):
        scenes.scene_5_brick(scale=1 / 64, heightmap=hm[:64, :64])
