"""The port's XLA brick reference engine (brick_trace.intersect_bricks, a
two-level Amanatides-Woo DDA in plain PyTorch) against the JAX package's,
on the scenarios of tests/test_brick_trace.py: sphere and terrain at 32^3
and 64^3, the multi-brick sphere, uniform-solid brick entries, rays that
miss everything, and inactive and non-finite rays.

The bar: hit and value equal on every ray, and depth and normal where
both hit; the hit voxel's position (voxel_pos, the voxel's corner plus
the normal offset) within one float32 ulp in [1, 2) (2.4e-7: JAX's jitted
decode contracts corner + normal * offset into a multiply-add, which
rounds once where the port rounds twice; voxels are 1/64 wide here, so
the hit voxel is the same); t within 1e-5 world units; iters equal on at
least 99% of rays, since the jitted JAX engine may contract multiply-adds
that the port rounds one by one (a DDA step count moves when a crossing
lands on a cell edge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import brick_trace as jbrick_trace
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import brick_scene, brick_trace
from test_traverse_batch import random_rays

T_TOL = 1e-5
VOXEL_TOL = 2.4e-7
MIN_ITERS = 0.99


def _scenes(vox):
    jt = build_np.build_octree_np(vox)
    tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size)
    return (jbrick_scene.brickify(jt).to_device(),
            brick_scene.brickify(tree).to_device("cpu"))


def _check(vox, o, d, active=None):
    jscene, scene = _scenes(vox)
    ref = jbrick_trace.intersect_bricks(
        jscene, jnp.asarray(o), jnp.asarray(d),
        active=None if active is None else jnp.asarray(active))
    got = brick_trace.intersect_bricks(
        scene, torch.from_numpy(o), torch.from_numpy(d),
        active=None if active is None else torch.from_numpy(active))
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    for f in ("value", "node"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_allclose(got["voxel_pos"], ref["voxel_pos"], rtol=0,
                               atol=VOXEL_TOL)
    h = got["hit"]
    for f in ("depth", "normal", "scale_exp2"):
        np.testing.assert_array_equal(got[f][h], ref[f][h], err_msg=f)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=0, atol=T_TOL)
    same_iters = (got["iters"] == ref["iters"]).mean()
    print(f"rays {h.size}, hits {h.sum()}, iters equal on {same_iters:.4f}")
    assert same_iters >= MIN_ITERS
    return got


@pytest.mark.parametrize("name,seed", [("sphere-32", 1), ("terrain-32", 2),
                                       ("terrain-64", 3),
                                       ("sphere-64-multibrick", 4)])
def test_intersect_bricks_matches_jax(name, seed):
    vox = {"sphere-32": lambda: make_sphere_voxels(32),
           "terrain-32": lambda: make_terrain_voxels(32),
           "terrain-64": lambda: make_terrain_voxels(64, seed=5),
           "sphere-64-multibrick": lambda: make_sphere_voxels(64, radius=24),
           }[name]()
    o, d = random_rays(256, seed=seed)
    got = _check(vox, o, d)
    assert 0 < got["hit"].sum() < got["hit"].size


def test_uniform_solid_brick_entry():
    o = np.array([[0.5, 1.5, 1.5], [1.5, 2.7, 1.5]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    got = _check(np.ones((64, 64, 64), np.uint8), o, d)
    assert got["hit"].all() and got["value"][0] == 1
    np.testing.assert_allclose(got["t"], [0.5, 0.7], atol=1e-3)


def test_miss_everything():
    o = np.array([[1.5, 2.5, 1.5], [0.2, 0.2, 0.2]], np.float32)
    d = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
    got = _check(make_sphere_voxels(64), o, d)
    assert not got["hit"].any()


def test_inactive_and_nonfinite_retired():
    o = np.array([[0.5, 1.5, 1.5], [np.nan, 1.5, 1.5], [0.5, 1.5, 1.5]],
                 np.float32)
    d = np.array([[1.0, 0.0, 0.0]] * 3, np.float32)
    got = _check(make_sphere_voxels(64), o, d,
                 active=np.array([True, True, False]))
    assert got["hit"].tolist() == [True, False, False]


def test_scene_on_another_device_raises():
    _, scene = _scenes(make_sphere_voxels(64))
    o = torch.zeros((1, 3), dtype=torch.float64).to(torch.float32)
    with pytest.raises(ValueError):
        brick_trace.intersect_bricks(scene, o.to("meta"), o)
