"""Checkpoints across the two packages (svo_raytracer_torch.diff.checkpoint
against svo_raytracer_tpu.diff.checkpoint): a parameter file saved by
either loads in the other with equal arrays and step, the tree .npz
round-trips both ways, and parameters carried from the JAX package
(params_from_reference) give JAX's loss on the sphere-16 scene (within
rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.diff import checkpoint as jckpt
from svo_raytracer_tpu.diff import render_diff as jrd
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.diff import checkpoint as ckpt
from svo_raytracer_torch.diff import render_diff as rd
from svo_raytracer_torch.diff import wave_diff as wd
from svo_raytracer_torch.utils.camera import Camera


@pytest.fixture(scope="module")
def sphere():
    v = make_sphere_voxels(16, radius=5)
    return jbuild_np.build_octree_np(v), build_np.build_octree_np(v)


def _noisy_reference(jtree, seed=0):
    """JAX VoxelParams off the init: albedo + 0.3 N(0, 1), density in
    (2, 12)."""
    jp = jrd.init_params(jtree.to_device().arrays())
    rng = np.random.default_rng(seed)
    alb = np.asarray(jp.albedo) + 0.3 * rng.normal(
        size=jp.albedo.shape).astype(np.float32)
    den = rng.uniform(2.0, 12.0, jp.density.shape).astype(np.float32)
    return jrd.VoxelParams(jnp.asarray(alb), jnp.asarray(den))


def test_jax_params_load_in_port(sphere, tmp_path):
    jp = _noisy_reference(sphere[0])
    path = str(tmp_path / "jax.npz")
    jckpt.save_params(jp, path, step=17)
    p, step = ckpt.load_params(path, "cpu")
    assert step == 17 and isinstance(p, rd.VoxelParams)
    np.testing.assert_array_equal(p.albedo.numpy(), np.asarray(jp.albedo))
    np.testing.assert_array_equal(p.density.numpy(), np.asarray(jp.density))


@pytest.mark.parametrize("kind", ["voxel", "wave"])
def test_port_params_load_in_jax(sphere, tmp_path, kind):
    jp = _noisy_reference(sphere[0], seed=1)
    p = ckpt.params_from_reference(jp.albedo, jp.density, "cpu", kind)
    assert isinstance(p, ckpt.KINDS[kind])
    path = str(tmp_path / "port.npz")
    ckpt.save_params(p, path, step=3)
    q, step = jckpt.load_params(path)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(q.albedo), p.albedo.numpy())
    np.testing.assert_array_equal(np.asarray(q.density), p.density.numpy())
    back, step = ckpt.load_params(path, "cpu", kind)
    assert step == 3 and isinstance(back, ckpt.KINDS[kind])
    assert torch.equal(back.albedo, p.albedo)
    assert torch.equal(back.density, p.density)


def test_tree_npz_round_trips_between_packages(sphere, tmp_path):
    jtree, tree = sphere
    files = [str(tmp_path / f"{n}.npz") for n in ("host", "device", "jax")]
    ckpt.save_tree_npz(tree, files[0])
    ckpt.save_tree_npz(tree.to_device("cpu"), files[1])
    jckpt.save_tree_npz(jtree, files[2])
    for path in files:
        got = ckpt.load_tree_npz(path)
        want = jckpt.load_tree_npz(path)
        assert (got.n_nodes, got.world_size) == (tree.n_nodes, 16)
        for f in ("child", "mask", "value", "normal"):
            a = getattr(got, f)
            assert a.shape == (tree.n_nodes,)
            np.testing.assert_array_equal(a, getattr(tree, f)[:tree.n_nodes])
            np.testing.assert_array_equal(a, getattr(want, f))
    assert ckpt.load_tree_npz(files[0]).to_device("cpu").n_nodes \
        == tree.n_nodes


def test_reference_params_give_jax_loss(sphere):
    """Weights trained by the JAX package, carried into the port, give
    the same loss on the same target."""
    jtree, tree = sphere
    jarr = jtree.to_device().arrays()
    cam5 = Camera(pos=np.array([1.5, 1.5, 2.2])).uniform().astype(np.float32)
    W = H = 24
    jp = _noisy_reference(jtree, seed=2)
    target = np.array(jrd.render_diff(jrd.init_params(jarr), jarr,
                                      jnp.asarray(cam5), W, H))
    want = float(jrd.pixel_loss(jp, jarr, jnp.asarray(cam5),
                                jnp.asarray(target), W, H))
    p = ckpt.params_from_reference(np.asarray(jp.albedo),
                                   np.asarray(jp.density), "cpu")
    got = float(rd.pixel_loss(p, tree.to_device("cpu"),
                              torch.from_numpy(cam5),
                              torch.from_numpy(target), W, H))
    assert want > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_params_from_reference_checks_its_input():
    alb = np.zeros((5, 3), np.float32)
    for a, d in ((alb, np.zeros(4, np.float32)),
                 (alb.astype(np.float64), np.zeros(5, np.float32)),
                 (alb[:, :2], np.zeros(5, np.float32))):
        with pytest.raises(ValueError):
            ckpt.params_from_reference(a, d, "cpu", "wave")
    p = ckpt.params_from_reference(alb, np.ones(5, np.float32), "cpu",
                                   "wave")
    assert isinstance(p, wd.WaveParams) and p.density.sum() == 5
