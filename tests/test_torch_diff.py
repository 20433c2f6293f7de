"""The port's differentiable ESVO render (svo_raytracer_torch.diff.render_diff,
on the CPU through KE's plain version) against the JAX package's
diff/render_diff, on tests/test_diff.py's scenarios: the 16^3 sphere seen
from (1.5, 1.5, 2.2) at 24x24 and 32x32.

Tolerances: images within 1e-5, pixel-loss gradients within rtol 1e-4 /
atol 1e-7, finite differences within rtol 5e-2 (test_diff.py's), and the
per-step losses of 5 SGD steps from the same noisy albedo within rtol
1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.diff import render_diff as jrd
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.diff import render_diff as rd
from svo_raytracer_torch.utils.camera import Camera


@pytest.fixture(scope="module")
def scene():
    v = make_sphere_voxels(16, radius=5)
    jtree = jbuild_np.build_octree_np(v).to_device()
    tree = build_np.build_octree_np(v).to_device("cpu")
    cam5 = Camera(pos=np.array([1.5, 1.5, 2.2])).uniform().astype(np.float32)
    return dict(jarr=jtree.arrays(), tree=tree, jcam=jnp.asarray(cam5),
                cam=torch.from_numpy(cam5))


def _jparams(p):
    return jrd.VoxelParams(jnp.asarray(p.albedo.numpy()),
                           jnp.asarray(p.density.numpy()))


def _rows(a, n):
    """The first n rows of a JAX table; the rows past the port's nodes
    (the JAX tree's padding) must be untouched."""
    a = np.asarray(a)
    return a[:n], a[n:]


def test_init_params_equal_jax(scene):
    tree = scene["tree"]
    p = rd.init_params(tree)
    jp = jrd.init_params(scene["jarr"])
    for got, want in zip(p, jp):
        head, tail = _rows(want, tree.n_nodes)
        assert np.array_equal(got.numpy(), head)
    assert (np.asarray(jp.albedo)[tree.n_nodes:] == 0.5).all()


@pytest.mark.parametrize("size", [24, 32])
def test_render_matches_jax(scene, size):
    p = rd.init_params(scene["tree"])
    img = rd.render_diff(p, scene["tree"], scene["cam"], size, size)
    want = np.asarray(jrd.render_diff(jrd.init_params(scene["jarr"]),
                                      scene["jarr"], scene["jcam"], size,
                                      size))
    assert img.shape == (size, size, 3)
    assert np.isfinite(img.numpy()).all()
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=1e-5)


def _grads(scene, target_scale, W=24, H=24):
    """Port and JAX pixel-loss gradients against the same target (a
    scaled JAX render, or zeros)."""
    p = rd.init_params(scene["tree"])
    jp = jrd.init_params(scene["jarr"])
    tgt = np.asarray(jrd.render_diff(jp, scene["jarr"], scene["jcam"], W, H)
                     ) * target_scale
    _, grads = rd.loss_and_grads(
        lambda q: rd.pixel_loss(q, scene["tree"], scene["cam"],
                                torch.from_numpy(tgt), W, H), p)
    jgrads = jax.grad(jrd.pixel_loss)(jp, scene["jarr"], scene["jcam"],
                                      jnp.asarray(tgt), W, H)
    return p, torch.from_numpy(tgt), grads, jgrads


@pytest.mark.parametrize("field", ["albedo", "density"])
def test_pixel_loss_grads_match_jax(scene, field):
    _, _, grads, jgrads = _grads(scene, 0.5)
    got = getattr(grads, field).numpy()
    head, tail = _rows(getattr(jgrads, field), scene["tree"].n_nodes)
    np.testing.assert_allclose(got, head, rtol=1e-4, atol=1e-7)
    assert (tail == 0).all()
    assert (np.abs(got) > 1e-6).any()


def test_grad_matches_finite_difference(scene):
    W = H = 24
    p, target, grads, _ = _grads(scene, 0.5)
    ga = grads.albedo.numpy()
    nz = np.nonzero(np.abs(ga[:, 0]) > 1e-5)[0]
    assert nz.size > 3, "some visible voxels must receive albedo gradients"
    for node in nz[:3]:
        fd = rd.finite_difference_grad(p, scene["tree"], scene["cam"],
                                       target, W, H, int(node), 0)
        assert np.isclose(ga[node, 0], fd, rtol=5e-2, atol=1e-6), (
            f"node {node}: autograd {ga[node, 0]} vs fd {fd}")
    assert (np.abs(grads.density.numpy()) > 1e-6).any()


def test_gradients_are_local(scene):
    """Nodes no ray hits (air, value 0) get exactly zero gradient."""
    _, _, grads, _ = _grads(scene, 0.0)
    air = scene["tree"].value.numpy() == 0
    assert air.any()
    assert np.all(grads.albedo.numpy()[air] == 0.0)
    assert np.all(grads.density.numpy()[air] == 0.0)


def test_sky_only_zero_grads():
    tree = build_np.build_octree_np(np.zeros((8, 8, 8), np.uint8)
                                    ).to_device("cpu")
    cam5 = torch.from_numpy(Camera().uniform().astype(np.float32))
    p = rd.init_params(tree)
    loss, grads = rd.loss_and_grads(
        lambda q: rd.pixel_loss(q, tree, cam5, torch.zeros(8, 8, 3), 8, 8),
        p)
    assert float(loss) > 0
    assert np.all(grads.albedo.numpy() == 0.0)
    assert np.all(grads.density.numpy() == 0.0)


def _noisy(p0):
    noise = np.random.default_rng(0).normal(size=tuple(p0.albedo.shape))
    return rd.VoxelParams(p0.albedo + 0.3 * torch.from_numpy(
        noise.astype(np.float32)), p0.density.clone())


def test_train_losses_match_jax(scene):
    """Five SGD steps (lr 300) from the same noisy albedo: the port's
    losses equal JAX train_step's within rtol 1e-3."""
    W = H = 32
    p0 = rd.init_params(scene["tree"])
    target = rd.render_diff(p0, scene["tree"], scene["cam"], W, H)
    params = _noisy(p0)
    # JAX's tables run past the port's nodes: pad with its own init rows
    jp0 = jrd.init_params(scene["jarr"])
    n = scene["tree"].n_nodes
    jparams = jrd.VoxelParams(
        jnp.asarray(np.concatenate([params.albedo.numpy(),
                                    np.asarray(jp0.albedo)[n:]])),
        jnp.asarray(np.asarray(jp0.density)))
    got, want = [], []
    for _ in range(5):
        params, loss = rd.train_step(params, scene["tree"], scene["cam"],
                                     target, W, H, lr=300.0)
        jparams, jloss = jrd.train_step(jparams, scene["jarr"],
                                        scene["jcam"],
                                        jnp.asarray(target.numpy()), W, H,
                                        lr=300.0)
        got.append(float(loss))
        want.append(float(jloss))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(params.albedo.numpy(),
                               np.asarray(jparams.albedo)[:n], atol=1e-4)


def test_training_recovers_albedo(scene):
    """Perturb albedo, train against the clean render: 40 steps bring the
    loss below 0.2 of its start (test_diff.py's criterion)."""
    W = H = 32
    p0 = rd.init_params(scene["tree"])
    target = rd.render_diff(p0, scene["tree"], scene["cam"], W, H)
    params = _noisy(p0)
    losses = []
    for _ in range(40):
        params, loss = rd.train_step(params, scene["tree"], scene["cam"],
                                     target, W, H, lr=300.0)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2, f"loss did not fall: {losses}"
    assert all(np.isfinite(losses))
