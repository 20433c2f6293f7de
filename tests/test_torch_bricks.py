"""The port's octree brick sharding (svo_raytracer_torch.parallel.bricks)
against the JAX package's parallel/bricks.py, on tests/test_bricks.py's
terrain-64 (seed 3), its 512 rays and its camera.

* split_bricks at levels 1 and 2 equals JAX's in every array (the port
  copies each subtree level by level where JAX walks it node by node),
  and BrickSet.from_reference carries JAX's set over unchanged;
* intersect_bricks_local (one device, every brick; KE's plain version)
  against JAX's: hits, values, nodes and depths exact, t within rtol
  2e-6 (4e-6 at level 2), as test_bricks.py holds JAX's to the monolith;
* over 4 gloo ranks on grid_mesh(2, 2) (tests/torch_ranks.job_bricks),
  make_brick_render against JAX's make_brick_render on its grid_mesh(2,
  2) at test_bricks.py's bars against the monolith (mode 3 rtol 1e-4 /
  atol 2e-4; mode 2 close on > 99% of pixels and within 0.35; mode 1
  heat where JAX has heat), and make_brick_train_step against JAX's
  (loss rtol 1e-5 / atol 1e-7, parameters rtol 1e-4 / atol 1e-6), its
  loss falling.  Mode 0 is held, as test_bricks.py holds JAX's, to the
  monolith's frame (the port's render_image): statistically, close
  within 1e-3 on > 98% of pixels.  JAX's jitted frame draws other random
  numbers (XLA fuses the sin hash's argument), so its mode-0 pixels are
  no reference for the port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from conftest import make_terrain_voxels
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.diff import render_diff as jrd
from svo_raytracer_tpu.parallel import bricks as JB
from svo_raytracer_tpu.parallel import mesh as jmesh
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import shade
from svo_raytracer_torch.parallel import bricks as B
from svo_raytracer_torch.utils.camera import Camera

FIELDS = ("child", "mask", "value", "normal", "orig", "corners", "n_nodes")


@pytest.fixture(scope="module")
def jtree():
    return jbuild_np.build_octree_np(make_terrain_voxels(64, seed=3))


@pytest.fixture(scope="module")
def tree(jtree):
    return octree.from_reference(jtree.child, jtree.mask, jtree.value,
                                 jtree.normal, jtree.n_nodes,
                                 jtree.world_size)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(7)
    n = 512
    o_out = np.array([1.5, 1.9, 1.9]) + rng.normal(0, 0.15, (n // 2, 3))
    o_in = rng.uniform(1.05, 1.95, (n // 2, 3))
    o = np.concatenate([o_out, o_in]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _cam():
    cam = Camera(pos=np.array([1.5, 1.7, 1.85]))
    cam.rotate(-0.5, 0.25)
    return cam.uniform().astype(np.float32)


@pytest.mark.parametrize("level", [1, 2])
def test_split_bricks_equals_jax(tree, jtree, level):
    got = B.split_bricks(tree, level=level)
    want = JB.split_bricks(jtree, level=level)
    assert (got.level, got.world_size) == (want.level, want.world_size)
    assert got.n_bricks == 8 ** level
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_split_bricks_of_a_device_tree(tree):
    got = B.split_bricks(tree.to_device("cpu"), level=1)
    want = B.split_bricks(tree, level=1)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_from_reference_carries_jax_bricks(tree, jtree):
    got = B.BrickSet.from_reference(JB.split_bricks(jtree, 1).to_device())
    want = B.split_bricks(tree, level=1)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError):
        B.BrickSet.from_reference(dict_set(want, corners=want.corners[:3]))


def dict_set(bs, **kw):
    class Ref:
        pass

    r = Ref()
    for f in FIELDS + ("level", "world_size"):
        setattr(r, f, kw.get(f, getattr(bs, f)))
    return r


@pytest.mark.parametrize("level,rtol", [(1, 2e-6), (2, 4e-6)])
def test_intersect_bricks_local_matches_jax(tree, jtree, rays, level, rtol):
    o, d = rays
    dbs = B.split_bricks(tree, level=level).to_device("cpu")
    got = B.intersect_bricks_local(dbs, torch.from_numpy(o),
                                   torch.from_numpy(d))
    jbs = JB.split_bricks(jtree, level=level).to_device()
    want = JB.intersect_bricks_local(jbs, jnp.asarray(o), jnp.asarray(d))
    h = np.asarray(want.hit)
    assert np.array_equal(got.hit.numpy(), h)
    assert 0.1 < h.mean() < 0.95
    for f in ("value", "node", "depth"):
        assert np.array_equal(getattr(got, f).numpy()[h],
                              np.asarray(getattr(want, f))[h]), f
    assert (got.node.numpy()[~h] == -1).all()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(want.t)[h],
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.normal.numpy()[h],
                               np.asarray(want.normal)[h], atol=1e-6)
    np.testing.assert_allclose(got.voxel_pos.numpy()[h],
                               np.asarray(want.voxel_pos)[h], rtol=rtol,
                               atol=rtol)


def test_device_bricks_refuse_an_uneven_shard(tree):
    bs = B.split_bricks(tree, level=1)

    class Mesh3:
        def size(self, axis):
            return 3

        def rank(self, axis):
            return 0

    with pytest.raises(ValueError, match="cannot shard"):
        bs.to_device("cpu", Mesh3())


@pytest.fixture(scope="module")
def run(tree, jtree, tmp_path_factory):
    cam5 = _cam()
    dt = jtree.to_device()
    jp = jrd.init_params(dt.arrays())
    target = jrd.render_diff(jp, dt.arrays(), jnp.asarray(cam5), 32, 16) * 0.8
    tt = (lambda a: torch.from_numpy(np.array(a)))
    inp = dict(tree=(tt(tree.child), tt(tree.mask), tt(tree.value),
                     tt(tree.normal), tree.n_nodes, tree.world_size),
               cam5=torch.from_numpy(cam5),
               params=(tt(jp.albedo), tt(jp.density)), target=tt(target))
    d = tmp_path_factory.mktemp("bricks")
    torch.save(inp, d / "in.pt")
    ranks = torch_ranks.run_ranks(torch_ranks.job_bricks, 4, d)
    jbs = JB.split_bricks(jtree, level=1).to_device()
    return dict(ranks=ranks, jbs=jbs, jp=jp, jarr=dt.arrays(),
                cam5=jnp.asarray(cam5), target=target,
                mesh=jmesh.grid_mesh(2, 2))


def test_ranks_hold_their_blocks_and_the_same_image(run):
    assert [r["ids"] for r in run["ranks"]] == [(0, 1, 2, 3), (4, 5, 6, 7),
                                                (0, 1, 2, 3), (4, 5, 6, 7)]
    for r in run["ranks"][1:]:
        for k in ("render0", "render1", "render2", "render3", "albedo",
                  "density", "loss"):
            assert torch.equal(r[k], run["ranks"][0][k]), k


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_brick_render_matches_jax(run, mode):
    W, H = 64, 32
    want = np.asarray(JB.make_brick_render(run["mesh"], run["jbs"], W, H,
                                           render_mode=mode)(run["jbs"],
                                                             run["cam5"]))
    got = run["ranks"][0][f"render{mode}"].numpy()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    if mode == 1:
        assert (got[want[..., 0] > 0, 0] > 0).all()
    elif mode == 2:
        close = np.isclose(got, want, rtol=1e-4, atol=2e-4).all(axis=-1)
        assert close.mean() > 0.99, close.mean()
        assert np.abs(got - want).max() < 0.35
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


def test_brick_render_gi_matches_monolith(run, tree):
    want, _, _ = shade.render_image(tree.to_device("cpu"),
                                    torch.from_numpy(_cam()), 32, 16,
                                    render_mode=0, frame_number=1)
    want = want.numpy()
    got = run["ranks"][0]["render0"].numpy()
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3).all(axis=-1)
    assert close.mean() > 0.98, close.mean()


def test_brick_train_step_matches_jax(run):
    p, loss = JB.make_brick_train_step(run["mesh"], run["jbs"], 32, 16,
                                       lr=1.0)(run["jp"], run["jbs"],
                                               run["cam5"], run["target"])
    got = run["ranks"][0]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got["albedo"].numpy(), np.asarray(p.albedo),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["density"].numpy(),
                               np.asarray(p.density), rtol=1e-4, atol=1e-6)


def test_brick_train_loss_falls(run):
    losses = [float(run["ranks"][0]["loss"])] + run["ranks"][0]["losses"]
    assert np.isfinite(losses).all()
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
