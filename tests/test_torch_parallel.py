"""The port's row-sharded ESVO render and train step
(svo_raytracer_torch.parallel.render_sharded) over 4 gloo ranks on the CPU
(KE's plain version), against the JAX package's make_sharded_render and
make_sharded_train_step on its tile_mesh(4) of virtual CPU devices, on
tests/test_parallel.py's scene: the 16^3 sphere on a slab, seen from
(1.5, 1.5, 2.2) at 32x32.

Tolerances are test_parallel.py's: images within atol 2e-5 of the port's
single-process render_image, train steps within loss rtol 1e-5 and
parameters atol 1e-5 of JAX's sharded step and of the port's unsharded
step; 15 steps at lr 300 from noisy albedo halve the loss.  Against JAX's
sharded images the bar is atol 2e-5 on at least 98% of pixels: XLA
contracts multiply-adds in the jitted traversal, which moves iteration
counts of grazing rays and so heatmap pixels and shadow-ray results (the
cross-package bar of tests/test_torch_esvo_render.py).  The ranks
(tests/torch_ranks.job_parallel) all hold the same images and
parameters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from conftest import make_sphere_voxels
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.diff import render_diff as jrd
from svo_raytracer_tpu.parallel import mesh as jmesh
from svo_raytracer_tpu.parallel import render_sharded as jrs
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.diff import render_diff as rd
from svo_raytracer_torch.ops import shade
from svo_raytracer_torch.utils.camera import Camera

W = H = 32


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    v = make_sphere_voxels(16, radius=5)
    v[:, :2, :] = 1
    jtree = jbuild_np.build_octree_np(v).to_device()
    cam5 = Camera(pos=np.array([1.5, 1.5, 2.2])).uniform().astype(np.float32)
    jcam = jnp.asarray(cam5)
    jp = jrd.init_params(jtree.arrays())
    target = jrd.render_diff(jp, jtree.arrays(), jcam, W, H) * 0.7
    target0 = jrd.render_diff(jp, jtree.arrays(), jcam, W, H)
    t = jtree.to_numpy()
    gen = np.random.default_rng(1)
    noisy = (np.asarray(jp.albedo)
             + 0.3 * gen.normal(size=jp.albedo.shape)).astype(np.float32)

    def tt(a):
        return torch.from_numpy(np.array(a))

    inp = dict(tree=(tt(t.child), tt(t.mask), tt(t.value), tt(t.normal),
                     t.n_nodes, t.world_size),
               cam5=torch.from_numpy(cam5), params=(tt(jp.albedo),
                                                   tt(jp.density)),
               noisy=(torch.from_numpy(noisy), tt(jp.density)),
               target=tt(target), target0=tt(target0))
    d = tmp_path_factory.mktemp("parallel")
    torch.save(inp, d / "in.pt")
    ranks = torch_ranks.run_ranks(torch_ranks.job_parallel, 4, d)
    return dict(ranks=ranks, inp=inp, jtree=jtree, jcam=jcam, jp=jp,
                target=target)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_sharded_render_matches_single(run, mode):
    inp = run["inp"]
    tree = octree.from_reference(*inp["tree"]).to_device("cpu")
    want, _, _ = shade.render_image(tree, inp["cam5"], W, H,
                                    render_mode=mode)
    got = run["ranks"][0][f"render{mode}"]
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_sharded_render_matches_jax(run, mode):
    m = jmesh.tile_mesh(4)
    want = np.asarray(jrs.make_sharded_render(m, W, H, render_mode=mode)(
        run["jtree"].arrays(), run["jcam"]))
    got = run["ranks"][0][f"render{mode}"].numpy()
    close = (np.abs(got - want) <= 2e-5).all(-1)
    assert close.mean() >= 0.98, close.mean()


def test_sharded_train_step_matches_jax(run):
    m = jmesh.tile_mesh(4)
    p, loss = jrs.make_sharded_train_step(m, W, H, lr=1.0)(
        run["jp"], run["jtree"].arrays(), run["jcam"], run["target"])
    got = run["ranks"][0]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["albedo"].numpy(), np.asarray(p.albedo),
                               atol=1e-5)
    np.testing.assert_allclose(got["density"].numpy(),
                               np.asarray(p.density), atol=1e-5)


def test_sharded_train_step_matches_unsharded(run):
    inp = run["inp"]
    tree = octree.from_reference(*inp["tree"]).to_device("cpu")
    p, loss = rd.train_step(rd.VoxelParams(*inp["params"]), tree,
                            inp["cam5"], inp["target"], W, H, lr=1.0)
    got = run["ranks"][0]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["albedo"].numpy(), p.albedo.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got["density"].numpy(), p.density.numpy(),
                               atol=1e-5)


def test_ranks_hold_the_same_results(run):
    first = run["ranks"][0]
    for other in run["ranks"][1:]:
        for k in ("render1", "render2", "render3", "albedo", "density",
                  "loss"):
            assert torch.equal(other[k], first[k]), k
        assert other["losses"] == first["losses"]


def test_sharded_train_loss_decreases(run):
    losses = run["ranks"][0]["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, losses


def test_uneven_height_rejected(run):
    assert "must divide over 4 tiles" in run["ranks"][0]["uneven"]


def test_mode_0_refused(run):
    assert "modes 1/2/3" in run["ranks"][0]["mode0"]


def test_group_and_host_rows(run):
    """init_distributed is idempotent and refuses another backend; the
    global tile mesh spans the 4 ranks of this host, which own all 32
    rows (LOCAL_RANK / LOCAL_WORLD_SIZE as distributed.spawn sets them)."""
    for r, out in enumerate(run["ranks"]):
        assert "already runs 'gloo'" in out["other_backend"]
        assert out["tile_rank"] == (r, 4, {"tiles": 4})
        assert tuple(out["host_rows"]) == (0, 32)
