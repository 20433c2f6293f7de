"""The port's K-hit chain and compositor (svo_raytracer_torch.diff.wave_diff,
on the CPU through K1's plain version) against the JAX package's
diff/wave_diff, whose chain runs the Pallas kernel in interpret mode.

One module fixture calls JAX's khit_chain once (K = 3, every ray of the
module, ~2 min eager; jitted it took longer to compile) on a 32^3 scene:
tests/test_wave_diff.py's two walls plus a solid block, so that the block
rays' stage-2 and stage-3 origins lie inside solid voxels.  The chain
must be equal in aidx and hitm and within 1e-6 in ds and light (measured:
equal in every field); compositor values and gradients on the same chain
arrays within rtol 1e-5; the hand-written backward equal to autograd of
composite_khit_ref within rtol 1e-4 / atol 1e-6 (tests/test_wave_diff.py's);
finite differences within rtol 5e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from svo_raytracer_tpu.core import build_np as jbuild_np
from svo_raytracer_tpu.diff import wave_diff as jwd
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.diff import wave_diff as wd
from svo_raytracer_torch.ops import brick_scene, shade, wavefront

N_WALL, N_BLOCK, N_RANDOM = 8, 16, 24
FIELDS = ("aidx", "hitm", "ds", "light")


def scene_voxels():
    """Two parallel 1-voxel walls normal to +z (every center ray crosses
    wall A at z = 10, then wall B at z = 20) and a 6x6x12 solid block."""
    v = np.zeros((32, 32, 32), np.int32)
    v[8:24, 8:24, 10] = 1
    v[8:24, 8:24, 20] = 2
    v[25:31, 2:8, 4:16] = 3
    return v


def fixture_rays():
    """(o, d) float32: 8 center rays along +z through both walls, 16 rays
    into the block's front face, 24 seeded random rays from inside the
    cube (some start inside solid or miss everything)."""
    rng = np.random.default_rng(0)
    n = N_WALL + N_BLOCK + N_RANDOM
    o = rng.uniform(1.05, 1.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o[:N_WALL] = np.stack([np.linspace(1.45, 1.55, N_WALL),
                           np.full(N_WALL, 1.5), np.full(N_WALL, 1.05)], 1)
    d[:N_WALL] = (0.0, 0.0, 1.0)
    b = slice(N_WALL, N_WALL + N_BLOCK)
    o[b, 0] = rng.uniform(1 + 25.5 / 32, 1 + 30.5 / 32, N_BLOCK)
    o[b, 1] = rng.uniform(1 + 2.5 / 32, 1 + 7.5 / 32, N_BLOCK)
    o[b, 2] = 1.05
    d[b] = np.stack([rng.uniform(-0.2, 0.2, N_BLOCK),
                     rng.uniform(-0.2, 0.2, N_BLOCK), np.ones(N_BLOCK)], 1)
    return o, d


@pytest.fixture(scope="module")
def walls():
    v = scene_voxels()
    jws = jwavefront.prepare(jbrick_scene.brickify(
        jbuild_np.build_octree_np(v)))
    ws = wavefront.prepare(brick_scene.brickify(build_np.build_octree_np(v)),
                           "cpu")
    o, d = fixture_rays()
    warr = (jws.l0_occ, jws.l0_mixed, jws.brick_slot, jws.occ_words,
            jws.attr_comb, jws.slot_cell, jws.sc_words, jws.l0_sc)
    jchain = jwd.khit_chain(warr, jnp.asarray(o), jnp.asarray(d), 3,
                            jws.grid_size, jws.world_size, jws.capacity,
                            interpret=True)
    stats = []
    chain = wd.khit_chain(ws, torch.from_numpy(o), torch.from_numpy(d), 3,
                          stats=stats)
    return dict(v=v, jws=jws, ws=ws, o=o, d=d, stats=stats, chain=chain,
                jchain=wd.HitChain(*(np.array(a) for a in jchain)))


@pytest.mark.parametrize("field", FIELDS)
def test_chain_equals_jax(walls, field):
    got = getattr(walls["chain"], field).numpy()
    want = getattr(walls["jchain"], field)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 48)
    if field in ("aidx", "hitm"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_chain_covers_rays_inside_solid(walls):
    """The block rays' stages 2 and 3 start inside a solid voxel and hit
    at once, the walls' center rays see both walls and nothing behind."""
    v, stats, chain = walls["v"], walls["stats"], walls["chain"]
    hitm = chain.hitm.numpy()
    blk = slice(N_WALL, N_WALL + N_BLOCK)
    for k in (1, 2):
        o = stats[k]["origins"][blk].numpy()
        vox = np.floor((o - 1.0) * 32).astype(int)
        assert (v[vox[:, 0], vox[:, 1], vox[:, 2]] != 0).all(), k
        assert stats[k]["active"][blk].all() and hitm[k, blk].all()
    assert [s["rays"] for s in stats] == [48, 30, 30]
    assert hitm[:2, :N_WALL].all() and not hitm[2, :N_WALL].any()
    aidx = chain.aidx.numpy()
    assert (aidx[0, :N_WALL] != aidx[1, :N_WALL]).all()
    # the random rays include misses, whose next origins are not finite
    assert not hitm[0, N_WALL + N_BLOCK:].all()


def test_d_unit_and_advance_past_equal_jax(walls):
    """The unit directions bit for bit, and the next stage's origins
    from the same hit records."""
    o, d = walls["o"], walls["d"]
    np.testing.assert_array_equal(
        wd.d_unit(torch.from_numpy(d)).numpy(),
        np.asarray(jwd.d_unit(jnp.asarray(d))))
    rng = np.random.default_rng(1)
    du = np.array(jwd.d_unit(jnp.asarray(d)))
    res = dict(t=rng.uniform(0.0, 0.9, 48).astype(np.float32),
               scale_exp2=rng.choice([1 / 32, 1 / 1024], 48).astype(
                   np.float32))
    du[0, 0] = 5e-5     # a component the clamp replaces

    class Res:
        pass

    jres, tres = Res(), Res()
    for k, a in res.items():
        setattr(jres, k, jnp.asarray(a))
        setattr(tres, k, torch.from_numpy(a))
    np.testing.assert_array_equal(
        wd._advance_past(torch.from_numpy(o), torch.from_numpy(du),
                         tres).numpy(),
        np.asarray(jwd._advance_past(jnp.asarray(o), jnp.asarray(du), jres)))


def test_init_params_equal_jax(walls):
    ws, jws = walls["ws"], walls["jws"]
    assert wd.param_size(ws) == jwd.param_size(jws)
    p, jp = wd.init_params(ws, 2.0), jwd.init_params(jws, 2.0)
    for got, want in zip(p, jp):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(p.albedo.numpy(), axis=0)) == 4


def _tables(ws, seed=2):
    """Seeded tables around the init: albedo in (0, 1), density in
    (-3, 6) (both signs of the softplus argument)."""
    rng = np.random.default_rng(seed)
    n = wd.param_size(ws)
    return (rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32),
            rng.uniform(-3.0, 6.0, n).astype(np.float32))


def test_composite_matches_jax(walls):
    """Forward values and both gradients of the port's composite_khit
    equal JAX's on the JAX chain's arrays, within rtol 1e-5."""
    jc = walls["jchain"]
    alb, den = _tables(walls["ws"])
    d = wd.d_unit(torch.from_numpy(walls["d"]))
    bg = shade.sky(d)
    g_out = np.random.default_rng(3).normal(size=(48, 3)).astype(np.float32)
    chain = wd.HitChain(*(torch.from_numpy(a) for a in jc))
    a_t = torch.from_numpy(alb).requires_grad_()
    d_t = torch.from_numpy(den).requires_grad_()
    col = wd.composite_khit(a_t, d_t, chain, bg)
    ga, gd = torch.autograd.grad((col * torch.from_numpy(g_out)).sum(),
                                 (a_t, d_t))
    jchain = jwd.HitChain(*(jnp.asarray(a) for a in jc))
    jbg = jnp.asarray(bg.numpy())

    def jloss(a, dn):
        return jnp.sum(jwd.composite_khit(a, dn, jchain, jbg) * g_out)

    jcol = jwd.composite_khit(jnp.asarray(alb), jnp.asarray(den), jchain,
                              jbg)
    jga, jgd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(alb),
                                               jnp.asarray(den))
    np.testing.assert_allclose(col.detach().numpy(), np.asarray(jcol),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-5,
                               atol=1e-7)
    assert (gd.numpy() != 0).sum() > 30


@pytest.mark.parametrize("init_density", [10.0, 2.0])
def test_custom_backward_matches_autograd(walls, init_density):
    ws, chain = walls["ws"], walls["chain"]
    p = wd.init_params(ws, init_density)
    bg = shade.sky(wd.d_unit(torch.from_numpy(walls["d"])))
    g_out = torch.from_numpy(
        np.random.RandomState(0).randn(48, 3).astype(np.float32))
    out = []
    for fn in (wd.composite_khit, wd.composite_khit_ref):
        a = p.albedo.clone().requires_grad_()
        dn = p.density.clone().requires_grad_()
        col = fn(a, dn, chain, bg)
        out.append((col.detach(),) + torch.autograd.grad(
            (col * g_out).sum(), (a, dn)))
    (c1, ga, gd), (c2, ra, rd_) = out
    np.testing.assert_allclose(ga.numpy(), ra.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), rd_.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), atol=1e-6)
    assert (gd != 0).any() and (ga != 0).any()


def test_gradcheck_with_scatter_collisions():
    """float64 gradcheck of the hand-written backward on a random chain
    whose indices repeat within and across stages."""
    rng = np.random.default_rng(4)
    K, B, n = 3, 12, 7
    chain = wd.HitChain(
        aidx=torch.from_numpy(rng.integers(0, n, (K, B)).astype(np.int32)),
        hitm=torch.from_numpy((rng.uniform(size=(K, B)) < 0.8).astype(
            np.float64)),
        ds=torch.from_numpy(rng.uniform(0.05, 0.5, (K, B))),
        light=torch.from_numpy(rng.uniform(0.3, 1.0, (K, B))))
    assert len(np.unique(chain.aidx.numpy())) < K * B
    bg = torch.from_numpy(rng.uniform(0.2, 1.0, (B, 3)))
    alb = torch.from_numpy(rng.uniform(0.1, 0.9, (n, 3))).requires_grad_()
    den = torch.from_numpy(rng.uniform(-2.0, 3.0, n)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, d: wd.composite_khit(a, d, chain, bg), (alb, den))


def test_density_grad_matches_fd(walls):
    chain = walls["chain"]
    p = wd.init_params(walls["ws"], init_density=2.0)
    bg = shade.sky(wd.d_unit(torch.from_numpy(walls["d"])))

    def loss(den):
        col = wd.composite_khit(p.albedo, den, chain, bg)
        return torch.mean(col ** 2)

    den = p.density.clone().requires_grad_()
    g = torch.autograd.grad(loss(den), den)[0].numpy()
    front = int(chain.aidx[0, 4])
    eps = 1e-3

    def shifted(delta):
        d2 = p.density.clone()
        d2[front] += delta
        return float(loss(d2))

    fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
    assert np.isclose(g[front], fd, rtol=5e-2, atol=1e-7), (g[front], fd)


def test_gradient_flows_through_visibility(walls):
    """Raising the front wall's density shrinks the gradient with respect
    to the back wall's albedo: occlusion is differentiable."""
    chain = walls["chain"]
    p = wd.init_params(walls["ws"], init_density=2.0)
    bg = shade.sky(wd.d_unit(torch.from_numpy(walls["d"])))
    aidx = chain.aidx.numpy()
    wall = slice(0, N_WALL)
    front_ids = torch.from_numpy(np.unique(aidx[0, wall]).astype(np.int64))
    back_ids = np.unique(aidx[1, wall])
    sub = wd.HitChain(*(a[:, wall] for a in chain))

    def loss_of(alb, den):
        col = wd.composite_khit(alb, den, sub, bg[wall])
        return torch.mean(col ** 2)

    def back_grad_mag(density):
        a = p.albedo.clone().requires_grad_()
        ga = torch.autograd.grad(loss_of(a, density), a)[0].numpy()
        return float(np.abs(ga[back_ids]).sum())

    g_lo = back_grad_mag(p.density)
    # softplus(62) * ds ~ 1.9: the front alpha ~0.86 hides the back wall
    denser = p.density.clone()
    denser[front_ids] += 60.0
    g_hi = back_grad_mag(denser)
    assert g_hi < g_lo * 0.35, (g_lo, g_hi)
    front = int(aidx[0, 0])
    eps = 1e-3

    def shifted(delta):
        d2 = p.density.clone()
        d2[front] += delta
        return float(loss_of(p.albedo, d2))

    fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
    den = p.density.clone().requires_grad_()
    g = torch.autograd.grad(loss_of(p.albedo, den), den)[0].numpy()
    assert np.isclose(g[front], fd, rtol=5e-2, atol=1e-8)


def test_softplus_agrees_with_jax():
    """torch's softplus (x itself above 20) against jax.nn.softplus
    (logaddexp(x, 0)): equal at test_wave_diff.py's init + 60 and above
    16, within 3 ulp below (3 measured on 400,000 values in (-40, 80))."""
    x = np.asarray([-30.0, -1.0, 0.0, 1e-3, 2.0, 10.0, 16.5, 19.5, 20.5,
                    62.0, 70.0], np.float32)
    got = F.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(x))
    np.testing.assert_array_max_ulp(got, want, maxulp=3)
    np.testing.assert_array_equal(got[x > 16], want[x > 16])


@pytest.mark.parametrize("layout", ["paged", "attr16", "attr2d"])
def test_rejects_scenes_whose_ids_are_not_voxels(walls, layout):
    if layout == "paged":
        ws = wavefront.prepare(chip_smoke.sparse_paged_scene(), "cpu")
    else:
        scene = brick_scene.brickify(build_np.build_octree_np(walls["v"]))
        ws = wavefront.prepare(scene, "cpu", **{layout: True})
    o = torch.from_numpy(walls["o"][:4])
    d = torch.from_numpy(walls["d"][:4])
    for call in (lambda: wd.param_size(ws), lambda: wd.init_params(ws),
                 lambda: wd.khit_chain(ws, o, d, 2),
                 lambda: wd.make_wave_train_step(ws, 4, 4, K=2)):
        with pytest.raises(ValueError, match="flat int32 attr_comb"):
            call()
