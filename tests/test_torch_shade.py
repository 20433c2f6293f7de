"""Port shading and decode helpers vs the JAX package, elementwise on the
same seeded inputs: within 1e-6 with NaN at the same positions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_raytracer_tpu.ops import brick_trace as jbrick_trace
from svo_raytracer_tpu.ops import rng as jrng
from svo_raytracer_tpu.ops import shade as jshade
from svo_raytracer_torch.ops import brick_trace, rng, shade

TOL = 1e-6


def _close(ref, got, tol=TOL):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape
    assert np.array_equal(np.isnan(ref), np.isnan(got))
    ok = ~np.isnan(ref)
    assert np.abs(ref[ok].astype(np.float64)
                  - got[ok].astype(np.float64)).max(initial=0) <= tol


def _unit(gen, n):
    v = gen.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_decode_hits():
    gen = np.random.default_rng(0)
    n, ws = 4096, 1024
    value = gen.integers(0, 4, n)
    digits = gen.integers(0, 10, (n, 3))
    raw = digits[:, 0] + 10 * digits[:, 1] + 100 * digits[:, 2]
    raw[::50] = 555                              # zero vector: NaN normal
    raw[1::50] = 0                               # no normal
    depth = gen.integers(5, 11, n)
    attr = (value | (raw << 8) | (depth << 24)).astype(np.int32)
    hit = gen.uniform(size=n) < 0.7
    vox = gen.integers(0, ws, (n, 3)).astype(np.int32)
    vox[~hit] = -1
    t_vox = gen.uniform(0, 1500, n).astype(np.float32)
    iters = gen.integers(0, 300, n).astype(np.int32)
    o = gen.uniform(0.5, 2.5, (n, 3)).astype(np.float32)
    d = _unit(gen, n)
    ref = jbrick_trace.decode_hits(
        ws, jnp.asarray(o), jnp.asarray(d), jnp.asarray(hit),
        jnp.asarray(attr), *(jnp.asarray(vox[:, i]) for i in range(3)),
        jnp.asarray(t_vox), jnp.asarray(iters))
    got = brick_trace.decode_hits(
        ws, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(hit),
        torch.from_numpy(attr), *(torch.from_numpy(vox[:, i].copy())
                                  for i in range(3)),
        torch.from_numpy(t_vox), torch.from_numpy(iters))
    assert got.normal[::50].isnan().all()        # raw 555 stays NaN
    for field in ref._fields:
        _close(getattr(ref, field), getattr(got, field))


def test_sky_material_and_bounces():
    gen = np.random.default_rng(1)
    n = 4096
    d = _unit(gen, n)
    normal = _unit(gen, n)
    normal[::64] = np.array([0.0, 1.0, 0.0], np.float32)   # axis-aligned
    normal[1::64] = np.array([1.0, 0.0, 0.0], np.float32)  # |w.x| > 0.1
    r = gen.uniform(size=n).astype(np.float32)
    value = gen.integers(0, 5, n).astype(np.int32)
    vpos = gen.uniform(1.0, 2.0, (n, 3)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(d=d, normal=normal, r=r, value=value, vpos=vpos).items()}
    _close(jshade.sky(jnp.asarray(d)), shade.sky(t["d"]))
    _close(jshade.material_color(jnp.asarray(value), jnp.asarray(vpos)),
           shade.material_color(t["value"], t["vpos"]))
    _close(jshade.cosine_bounce(jnp.asarray(normal), jnp.asarray(r)),
           shade.cosine_bounce(t["normal"], t["r"]))
    _close(jshade.mirror_bounce(jnp.asarray(d), jnp.asarray(normal)),
           shade.mirror_bounce(t["d"], t["normal"]))
    assert shade.SUN_DIR_GI == tuple(np.asarray(jshade.SUN_DIR_GI).tolist())


def _grid(w, h):
    px = np.tile(np.arange(w, dtype=np.float32), h)
    py = np.repeat(np.arange(h, dtype=np.float32), w)
    return px, py


def _circular(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 1.0 - d)


def test_glsl_rand_within_one_ulp_of_scale():
    """fract(sin(x)*43758.5453): PyTorch's and XLA's sin differ by at most
    one ulp, which moves sin*43758.5453 (|v| < 2^16) by at most one of its
    own ulps, 2^-8.  The fraction wraps, so distance is circular."""
    px, py = _grid(320, 192)
    ref = jrng.glsl_rand(jnp.asarray(px), jnp.asarray(py))
    got = rng.glsl_rand(torch.from_numpy(px), torch.from_numpy(py))
    assert _circular(ref, got.numpy()).max() <= 2.0 ** -8 + 1e-7


@pytest.mark.parametrize("frame", [1, 3, 7])
def test_pixel_rand_statistics(frame):
    """pixel_rand feeds one glsl_rand into another: a 2^-8 difference in
    the inner value moves the outer sin argument by ~0.05-0.3 rad, so
    where the inner values differ the outputs are unrelated.  Measured on
    320x192: 88-92% of pixels exact, 90-95% within 1e-2.  The contract
    kept: >= 85% within 1e-2, and the same uniform distribution (deciles
    within 0.01, means within 0.005)."""
    px, py = _grid(320, 192)
    ref = np.asarray(jrng.pixel_rand(jnp.asarray(px), jnp.asarray(py),
                                     frame))
    got = rng.pixel_rand(torch.from_numpy(px), torch.from_numpy(py),
                         frame).numpy()
    assert (_circular(ref, got) <= 1e-2).mean() >= 0.85
    assert abs(ref.mean() - got.mean()) <= 5e-3
    hr = np.histogram(ref, bins=10, range=(0, 1))[0] / ref.size
    hg = np.histogram(got, bins=10, range=(0, 1))[0] / got.size
    assert np.abs(hr - hg).max() <= 0.01
    assert ((got >= 0) & (got < 1)).all()
