"""The port's noise stack (svo_raytracer_torch/ops/noise.py) against the
JAX package's (svo_raytracer_tpu/ops/noise.py) on numpy-seeded inputs,
negative and large (|x| > 289) coordinates included.

Tolerances.  Eager JAX runs the same float32 operations in the same
order: cnoise and snoise equal it bit for bit, worley within 1 ulp
(6e-8 on values below 1.5, where XLA's CPU square root is not the
correctly rounded one).  Jitted JAX contracts multiply-adds into fused
ones: snoise and worley within atol 1e-6 of it (on these sets 4.8e-7 and
1.2e-7); cnoise within atol 4e-6 (on these sets 2.4e-6), since its fade
polynomial t^3 (t (6t - 15) + 10) cancels as t -> 1 and carries the
fused rounding into the output.  The voxel samplers are exact: the perlin
terrain grid equals jitted JAX's except on voxels whose surface or
simplex gate lies within those tolerances of its threshold (none on
these grids), sphere and box grids everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_raytracer_tpu.ops import noise as jnoise
from svo_raytracer_torch.ops import noise

N = 4096
SCALES = (1.0, 40.0, 3000.0)    # coordinates in [-s, s]
ATOL_JIT = {"cnoise": 4e-6, "snoise": 1e-6, "worley": 1e-6}
WORLEY_ULP = 6e-8


def _coords(scale, n_args, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n_args, N)) * scale).astype(np.float32)


def _port(fn, args):
    out = getattr(noise, fn)(*(torch.from_numpy(a.copy()) for a in args))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _jax(fn, args, jit):
    f = getattr(jnoise, fn)
    out = (jax.jit(f) if jit else f)(*(jnp.asarray(a.copy()) for a in args))
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("fn,n_args", [("cnoise", 2), ("snoise", 3),
                                       ("worley", 2)])
def test_noise_matches_jax(fn, n_args, scale):
    args = _coords(scale, n_args, seed=int(scale) + n_args)
    got = _port(fn, args)
    eager = _jax(fn, args, jit=False)
    jitted = _jax(fn, args, jit=True)
    for g, e, j in zip(got, eager, jitted):    # worley: F1, then F2
        assert g.shape == (N,) and np.isfinite(g).all()
        if fn == "worley":
            np.testing.assert_allclose(g, e, rtol=0, atol=WORLEY_ULP)
        else:
            np.testing.assert_array_equal(g, e)
        np.testing.assert_allclose(g, j, rtol=0, atol=ATOL_JIT[fn])


def test_noise_broadcasts_as_jax():
    """cnoise and worley see (x, z) only: (S,1,1) with (1,1,S) gives
    (S,1,S); snoise spans the grid."""
    rng = np.random.default_rng(3)
    x, y, z = (np.sort(rng.uniform(-700, 700, 12)).astype(np.float32)
               for _ in range(3))
    xs, ys, zs = x[:, None, None], y[None, :, None], z[None, None, :]
    assert noise.cnoise(torch.from_numpy(xs),
                        torch.from_numpy(zs)).shape == (12, 1, 12)
    f1, f2 = noise.worley(torch.from_numpy(xs), torch.from_numpy(zs))
    assert f1.shape == f2.shape == (12, 1, 12)
    got = noise.snoise(*(torch.from_numpy(a) for a in (xs, ys, zs)))
    ref = jax.jit(jnoise.snoise)(xs, ys, zs)
    assert got.shape == (12, 12, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL_JIT["snoise"])


def _int_grid(origin, size, stride=1):
    ax = np.arange(size, dtype=np.int32) * stride
    return (ax[:, None, None] + origin[0], ax[None, :, None] + origin[1],
            ax[None, None, :] + origin[2])


def _near_threshold(x, y, z, scale=0.003):
    """Per voxel: whether its surface (y*scale against land) or its
    simplex gate lies within the jitted-JAX tolerances of flipping."""
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in (x, y, z)]
    px, pz = t[0] * scale, t[2] * scale
    land = noise.cnoise(px, pz)
    _, f2 = noise.worley(px, pz)
    s = noise.snoise(t[0] * scale * 0.5, t[1] * scale * 0.5, pz * 0.5)
    tol = ATOL_JIT["cnoise"] + ATOL_JIT["worley"]
    surf = torch.minimum((t[1] * scale - land).abs(),
                         (t[1] * scale - land - f2).abs())
    return ((surf <= tol) | (s.abs() <= ATOL_JIT["snoise"])).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perlin_terrain_grid_equal(seed):
    """Seeded 32^3 grids where the surface crosses (y around the terrain
    band, x and z anywhere in +-4000)."""
    rng = np.random.default_rng(seed)
    origin = (int(rng.integers(-4000, 4000)), int(rng.integers(-200, 120)),
              int(rng.integers(-4000, 4000)))
    x, y, z = _int_grid(origin, 32)
    got = noise.sample_perlin_terrain(*(torch.from_numpy(a)
                                        for a in (x, y, z))).numpy()
    ref = np.asarray(jax.jit(jnoise.sample_perlin_terrain)(x, y, z))
    assert got.dtype == np.uint8 and got.shape == (32, 32, 32)
    differ = got != ref
    if differ.any():
        xx, yy, zz = np.broadcast_arrays(x, y, z)
        near = _near_threshold(xx[differ], yy[differ], zz[differ])
        assert near.all(), f"{differ.sum()} voxels differ off threshold"


def test_perlin_terrain_slabs():
    """Evaluating snoise over y-slabs changes no voxel."""
    x, y, z = _int_grid((-300, -40, 700), 24)
    t = [torch.from_numpy(a) for a in (x, y, z)]
    whole = noise.sample_perlin_terrain(*t)
    for slab in (1, 5, 24):
        assert torch.equal(noise.sample_perlin_terrain(*t, slab=slab), whole)


@pytest.mark.parametrize("kind", ["sphere", "box"])
def test_shape_grids_equal(kind):
    """Strided grids over [0, ~900)^3, crossing each surface."""
    rng = np.random.default_rng(7)
    x, y, z = _int_grid(tuple(int(v) for v in rng.integers(-20, 20, 3)),
                        48, stride=19)
    f, jf = ((noise.sample_sphere, jnoise.sample_sphere) if kind == "sphere"
             else (noise.sample_box, jnoise.sample_box))
    got = f(*(torch.from_numpy(a) for a in (x, y, z))).numpy()
    ref = np.asarray(jax.jit(jf)(x, y, z))
    assert got.dtype == np.uint8 and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, ref)


def test_mod_of_multiples_is_zero():
    """jnp.mod (C fmod plus a sign fix) gives 0 on exact multiples of
    289, where the reciprocal form the card uses for a division by a
    Python scalar, x - 289 * floor(x * (1/289)), gives 289 on some."""
    k = np.arange(-58000, 58000, 7, dtype=np.float32)
    x = k * np.float32(289.0)          # exact: |x| < 2^24
    got = noise._mod(torch.from_numpy(x), 289.0).numpy()
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(got, np.asarray(jnp.mod(x, 289.0)))
    recip = x - np.floor(x * np.float32(1.0 / 289.0)) * np.float32(289.0)
    assert (recip == 289.0).any()
    # and off the multiples, the same residues as jnp.mod
    y = np.random.default_rng(0).uniform(-1e6, 1e6, N).astype(np.float32)
    np.testing.assert_array_equal(noise._mod(torch.from_numpy(y),
                                             289.0).numpy(),
                                  np.asarray(jnp.mod(y, 289.0)))
    # permute3d's argument ((34 p) + 1) p on exact multiples of 289
    p = np.asarray([v for v in range(600) if (34 * v + 1) * v % 289 == 0],
                   np.float32)
    assert len(p) > 2
    got = noise._permute3d(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(got, np.asarray(
        jax.jit(jnoise._permute3d)(p)))
