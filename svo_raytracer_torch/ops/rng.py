"""Random numbers for the pathtracer (port of svo_raytracer_tpu/ops/rng.py).

Two generators:

* :func:`glsl_rand` / :func:`pixel_rand` — the reference's per-pixel sin
  hash.  fract(sin(x) * 43758.5453) turns one ulp of ``sin`` into ~3e-3
  of the result, and PyTorch's and XLA's ``sin`` differ by an ulp on some
  inputs, so the two packages agree on this function only to a tolerance
  (tests/test_torch_shade.py); frame tests feed both the same numbers.
* :func:`threefry_uniform` — counter-based Threefry-2x32, bit-equal to
  ``jax.random.uniform(fold_in(fold_in(key, frame), bounce), ...)`` as
  the installed JAX draws it (``jax_threefry_partitionable`` on: element
  i of the output hashes the counter pair (i >> 32, i & 0xFFFFFFFF) and
  takes the xor of the two output words).  Keys are (2,) uint32 NumPy
  arrays, as :func:`prng_key` makes them (``jax.random.PRNGKey``).  The
  hash runs on int64 tensors masked to 32 bits, on the counters' device.
"""

from __future__ import annotations

import numpy as np
import torch


def glsl_rand(x, y):
    """fract(sin(dot(co, (12.9898, 78.233))) * 43758.5453) in float32."""
    s = torch.sin(x.float() * 12.9898 + y.float() * 78.233)
    v = s * 43758.5453
    return v - torch.floor(v)


def frame_offsets(frame):
    """The frame's two inner seeds of :func:`pixel_rand`,
    float32(frame) * float32(0.1) and float32(frame) * float32(0.02)."""
    fr = np.float32(frame)
    return float(fr * np.float32(0.1)), float(fr * np.float32(0.02))


def pixel_rand(px, py, frame):
    """The composed per-pixel random of render mode 0 (svotrace.comp:486):
    rand(seed0 + rand(seed0, frame*0.1), seed1 + rand(seed1, frame*0.02))."""
    f1, f2 = frame_offsets(frame)
    r1 = glsl_rand(px, torch.full_like(px, f1))
    r2 = glsl_rand(py, torch.full_like(py, f2))
    return glsl_rand(px + r1, py + r2)


MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry_2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under key (k1, k2): Python ints for the key, and Python ints or int64
    tensors in [0, 2^32) for the counters.  Returns the two output
    words, as jax's ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed):
    """The raw key of ``jax.random.PRNGKey(seed)`` (32-bit JAX: the
    high word 0, the low word the seed's 32 bits), as a (2,) uint32 NumPy
    array."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return np.array([0, seed & MASK32], np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    k1, k2 = (int(k) for k in np.asarray(key, np.uint32))
    return np.array(threefry_2x32(k1, k2, 0, int(data) & MASK32), np.uint32)


def uniform(key, shape, device):
    """``jax.random.uniform(key, shape, float32)`` in [0, 1), on
    ``device``: element i (row-major) hashes the counter pair
    (i >> 32, i & 0xFFFFFFFF) and xors the two words; the top 23 bits of
    that draw are the mantissa of a float in [1, 2), less 1."""
    k1, k2 = (int(k) for k in np.asarray(key, np.uint32))
    i = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    x0, x1 = threefry_2x32(k1, k2, i >> 32, i & MASK32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return u.clamp_min(0.0).reshape(shape)


def threefry_uniform(key, pixel_index, frame, bounce, n):
    """Per-pixel uniforms in [0, 1) of shape pixel_index.shape + (n,), on
    pixel_index's device (JAX: one uniform draw under
    fold_in(fold_in(key, frame), bounce), not a key per pixel)."""
    k = fold_in(fold_in(key, frame), bounce)
    return uniform(k, tuple(pixel_index.shape) + (n,), pixel_index.device)
