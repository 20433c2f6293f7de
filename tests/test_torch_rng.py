"""The port's threefry random (ops/rng.py) against the installed JAX's, bit
for bit: the key constructor against jax.random.PRNGKey, fold_in against
jax.random.fold_in, and threefry_uniform against the JAX package's
rng.threefry_uniform (jax.random.uniform under two fold_ins, drawn
through the partitionable bits path) for keys 0, 7 and 2**31 - 1, frames
1-3, bounces 0-3, batch sizes 1, 7, 1000 and 4096 (odd and even, so a
padded-counter difference would show) and n = 1 and 3.  Tolerance: none,
the bits are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_raytracer_tpu.ops import rng as jrng
from svo_raytracer_torch.ops import rng

SEEDS = (0, 7, 2 ** 31 - 1)


def test_partitionable_bits_path_is_on():
    """The port follows jax_threefry_partitionable's path; JAX's other
    path draws other bits."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + (-1, 12345))
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(rng.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_rejects_wide_seeds():
    with pytest.raises(ValueError):
        rng.prng_key(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    for data in (0, 1, 3, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(rng.prng_key(seed), data),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                          np.uint32(data))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("B", (1, 7, 1000, 4096))
def test_threefry_uniform_bit_equal_to_jax(seed, B):
    key = rng.prng_key(seed)
    for frame in (1, 2, 3):
        for bounce in range(4):
            for n in (1, 3):
                ref = np.asarray(jrng.threefry_uniform(
                    jax.random.PRNGKey(seed), jnp.arange(B), frame, bounce,
                    n))
                got = rng.threefry_uniform(key, torch.arange(B), frame,
                                           bounce, n)
                assert got.shape == (B, n) and got.dtype == torch.float32
                np.testing.assert_array_equal(
                    got.numpy().view(np.uint32), ref.view(np.uint32),
                    err_msg=f"frame {frame} bounce {bounce} n {n}")
                assert 0.0 <= float(got.min()) and float(got.max()) < 1.0
