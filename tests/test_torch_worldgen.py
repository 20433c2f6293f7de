"""The port's world generation (svo_raytracer_torch/models/procgen.py and
models/world.py) against the JAX package's, on the CPU.

Tolerance: exact.  Chunk grids equal jitted JAX's voxel for voxel (a
voxel may differ only where its surface or simplex gate lies within the
noise tolerances of tests/test_torch_noise.py of its threshold; none
does on these chunks), and build_world's node tables equal JAX's slot
for slot, up to n_nodes.  The chunk origins are 64^3 pieces of bench.py's
1024^3 world (512^3 chunks, world_offset (0, -512, 0)) where the terrain
surface crosses them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_raytracer_tpu.models import procgen as jprocgen
from svo_raytracer_tpu.models import world as jworld
from svo_raytracer_tpu.ops import noise as jnoise
from svo_raytracer_torch.models import procgen, world
from svo_raytracer_torch.ops import noise
from test_octree_build import reconstruct_voxels
from test_torch_noise import _near_threshold

FIELDS = ("child", "mask", "value", "normal")
BENCH_ORIGINS = [(0, 0, 0), (448, -192, 512), (960, -128, 64),
                 (64, 0, 448)]


def _jax_chunk(origin, size, kind="perlin"):
    return np.asarray(jprocgen.generate_chunk(
        jnp.asarray(origin, jnp.int32), chunk_size=size, kind=kind))


def _assert_tree_equal(got, ref):
    """A port DeviceOctree against a JAX Octree, slot for slot."""
    assert got.n_nodes == ref.n_nodes
    assert got.world_size == ref.world_size
    for f in FIELDS:
        a = getattr(got, f)
        assert a.dtype == torch.int32 and a.shape == (got.n_nodes,)
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(getattr(ref, f))[:ref.n_nodes], err_msg=f)


@pytest.mark.parametrize("origin", BENCH_ORIGINS)
def test_generate_chunk_equals_jax(origin):
    got = procgen.generate_chunk(origin, 64, device="cpu")
    ref = _jax_chunk(origin, 64)
    assert got.dtype == torch.uint8 and got.shape == (64, 64, 64)
    assert 0 < ref.mean() < 1                     # the surface crosses
    differ = got.numpy() != ref
    if differ.any():
        ax = np.arange(64)
        x, y, z = np.meshgrid(ax + origin[0], ax + origin[1],
                              ax + origin[2], indexing="ij")
        assert _near_threshold(x[differ], y[differ], z[differ]).all()


@pytest.mark.parametrize("kind,origin", [("sphere", (-8, 240, 240)),
                                          ("box", (240, 240, 752))])
def test_generate_chunk_shapes_equal_jax(kind, origin):
    got = procgen.generate_chunk(origin, 32, kind=kind, device="cpu")
    ref = _jax_chunk(origin, 32, kind)
    assert 0 < ref.mean() < 1
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_chunk_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown generator kind"):
        procgen.generate_chunk((0, 0, 0), 16, kind="cave", device="cpu")


def test_generate_chunk_defaults_to_the_card():
    """With no device given the chunk goes to the card; without one that
    raises, with no fallback to the CPU."""
    if torch.cuda.is_available():
        assert procgen.generate_chunk((0, 0, 0), 16).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            procgen.generate_chunk((0, 0, 0), 16)


def test_chunk_origin_continuity():
    """Adjacent chunks generated separately agree with one big grid (the
    JAX package's test_chunk_origin_continuity, on the port)."""
    big = procgen.generate_chunk((0, 0, 0), 64, device="cpu")
    a = procgen.generate_chunk((0, 0, 0), 32, device="cpu")
    b = procgen.generate_chunk((32, 0, 0), 32, device="cpu")
    assert torch.equal(a, big[:32, :32, :32])
    assert torch.equal(b, big[32:, :32, :32])
    np.testing.assert_array_equal(big.numpy(), _jax_chunk((0, 0, 0), 64))


@pytest.mark.parametrize("S,CS", [(64, 32), (128, 32), (1024, 512)])
def test_chunk_layout_equal(S, CS):
    ref, rchunks = jworld.chunk_layout(S, CS)
    got, chunks = world.chunk_layout(S, CS)
    assert chunks == rchunks
    assert len(chunks) == (S // CS) ** 3
    _assert_tree_equal(got, ref)


@pytest.mark.parametrize("S,CS", [(64, 32), (128, 64)])
def test_build_world_perlin_equals_jax(S, CS):
    offset = (0, -S // 2, 0)
    ref = jworld.build_world(
        S, CS, lambda o: jprocgen.generate_chunk(jnp.asarray(o, jnp.int32),
                                                 chunk_size=CS),
        world_offset=offset)
    timings = {}
    got = world.build_world(
        S, CS, lambda o: procgen.generate_chunk(o, CS, device="cpu"),
        world_offset=offset, timings=timings)
    _assert_tree_equal(got, ref.to_numpy())
    assert set(timings) == {"noise", "build", "splice"}


def test_build_world_single_chunk():
    v = procgen.generate_chunk((0, 0, 0), 32, device="cpu")
    got = world.build_world(32, 32, lambda o: v)
    ref = jworld.build_world(32, 32, lambda o: v.numpy())
    _assert_tree_equal(got, ref.to_numpy())


def test_build_world_chunked_reconstructs():
    """The JAX package's test_build_world_chunked_reconstructs generator:
    the port's world equals JAX's node for node and rasterizes to the
    generator's voxels."""
    S, CS = 64, 32
    rng = np.random.default_rng(5)
    coarse = rng.integers(0, 3, (8, 8, 8)).astype(np.uint8)
    full = np.repeat(np.repeat(np.repeat(coarse, 8, 0), 8, 1), 8, 2)

    def gen(origin):
        x, y, z = origin
        return full[x:x + CS, y:y + CS, z:z + CS]

    got = world.build_world(
        S, CS, lambda o: torch.from_numpy(np.ascontiguousarray(gen(o))))
    _assert_tree_equal(got, jworld.build_world(S, CS, gen).to_numpy())
    np.testing.assert_array_equal(reconstruct_voxels(got.to_numpy()),
                                  full.astype(np.int32))


def test_bench_world_near_threshold_voxels():
    """The voxels of bench.py's 1024^3 world within 5e-6 of a surface
    threshold or 1e-6 of the simplex gate's (tests/data/
    bench_world_near.npz, listed on the card by
    scripts/bench_world_margins.py with the port's voxels).  The port's
    CPU noise gives the card's voxel on each; jitted JAX differs from it
    on 47 of them, which are the whole difference between the two
    builds (flipped, the port's world has JAX's 16,083,240 nodes), and
    each lies within the noise tolerances of its threshold."""
    data = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "bench_world_near.npz"))
    x, y, z = (np.ascontiguousarray(data["xyz"][:, i], np.int32)
               for i in range(3))
    got = noise.sample_perlin_terrain(*(torch.from_numpy(a)
                                        for a in (x, y, z))).numpy()
    np.testing.assert_array_equal(got, data["voxel"])
    ref = np.asarray(jax.jit(jnoise.sample_perlin_terrain)(x, y, z))
    differ = got != ref
    assert len(got) == 7836 and differ.sum() == 47
    assert _near_threshold(x[differ], y[differ], z[differ]).all()
