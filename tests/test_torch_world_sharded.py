"""The port's models/world.build_world_sharded over gloo ranks on the CPU
(tests/torch_ranks.job_world): a 64^3 perlin world from eight 32^3
chunks (bench.py's layout: world offset (0, -32, 0)), over 4 ranks (two
full groups) and over 3 (a tail group of 2, its spare rank's chunk
dropped), equal in every array to the port's serial build_world, on
every rank.  Slow-marked, as the JAX package marks its own: the same
world equal to JAX's build_world_sharded on its tile_mesh(4)."""

import numpy as np
import pytest
import torch

import torch_ranks
from svo_raytracer_torch.models import procgen, world

S, CS = 64, 32


def _gen(o):
    return procgen.generate_chunk(o, CS, device="cpu")


@pytest.fixture(scope="module")
def serial():
    return world.build_world(S, CS, _gen, world_offset=(0, -CS, 0))


@pytest.mark.parametrize("n", [4, 3])
def test_build_world_sharded_equals_serial(serial, n, tmp_path):
    ranks = torch_ranks.run_ranks(torch_ranks.job_world, n, tmp_path)
    assert len(ranks) == n
    for r in ranks:
        assert (r["n_nodes"], r["world_size"]) == (serial.n_nodes, S)
        for got, want in zip(r["arrays"], serial.arrays()):
            assert got.dtype == want.dtype == torch.int32
            assert torch.equal(got, want)
    assert serial.n_nodes > 8 + 8 * 8


@pytest.mark.slow
def test_build_world_sharded_equals_jax(tmp_path):
    import jax.numpy as jnp
    from svo_raytracer_tpu.models import procgen as jprocgen
    from svo_raytracer_tpu.models import world as jworld
    from svo_raytracer_tpu.parallel import mesh as jmesh

    def jgen(origin):
        return jprocgen.generate_chunk(jnp.asarray(origin, jnp.int32),
                                       chunk_size=CS)

    ref = jworld.build_world_sharded(S, CS, jgen, jmesh.tile_mesh(4),
                                     chunk_capacity=1 << 17,
                                     world_offset=(0, -CS, 0)).to_numpy()
    got = torch_ranks.run_ranks(torch_ranks.job_world, 4, tmp_path)[0]
    assert got["n_nodes"] == ref.n_nodes
    for a, f in zip(got["arrays"], ("child", "mask", "value", "normal")):
        assert np.array_equal(a.numpy(),
                              np.asarray(getattr(ref, f))[:ref.n_nodes]), f
