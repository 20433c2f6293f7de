"""Kernel K1 on a CUDA GPU against its plain PyTorch version.  Needs a
card and nvcc; skipped elsewhere.  The file imports no jax, so on a GPU
host without JAX it runs from the repository root with
``python -m pytest --noconftest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import chip_smoke
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import wavefront


def _rays(n, seed):
    """Rays from inside and around the world cube [1,2]^3, toward it."""
    gen = np.random.default_rng(seed)
    o = gen.uniform(0.2, 2.8, (n, 3)).astype(np.float32)
    o[::2] = gen.uniform(1.05, 1.95, (n - n // 2, 3))
    d = gen.uniform(1.2, 1.8, (n, 3)).astype(np.float32) - o
    d[::2] = gen.normal(size=(n - n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[::101] = np.nan                      # non-finite rays stay misses
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("size", [256, 512, 1024])
def test_kernel_equals_plain_on_gpu(size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # raised floor: uniform-stone bricks; empty upper half: supercell jumps
    hm, mm = bigworld.fractal_heightmap(size, seed=3, lo=0.3, hi=0.9)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, size),
                           "cuda")
    o, d, alive = wavefront._rays(ws, *_rays(8192, seed=size))
    before = wavefront.K1.launches
    got = wavefront.trace(ws, o, d, alive)
    torch.cuda.synchronize()
    assert wavefront.K1.launches == before + 1
    want = wavefront.trace_plain(ws, o, d, alive)
    # built with -fmad=false: the same float32 operations in the same order
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    assert (want[0] == wavefront.MIXED).any()
    assert (want[0] == wavefront.UNIFORM).any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["g64", "paged-4096"])
def test_kernel_equals_plain_on_big_worlds(name):
    """The G = 64 two-word mixed columns and the paged L0 march."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    scene = (chip_smoke.g64_scene() if name == "g64"
             else chip_smoke.sparse_paged_scene())
    ws = wavefront.prepare(scene, "cuda")
    o, d = chip_smoke.aimed_rays(scene, 8192, seed=1)
    o, d, alive = wavefront._rays(ws, torch.from_numpy(o).cuda(),
                                  torch.from_numpy(d).cuda())
    got = wavefront.trace(ws, o, d, alive)
    want = wavefront.trace_plain(ws, o, d, alive)
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    assert (want[0] == wavefront.MIXED).any()
    assert (want[0] == wavefront.UNIFORM).any()
