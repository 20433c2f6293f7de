"""Kernels K1, KE and K2 on a CUDA GPU against their plain PyTorch
versions.  Needs a card and nvcc; skipped elsewhere.  The file imports no
jax, so on a GPU host without JAX it runs from the repository root with
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


def _equal_fields(want, got):
    """Names of the record fields that differ (NaN equal to NaN)."""
    bad = []
    for k, a in want.items():
        b = got[k]
        same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() \
            else a == b
        if not bool(same.all()):
            bad.append(k)
    return bad


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sphere-64", "terrain-64"])
def test_esvo_kernel_equals_plain_on_gpu(name):
    """Kernel KE against traverse.intersect_plain: every field of every
    ray, with and without cone tracing, inactive and non-finite rays.
    max_depth 3 lies below the trees' depth 6, so the cutoff fires; with
    cone tracing the LOD clamp lifts rays past t = 0.05 to depth 11."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import traverse
    vox = (chip_smoke.sphere_voxels(64, 24) if name == "sphere-64"
           else chip_smoke.terrain_voxels(64, 7))
    tree = build_np.build_octree_np(vox).to_device("cuda")
    packed = traverse.make_packed_table(tree)
    o, d = _rays(8192, seed=5)
    alive = torch.ones(8192, dtype=torch.bool, device="cuda")
    alive[3::40] = False
    for kw in (dict(), dict(cone_trace=True, max_depth=3),
               dict(max_iterations=7), dict(max_depth=3)):
        before = traverse.KE.launches
        got = traverse.trace(packed, o, d, alive, **kw)
        torch.cuda.synchronize()
        assert traverse.KE.launches == before + 1
        want = traverse.intersect_plain(packed, o, d, alive, **kw)
        assert _equal_fields(want, got) == [], kw
        assert (want["done"] == 1).any()
        deeper = ((want["done"] == 1)
                  & (traverse.MAX_SCALE - want["scale"] > 3))
        assert bool(deeper.any()) == (kw.get("max_depth", 13) > 3
                                      or kw.get("cone_trace", False)), kw


@pytest.mark.gpu
@pytest.mark.parametrize("G", [8, 32, 64])
def test_dda_kernel_equals_plain_on_gpu(G):
    """Kernel K2 against brick_dda.coarse_dda_plain on a random grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import brick_dda, brick_scene
    gen = np.random.default_rng(G)
    tab = torch.from_numpy(brick_scene.table_rows(brick_scene.pack_occupancy(
        gen.random((G, G, G)) < 0.03))).cuda()
    o = np.where(gen.random((8192, 1)) < 0.5, gen.uniform(0, G, (8192, 3)),
                 gen.uniform(-G, 2 * G, (8192, 3))).astype(np.float32)
    d = gen.normal(size=(8192, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1] = 3e-5
    o[::89] = np.nan
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    alive = torch.from_numpy(gen.uniform(size=8192) < 0.9).cuda()
    before = brick_dda.K2.launches
    got = brick_dda.coarse_dda(tab, o, d, G, active=alive)
    torch.cuda.synchronize()
    assert brick_dda.K2.launches == before + 1
    want = brick_dda.coarse_dda_plain(tab, o, d, G, 3 * G, alive)
    assert _equal_fields(want, got) == []
    assert want["hit"].any()
