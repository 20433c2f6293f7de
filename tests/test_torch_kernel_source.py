"""The kernels' own sources on the CPU: the per-ray bodies that the GPU
kernels run (csrc/wf_ray.cuh for K1, csrc/esvo_ray.cuh for KE,
csrc/brick_dda.cuh for K2) compiled with g++, their CUDA qualifiers
defined away, into ctypes libraries, against their plain PyTorch versions
(wavefront.trace_plain, traverse.intersect_plain,
brick_dda.coarse_dda_plain).

With no fused multiply-add on either side the two compute the same
float32 operations in the same order, so every record field must be
equal on every ray.  This catches logic slips in the CUDA source before
any GPU time."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from conftest import make_sphere_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import brick_dda, brick_scene, kernel_build
from svo_raytracer_torch.ops import skip_grid, traverse, wavefront
from test_traverse_batch import random_rays

GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
             "-D__host__=", "-D__device__=")


@pytest.fixture(scope="module")
def host_trace():
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    lib = kernel_build.load("wf_ray_host", ["wf_ray_host.cpp"], "g++",
                            GXX_FLAGS)
    fn = lib.wf_trace_host
    fn.argtypes = wavefront.K1.argtypes[:-1]     # no stream argument
    fn.restype = ctypes.c_int

    def run(ws, o, d, alive):
        B = o.shape[0]
        out = [torch.empty(B, dtype=dt) for dt in
               (torch.int32, torch.float32, torch.int32, torch.int32,
                torch.int32)]
        al = alive.to(torch.uint8)
        assert fn(*wavefront._table_args(ws), o.data_ptr(), d.data_ptr(),
                  al.data_ptr(), B, *[x.data_ptr() for x in out]) == 0
        return out

    return run


def _scene(name):
    if name == "g64":
        return chip_smoke.g64_scene()
    if name == "paged-4096":
        return chip_smoke.sparse_paged_scene()
    if name == "sphere-64":
        tree = build_np.build_octree_np(make_sphere_voxels(64, radius=24))
        return brick_scene.brickify(tree)
    size = int(name.split("-")[1])
    # a raised floor (lo) gives uniform-stone bricks: phase-2 entry hits
    hm, mm = bigworld.fractal_heightmap(size, seed=3, lo=0.3, hi=0.9)
    return bigworld.heightmap_brick_scene(hm, mm, size)


@pytest.mark.parametrize("name", ["sphere-64", "heightmap-256",
                                  "heightmap-512", "g64", "paged-4096"])
def test_cuda_source_body_equals_plain(host_trace, name):
    scene = _scene(name)
    ws = wavefront.prepare(scene, "cpu")
    o, d = random_rays(2048, seed=17)
    if name in ("g64", "paged-4096"):
        # sparse worlds: add rays aimed at their bricks, so most hit
        ao, ad = chip_smoke.aimed_rays(scene, 2048, seed=5)
        o, d = np.concatenate([o, ao]), np.concatenate([d, ad])
    o[::97] = np.nan                        # non-finite rays stay misses
    ov, dv, alive = wavefront._rays(ws, torch.from_numpy(o),
                                    torch.from_numpy(d))
    want = wavefront.trace_plain(ws, ov, dv, alive)
    got = host_trace(ws, ov, dv, alive)
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    assert (want[0] == wavefront.MIXED).any()
    assert (want[0] == wavefront.UNIFORM).any() or name == "sphere-64"


def _host_fn(name, source, symbol, argtypes):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    fn = getattr(kernel_build.load(name, [source], "g++", GXX_FLAGS), symbol)
    fn.argtypes = argtypes[:-1]                  # no stream argument
    fn.restype = ctypes.c_int
    return fn


def _equal(want, got):
    """Field names whose values differ (NaN equal to NaN)."""
    bad = []
    for k, a in want.items():
        b = got[k]
        same = (a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() \
            else a == b
        if not bool(same.all()):
            bad.append(k)
    return bad


def _esvo_tree(name):
    if name == "sphere-64":
        vox = make_sphere_voxels(64, radius=24)
    elif name == "terrain-64":
        vox = chip_smoke.terrain_voxels(64, 7)
    else:
        vox = (np.indices((16,) * 3).sum(0) % 2).astype(np.uint8)
    return build_np.build_octree_np(vox)


@pytest.mark.parametrize("name", ["sphere-64", "terrain-64", "checker-16",
                                  "terrain-64-skip"])
@pytest.mark.parametrize("kw", [dict(), dict(cone_trace=True, max_depth=3),
                                dict(max_iterations=5), dict(max_depth=3)])
def test_esvo_source_body_equals_plain(name, kw):
    """"-skip": the rays as the skip grid hands them to KE (moved to their
    skip distance, definite misses inactive).  max_depth 3 lies below every
    tree's depth, so the cutoff fires; with cone tracing the LOD clamp
    lifts rays past t = 0.05 to depth 11, below the cutoff."""
    fn = _host_fn("esvo_host", "esvo_host.cpp", "esvo_trace_host",
                  traverse.KE.argtypes)
    jt = _esvo_tree(name.removesuffix("-skip"))
    from svo_raytracer_torch.core import octree
    tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")
    packed = traverse.make_packed_table(tree)
    o, d = random_rays(2048, seed=17)
    o[::97] = np.nan                        # non-finite rays retire at once
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    alive = torch.ones(2048, dtype=torch.bool)
    alive[5::50] = False
    if name.endswith("-skip"):
        tab = torch.from_numpy(brick_scene.table_rows(
            skip_grid.build_skip_grid(tree, 32)))
        skip, maybe = skip_grid.skip_distances(tab, o, d, active=alive)
        o, alive = (o + skip[:, None] * d).contiguous(), maybe & alive
        assert (skip > 0).any() and (~maybe).any()
    want = traverse.intersect_plain(packed, o, d, alive, **kw)
    B = o.shape[0]
    f_out = torch.empty((len(traverse.F_FIELDS), B))
    i_out = torch.empty((len(traverse.I_FIELDS), B), dtype=torch.int32)
    assert fn(packed.data_ptr(), o.data_ptr(), d.data_ptr(),
              alive.to(torch.uint8).data_ptr(), B, kw.get("max_depth", 13),
              int(kw.get("cone_trace", False)),
              kw.get("max_iterations", 1500), 13, f_out.data_ptr(),
              i_out.data_ptr()) == 0
    got = dict(zip(traverse.F_FIELDS, f_out))
    got.update(zip(traverse.I_FIELDS, i_out))
    assert _equal(want, got) == []
    assert (want["done"] == 1).any() and (want["scale"] < 23).any()
    deeper = (want["done"] == 1) & (traverse.MAX_SCALE - want["scale"] > 3)
    if not name.endswith("-skip"):  # skipped rays hit before t = 0.05
        assert bool(deeper.any()) == (kw.get("max_depth", 13) > 3
                                      or kw.get("cone_trace", False))
    if "max_iterations" in kw:
        assert (want["done"] == 0).any()


def _dda_cases(name):
    """(table, G, grid-unit rays): random grids at G = 8 and 32, and the
    skip grid of terrain-64 with world rays mapped to its grid."""
    rng = np.random.default_rng(len(name))
    if name == "skip-terrain-64":
        tree = _esvo_tree("terrain-64")
        G = 32
        words = skip_grid.build_skip_grid(tree, G)
        o, d = random_rays(2048, seed=21)
        o = (o - 1.0) * np.float32(G)
    else:
        G = int(name.split("-")[1])
        words = brick_scene.pack_occupancy(rng.random((G,) * 3) < 0.05)
        o = np.where(rng.random((2048, 1)) < 0.5,
                     rng.uniform(0, G, (2048, 3)),
                     rng.uniform(-G, 2 * G, (2048, 3))).astype(np.float32)
        d = rng.normal(size=(2048, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[::7, 1] = 3e-5
    o[::89] = np.nan
    tab = torch.from_numpy(brick_scene.table_rows(words))
    return tab, G, torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("name", ["random-8", "random-32", "skip-terrain-64"])
def test_dda_source_body_equals_plain(name):
    fn = _host_fn("dda_host", "brick_dda_host.cpp", "dda_march_host",
                  brick_dda.K2.argtypes)
    tab, G, o, d = _dda_cases(name)
    B = o.shape[0]
    alive = torch.rand(B, generator=torch.Generator().manual_seed(3)) < 0.9
    want = brick_dda.coarse_dda_plain(tab, o, d, G, 3 * G, alive)
    hit = torch.empty(B, dtype=torch.int32)
    got = dict(t=torch.empty(B), cell=torch.empty((B, 3), dtype=torch.int32),
               steps=torch.empty(B, dtype=torch.int32))
    assert fn(tab.data_ptr(), G, 3 * G, o.data_ptr(), d.data_ptr(),
              alive.to(torch.uint8).data_ptr(), B, hit.data_ptr(),
              got["t"].data_ptr(), got["cell"].data_ptr(),
              got["steps"].data_ptr()) == 0
    got["hit"] = hit != 0
    assert _equal(want, got) == []
    assert want["hit"].any() and not want["hit"].all()
