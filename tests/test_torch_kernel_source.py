"""Kernel K1's own source on the CPU: csrc/wf_ray.cuh (the per-ray body
that csrc/wavefront.cu runs on the GPU) compiled with g++, its CUDA
qualifiers defined away, into a ctypes library, against trace_plain.

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
from svo_raytracer_torch.ops import brick_scene, kernel_build, wavefront
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
