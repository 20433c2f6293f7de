"""The order in which kernel K1 traces explicit rays (wavefront.ray_keys,
ray_order) on the CPU: the key's documented layout, dead rays at the
tail, and that the order changes no record.

K1 traces lane k's ray order[k] and writes its record to slot order[k];
here trace_plain run over the rays in key order and written back through
the permutation must equal trace_plain in frame order in every field
(tolerance: equality, NaN equal to NaN).  The CPU path traces in frame
order, so its parity with the JAX package's intersect_wavefront on these
scenes is tests/test_torch_wavefront.py's and
tests/test_torch_bigworld_trace.py's.  The scenes: sphere-64, terrain-64
(G = 2), the G = 64 scene and the sparse paged 4096^3 scene of
chip_smoke.py."""

import numpy as np
import pytest
import torch

import chip_smoke
from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_torch.ops import brick_scene, wavefront
from test_traverse_batch import random_rays

SCENES = ("sphere-64", "terrain-64", "g64", "paged-4096")
FIELDS = ("status", "t", "cell", "widx", "iters")


def _scene(name):
    """The port's BrickScene of a test scene."""
    if name == "g64":
        return chip_smoke.g64_scene()
    if name == "paged-4096":
        return chip_smoke.sparse_paged_scene()
    vox = (make_sphere_voxels(64, radius=24) if name == "sphere-64"
           else make_terrain_voxels(64, seed=7))
    return brick_scene.brickify(build_np.build_octree_np(vox))


def _world_rays(scene, n, seed):
    """World-unit rays: random ones and, on the sparse worlds, ones aimed
    at their bricks (so most of those hit)."""
    o, d = random_rays(n, seed=seed)
    if scene.grid_size >= 64:
        ao, ad = chip_smoke.aimed_rays(scene, n, seed=seed)
        o, d = np.concatenate([o, ao]), np.concatenate([d, ad])
    return o, d


def _voxel_rays(name, n=1024, seed=31):
    """(WaveScene, voxel-unit rays) with non-finite and inactive rays."""
    scene = _scene(name)
    ws = wavefront.prepare(scene, "cpu")
    o, d = _world_rays(scene, n, seed)
    o[::97] = np.nan
    d[3::89, 1] = -np.inf
    act = torch.ones(o.shape[0], dtype=torch.bool)
    act[11::37] = False
    return ws, *wavefront._rays(ws, torch.from_numpy(o), torch.from_numpy(d),
                                act)


def _morton(x, y, z):
    """Bit i of x, y, z at bits 3i+2, 3i+1, 3i (i < 8)."""
    code = np.zeros_like(x)
    for i in range(8):
        code |= (((x >> i) & 1) << (3 * i + 2)) | (((y >> i) & 1)
                                                   << (3 * i + 1)) \
            | (((z >> i) & 1) << (3 * i))
    return code


@pytest.mark.parametrize("name", SCENES)
def test_key_layout(name):
    """Octant (x, y, z set where d >= 0) in bits 24-26 above the Morton
    code of the origin's brick cell, clamped into the grid."""
    scene = _scene(name)
    ws = wavefront.prepare(scene, "cpu")
    G = ws.grid_size
    rng = np.random.default_rng(len(name))
    n = 512
    cell = rng.integers(-2, G + 2, (n, 3))         # some outside the grid
    o = (cell * 32 + rng.uniform(0.1, 31.9, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::5, 2] = 0.0                                 # d = 0 counts as >= 0
    d[1::5, 0] = -0.0
    keys = wavefront.ray_keys_plain(ws, torch.from_numpy(o),
                                    torch.from_numpy(d),
                                    torch.ones(n, dtype=torch.bool)).numpy()
    c = np.clip(cell, 0, G - 1).astype(np.int64)
    octant = ((d[:, 0] >= 0) * 4 + (d[:, 1] >= 0) * 2
              + (d[:, 2] >= 0)).astype(np.int64)
    want = (octant << 24) | _morton(c[:, 0], c[:, 1], c[:, 2])
    assert keys.dtype == np.int32
    assert np.array_equal(keys.astype(np.int64), want)
    assert keys.max() < 1 << 27 and len(np.unique(octant)) == 8


@pytest.mark.parametrize("name", SCENES)
def test_dead_rays_sort_to_tail(name):
    """Rays that are inactive or not finite take KEY_DEAD; ray_order puts
    every live ray before every dead one, live keys ascending."""
    ws, o, d, alive = _voxel_rays(name)
    live = alive & torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
    alive = alive | ~torch.isfinite(d).all(1)    # dead by finiteness alone
    keys = wavefront.ray_keys(ws, o, d, alive)
    assert torch.equal(keys == wavefront.KEY_DEAD, ~live)
    order = wavefront.ray_order(ws, o, d, alive)
    n_live = int(live.sum())
    assert 0 < n_live < o.shape[0]
    assert bool(live[order[:n_live]].all()) and not live[order[n_live:]].any()
    assert bool((keys[order][1:] >= keys[order][:-1]).all())
    assert torch.equal(torch.sort(order).values, torch.arange(o.shape[0]))


@pytest.mark.parametrize("name", SCENES)
def test_key_order_trace_equals_frame_order(name):
    """trace_plain over the rays in key order, written back through the
    permutation, equals trace_plain in frame order in every field."""
    ws, o, d, alive = _voxel_rays(name)
    order = wavefront.ray_order(ws, o, d, alive)
    want = wavefront.trace_plain(ws, o, d, alive)
    perm = wavefront.trace_plain(ws, o[order], d[order], alive[order])
    for field, a, b in zip(FIELDS, want, perm):
        back = torch.empty_like(b)
        back[order] = b
        same = (a == back) | (a.isnan() & back.isnan()) \
            if a.is_floating_point() else a == back
        assert bool(same.all()), field
    hit = (want[0] == wavefront.MIXED) | (want[0] == wavefront.UNIFORM)
    assert hit.any() and not hit.all()
