"""The kernels' own sources on the CPU: the per-ray bodies that the GPU
kernels run (csrc/wf_ray.cuh for K1 with its camera-mode ray derivation,
its sort keys and its persistent schedule, emulated by a host loop of
32-lane warps that take 32 ray ids at a time from a counter and write
through the sort permutation,
csrc/esvo_ray.cuh for KE with its schedule, emulated by a host loop of
128-ray blocks that trace through a permutation and regroup a
cone-traced segment's rays by octant, csrc/brick_dda.cuh for K2,
csrc/brick_round.cuh for K3) compiled with g++, their CUDA qualifiers
defined away, into ctypes libraries, against their plain PyTorch versions
(wavefront.trace_plain and trace_camera_plain, traverse.intersect_plain,
brick_dda.coarse_dda_plain, brick_pallas.trace_plain).

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
from svo_raytracer_torch.ops import brick_dda, brick_pallas, brick_scene
from svo_raytracer_torch.ops import kernel_build, render_wave, skip_grid
from svo_raytracer_torch.ops import traverse, wavefront
from svo_raytracer_torch.utils.camera import Camera
from test_traverse_batch import random_rays

GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
             "-D__host__=", "-D__device__=")


@pytest.fixture(scope="module")
def host_trace():
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")

    def run(ws, o, d, alive, order=None):
        """K1's records over the rays taken in ``order`` (None: frame
        order) by the emulated warps; every slot starts as a sentinel that
        no record holds."""
        fn = kernel_build.load("wf_ray_host", ["wf_ray_host.cpp"], "g++",
                               GXX_FLAGS).wf_trace_host
        fn.argtypes = wavefront.K1.argtypes[:-1]     # no stream argument
        fn.restype = ctypes.c_int
        B = o.shape[0]
        out = [torch.full((B,), -7, dtype=dt) for dt in
               (torch.int32, torch.float32, torch.int32, torch.int32,
                torch.int32)]
        al = alive.to(torch.uint8)
        counter = torch.zeros(1, dtype=torch.int32)
        assert fn(*wavefront._table_args(ws), o.data_ptr(), d.data_ptr(),
                  al.data_ptr(), None if order is None else order.data_ptr(),
                  B, counter.data_ptr(), *[x.data_ptr() for x in out]) == 0
        assert int(counter) >= B            # every id was handed out
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


def _scene_rays(name, n=2048):
    """A world of the K1 cases and its voxel-unit rays, non-finite and
    inactive ones among them."""
    scene = (brick_scene.brickify(_esvo_tree(name)) if name == "terrain-64"
             else _scene(name))
    ws = wavefront.prepare(scene, "cpu")
    o, d = random_rays(n, seed=23)
    if name in ("g64", "paged-4096"):
        ao, ad = chip_smoke.aimed_rays(scene, n, seed=6)
        o, d = np.concatenate([o, ao]), np.concatenate([d, ad])
    o[::97] = np.nan
    d[5::89] = np.inf
    act = torch.ones(o.shape[0], dtype=torch.bool)
    act[7::41] = False
    return (ws, *wavefront._rays(ws, torch.from_numpy(o), torch.from_numpy(d),
                                 act))


@pytest.mark.parametrize("name", ["sphere-64", "terrain-64", "g64",
                                  "paged-4096"])
def test_cuda_source_key_order_equals_plain(host_trace, name):
    """The persistent schedule over the rays in key order (ray_order on
    the CPU): each record lands at its ray's own slot, equal in every
    field to trace_plain in frame order."""
    ws, o, d, alive = _scene_rays(name)
    order = wavefront.ray_order(ws, o, d, alive)
    assert not torch.equal(order, torch.arange(o.shape[0]))
    want = wavefront.trace_plain(ws, o, d, alive)
    got = host_trace(ws, o, d, alive, order)
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    assert (want[0] == wavefront.MIXED).any()


@pytest.mark.parametrize("case", ["B=0", "B=1", "B=37", "all-dead",
                                  "one-live", "dead-interleaved"])
def test_cuda_source_schedule_edges(host_trace, case):
    """Batch sizes that are not a multiple of 32, no rays, no live ray,
    one live ray, and a permutation with dead rays between live ones:
    every slot is written (none keeps the sentinel) and equals
    trace_plain."""
    ws, o, d, alive = _scene_rays("terrain-64", n=300)
    B = {"B=0": 0, "B=1": 1, "B=37": 37}.get(case, o.shape[0])
    o, d, alive = o[:B].contiguous(), d[:B].contiguous(), alive[:B].clone()
    if case == "all-dead":
        alive[:] = False
    elif case == "one-live":           # a ray that hits, alone
        live = int(torch.nonzero(wavefront.trace_plain(ws, o, d, alive)[0]
                                 == wavefront.MIXED)[0])
        alive[:] = False
        alive[live] = True
    order = wavefront.ray_order(ws, o, d, alive)
    if case == "dead-interleaved":
        order = torch.from_numpy(np.random.default_rng(4).permutation(B))
        assert (~alive[order[:B // 2]]).any()
    want = wavefront.trace_plain(ws, o, d, alive)
    got = host_trace(ws, o, d, alive, order)
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    assert not (got[0] == -7).any()
    if case == "one-live":
        assert int(got[0].ne(wavefront.MISS).sum()) == 1


@pytest.mark.parametrize("name", ["sphere-64", "terrain-64", "g64",
                                  "paged-4096"])
def test_ray_key_source_equals_plain(name):
    """K1's key kernel body (csrc/wf_ray.cuh::ray_key) against
    ray_keys_plain, with dead, non-finite and out-of-grid rays."""
    fn = _host_fn("wf_ray_host", "wf_ray_host.cpp", "wf_ray_keys_host",
                  wavefront.K1_KEYS.argtypes)
    ws, o, d, alive = _scene_rays(name)
    o[3::53] *= 40.0                       # far outside the grid: clamped
    want = wavefront.ray_keys_plain(ws, o, d, alive)
    got = torch.empty_like(want)
    assert fn(o.data_ptr(), d.data_ptr(), alive.to(torch.uint8).data_ptr(),
              o.shape[0], ws.grid_size, got.data_ptr()) == 0
    assert torch.equal(want, got)
    assert (want == wavefront.KEY_DEAD).any()


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


def _esvo_host(packed, o, d, alive, order=None, max_depth=13,
               cone_trace=False, max_iterations=1500, stack_depth=13):
    """KE's records by the g++ build of its schedule (blocks of 128 ids,
    ray order[id], cone-traced segments binned) and the ray each position
    traced; every slot starts as a sentinel that no record holds."""
    fn = _host_fn("esvo_host", "esvo_host.cpp", "esvo_trace_host",
                  traverse.KE.argtypes + [ctypes.c_void_p])
    B = o.shape[0]
    f_out = torch.full((len(traverse.F_FIELDS), B), -7.0)
    i_out = torch.full((len(traverse.I_FIELDS), B), -7, dtype=torch.int32)
    traced = torch.full((B,), -1, dtype=torch.int64)
    act = alive.to(torch.uint8)
    assert fn(packed.data_ptr(), o.data_ptr(), d.data_ptr(), act.data_ptr(),
              None if order is None else order.data_ptr(), B, max_depth,
              int(cone_trace), max_iterations, stack_depth,
              f_out.data_ptr(), i_out.data_ptr(), traced.data_ptr()) == 0
    got = dict(zip(traverse.F_FIELDS, f_out))
    got.update(zip(traverse.I_FIELDS, i_out))
    return got, traced


def _esvo_rays(tree, n=2048, seed=17, skip=False):
    o, d = random_rays(n, seed=seed)
    o[::97] = np.nan                        # non-finite rays retire at once
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    alive = torch.ones(n, dtype=torch.bool)
    alive[5::50] = False
    if skip:
        tab = torch.from_numpy(brick_scene.table_rows(
            skip_grid.build_skip_grid(tree, 32)))
        sk, maybe = skip_grid.skip_distances(tab, o, d, active=alive)
        o, alive = (o + sk[:, None] * d).contiguous(), maybe & alive
        assert (sk > 0).any() and (~maybe).any()
    return o, d, alive


def _port_tree(name):
    jt = _esvo_tree(name)
    from svo_raytracer_torch.core import octree
    return octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")


@pytest.mark.parametrize("name", ["sphere-64", "terrain-64", "checker-16",
                                  "terrain-64-skip"])
@pytest.mark.parametrize("kw", [dict(), dict(cone_trace=True, max_depth=3),
                                dict(max_iterations=5), dict(max_depth=3)])
def test_esvo_source_body_equals_plain(name, kw):
    """"-skip": the rays as the skip grid hands them to KE (moved to their
    skip distance, definite misses inactive).  max_depth 3 lies below every
    tree's depth, so the cutoff fires; with cone tracing the LOD clamp
    lifts rays past t = 0.05 to depth 11, below the cutoff."""
    tree = _port_tree(name.removesuffix("-skip"))
    packed = traverse.make_packed_table(tree)
    o, d, alive = _esvo_rays(tree, skip=name.endswith("-skip"))
    want = traverse.intersect_plain(packed, o, d, alive, **kw)
    got, _ = _esvo_host(packed, o, d, alive, **kw)
    assert _equal(want, got) == []
    assert (want["done"] == 1).any() and (want["scale"] < 23).any()
    deeper = (want["done"] == 1) & (traverse.MAX_SCALE - want["scale"] > 3)
    if not name.endswith("-skip"):  # skipped rays hit before t = 0.05
        assert bool(deeper.any()) == (kw.get("max_depth", 13) > 3
                                      or kw.get("cone_trace", False))
    if "max_iterations" in kw:
        assert (want["done"] == 0).any()


SCHEDULE_CASES = {
    "stack_depth=13": dict(),
    "stack_depth=23": dict(stack_depth=23, max_depth=23),
    "iteration cap": dict(max_iterations=9),
    "cone cutoff": dict(cone_trace=True, max_depth=3),
    "cone": dict(cone_trace=True),
    "skip rays": dict(),
    "cone skip rays": dict(cone_trace=True),
    "B=0": dict(), "B=1": dict(cone_trace=True), "B=37": dict(),
    "B=37 cone": dict(cone_trace=True), "all dead": dict(cone_trace=True),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_esvo_source_schedule_equals_plain(case):
    """KE's schedule (csrc/esvo.cu, emulated by esvo_host.cpp) over the
    rays in a permutation (a 64x32 image's tile order, or a random one
    for other batch sizes): every slot is written (none keeps the
    sentinel), each ray is traced once, and every field equals
    intersect_plain in frame order; cone-traced segments take the binned
    schedule."""
    kw = SCHEDULE_CASES[case]
    tree = _port_tree("terrain-64")
    packed = traverse.make_packed_table(tree)
    o, d, alive = _esvo_rays(tree, skip="skip" in case)
    B = int(case.split()[0][2:]) if case.startswith("B=") else o.shape[0]
    o, d, alive = o[:B].contiguous(), d[:B].contiguous(), alive[:B].clone()
    if case == "all dead":
        alive[:] = False
    order = (traverse.tile_order(64, 32, "cpu") if B == 64 * 32 else
             torch.from_numpy(np.random.default_rng(3).permutation(B)))
    want = traverse.intersect_plain(packed, o, d, alive, **kw)
    got, traced = _esvo_host(packed, o, d, alive, order, **kw)
    assert _equal(want, got) == []
    assert not (got["idx"] == -7).any()
    assert torch.equal(torch.sort(traced).values, torch.arange(B))
    if case == "iteration cap":
        assert (want["done"] == 0).any()


def test_esvo_source_bins_group_by_octant():
    """The binned schedule: each block of 128 ids traces the same rays,
    regrouped by direction octant (as _setup computes it) with the rays
    that retire at once (inactive or not finite) last."""
    tree = _port_tree("terrain-64")
    packed = traverse.make_packed_table(tree)
    o, d, alive = _esvo_rays(tree, n=1000)
    d[7::61, 0] = -0.0                      # -0 clamps to +EPS: octant bit
    order = torch.from_numpy(np.random.default_rng(5).permutation(1000))
    _, traced = _esvo_host(packed, o, d, alive, order, cone_trace=True)
    k = traverse._ray_consts(o, d, alive)
    bins = torch.where(k["dead0"], 8, k["octant"])
    for b0 in range(0, 1000, 128):
        blk = traced[b0:b0 + 128]
        assert torch.equal(torch.sort(blk).values,
                           torch.sort(order[b0:b0 + 128]).values)
        assert bool((bins[blk][1:] >= bins[blk][:-1]).all())
    assert (bins == 8).any() and len(torch.unique(bins)) == 9


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


@pytest.mark.parametrize("name, W, H", [("terrain-64", 64, 40),
                                        ("terrain-64", 48, 40),
                                        ("heightmap-256", 96, 70),
                                        ("paged-4096", 64, 48)])
def test_camera_source_body_equals_plain(name, W, H):
    """K1's camera mode: block-major frames with pad rows (W % 32 == 0)
    and row-major ones, flat and paged worlds."""
    fn = _host_fn("wf_ray_host", "wf_ray_host.cpp", "wf_trace_camera_host",
                  wavefront.K1_CAMERA.argtypes)
    scene = (brick_scene.brickify(_esvo_tree(name)) if name == "terrain-64"
             else _scene(name))
    ws = wavefront.prepare(scene, "cpu")
    if name == "paged-4096":     # looking down on the sparse bricks
        cam = Camera(pos=np.array([1.5, 1.45, 1.3]))
        cam.rotate(-0.9, 3.14)
    else:
        cam = Camera(pos=np.array([1.37, 1.81, 1.29]))
        cam.rotate(-0.6, 0.7)
    cam16 = wavefront.cam16(torch.tensor(cam.uniform(), dtype=torch.float32))
    n = render_wave._frame_B(W, H)
    nbx = W // 32 if render_wave._use_block(W) else 0
    want = wavefront.trace_camera_plain(ws, cam16, n, W, H, nbx)
    got = [torch.empty(n, dtype=a.dtype) for a in want]
    counter = torch.zeros(1, dtype=torch.int32)
    assert fn(*wavefront._table_args(ws), cam16.data_ptr(), W, H, nbx,
              ws.world_size, n, counter.data_ptr(),
              *[x.data_ptr() for x in got]) == 0
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    hits = (want[0] == wavefront.MIXED) | (want[0] == wavefront.UNIFORM)
    assert hits.any() and not hits.all()


@pytest.mark.parametrize("name", ["sphere-64", "terrain-64",
                                  "heightmap-256"])
@pytest.mark.parametrize("max_rounds", [24, 2])
def test_brick_round_source_body_equals_plain(name, max_rounds):
    """K3 on random rays, with inactive and non-finite ones, with every
    round and cut at 2 rounds."""
    fn = _host_fn("brick_round_host", "brick_round_host.cpp",
                  "brick_round_host", brick_pallas.K3.argtypes)
    scene = (brick_scene.brickify(_esvo_tree(name)) if name != "heightmap-256"
             else _scene(name)).to_device("cpu")
    o, d = random_rays(2048, seed=19)
    o[::97] = np.nan
    o = ((torch.from_numpy(o) - 1.0) * float(scene.world_size)).contiguous()
    d = torch.from_numpy(d)
    alive = torch.isfinite(o).all(1)
    alive[5::50] = False
    want = brick_pallas.trace_plain(scene, o, d, alive, max_rounds)
    got = {f: torch.empty_like(want[f], dtype=torch.int32 if f == "hit"
                               else want[f].dtype)
           for f in brick_pallas.FIELDS}
    al = alive.to(torch.uint8)
    assert fn(*brick_pallas._args(scene), max_rounds, o.data_ptr(),
              d.data_ptr(), al.data_ptr(), o.shape[0],
              *[got[f].data_ptr() for f in brick_pallas.FIELDS]) == 0
    got["hit"] = got["hit"] != 0
    assert _equal(want, got) == []
    assert want["hit"].any() and not want["hit"].all()
