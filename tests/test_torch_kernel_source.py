"""The kernels' own sources on the CPU: the per-ray bodies that the GPU
kernels run (csrc/wf_ray.cuh for K1 with its camera-mode ray derivation,
its sort keys and its persistent schedule, emulated by a host loop of
32-lane warps that take 32 ray ids at a time from a counter and write
through the sort permutation,
csrc/esvo_ray.cuh for KE with its schedule, emulated by a host loop of
128-ray blocks that trace through a permutation and regroup a
cone-traced segment's rays by octant, csrc/brick_dda.cuh for K2 and
csrc/brick_round.cuh for K3, each with its schedule emulated by a host
loop of blocks that take ids by a grid stride, K3's through a
permutation, csrc/gi_shade.cuh for GI_SHADE, mode 0's shading of a
segment, and csrc/decode.cuh for DECODE, a segment's hit decode)
compiled with g++, their CUDA qualifiers
defined away, into ctypes libraries, against their plain PyTorch versions
(wavefront.trace_plain and trace_camera_plain, traverse.intersect_plain,
brick_dda.coarse_dda_plain, brick_pallas.trace_plain,
shade.gi_update_plain, wavefront._finish_plain).

With no fused multiply-add on either side the two compute the same
float32 operations in the same order, so every record field must be
equal on every ray.  This catches logic slips in the CUDA source before
any GPU time.  GI_SHADE's cos, sin and acos are glibc's here and
torch's (SLEEF's) in the plain version, which differ by up to an ulp:
the values they enter are held to a stated ulp tolerance."""

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
from svo_raytracer_torch.ops import kernel_build, render_wave, rng, shade
from svo_raytracer_torch.ops import skip_grid, traverse, wavefront
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


def _dda_host(tab, G, o, d, alive, blocks=None):
    """K2's records by the g++ build of its schedule (``blocks`` blocks of
    256 threads taking rays by a grid stride; None: one ray per thread),
    and the times each ray was traced; every slot starts as a sentinel
    that no record holds.  ``alive`` None: every ray active; the rows of
    d may be one row expanded."""
    fn = _host_fn("dda_host", "brick_dda_host.cpp", "dda_march_host",
                  brick_dda.K2.argtypes[:-1]
                  + [ctypes.c_int, ctypes.c_void_p, None])
    B = o.shape[0]
    if blocks is None:
        blocks = -(-B // 256)
    got = dict(hit=torch.full((B,), True),
               t=torch.full((B,), -7.0),
               cell=torch.full((B, 3), -7, dtype=torch.int32),
               steps=torch.full((B,), -7, dtype=torch.int32))
    traced = torch.zeros(B, dtype=torch.int64)
    assert fn(tab.data_ptr(), G, 3 * G, o.data_ptr(), d.data_ptr(),
              brick_dda._row_stride(d),
              None if alive is None else alive.view(torch.uint8).data_ptr(),
              B,
              got["hit"].data_ptr(), got["t"].data_ptr(),
              got["cell"].data_ptr(), got["steps"].data_ptr(), blocks,
              traced.data_ptr()) == 0
    return got, traced


@pytest.mark.parametrize("name", ["random-8", "random-32", "skip-terrain-64"])
def test_dda_source_body_equals_plain(name):
    tab, G, o, d = _dda_cases(name)
    B = o.shape[0]
    alive = torch.rand(B, generator=torch.Generator().manual_seed(3)) < 0.9
    want = brick_dda.coarse_dda_plain(tab, o, d, G, 3 * G, alive)
    got, _ = _dda_host(tab, G, o, d, alive)
    assert _equal(want, got) == []
    assert want["hit"].any() and not want["hit"].all()


DDA_SCHEDULE_CASES = ("B=0", "B=1", "B=37", "all dead",
                      "expanded rows, three blocks",
                      "expanded rows, no active", "one block",
                      "three blocks")


@pytest.mark.parametrize("G", [1, 32, 64])
@pytest.mark.parametrize("case", DDA_SCHEDULE_CASES)
def test_dda_source_schedule_equals_plain(G, case):
    """K2's schedule (csrc/brick_dda.cu, emulated by brick_dda_host.cpp):
    resident blocks that take rays by a static grid stride (one or three
    blocks over 1,500 rays), every slot written and each ray traced
    once; records equal coarse_dda_plain.  The primary segment passes no active mask, the shadow
    segment one direction row expanded over the batch."""
    rng = np.random.default_rng(G)
    tab = torch.from_numpy(brick_scene.table_rows(
        brick_scene.pack_occupancy(rng.random((G,) * 3) < 0.05)))
    B = {"B=0": 0, "B=1": 1, "B=37": 37}.get(case, 1500)
    o = torch.from_numpy(np.where(
        rng.random((B, 1)) < 0.5, rng.uniform(0, G, (B, 3)),
        rng.uniform(-G, 2 * G, (B, 3))).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    alive = torch.from_numpy(rng.random(B) < 0.9)
    if case == "all dead":
        alive[:] = False
    blocks = {"one block": 1, "three blocks": 3,
              "expanded rows, three blocks": 3}.get(case)
    if case.startswith("expanded rows"):
        d = d[0].expand(B, 3)
        want = brick_dda.coarse_dda_plain(tab, o, d.contiguous(), G, 3 * G,
                                          torch.ones(B, dtype=torch.bool))
        got, traced = _dda_host(tab, G, o, d, None, blocks)
    else:
        want = brick_dda.coarse_dda_plain(tab, o, d, G, 3 * G, alive)
        got, traced = _dda_host(tab, G, o, d, alive, blocks)
    assert _equal(want, got) == []
    assert not (got["steps"] == -7).any()
    assert torch.equal(traced, torch.ones(B, dtype=torch.int64))
    if case == "all dead":
        assert not want["hit"].any() and not want["steps"].any()
    elif B == 1500 and G > 1:
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


def _k3_host(scene, o, d, alive, max_rounds, order=None):
    """K3's records by the g++ build of its schedule (id k traces ray
    order[k]) and the ray each id traced; every slot starts as a sentinel
    that no record holds."""
    fn = _host_fn("brick_round_host", "brick_round_host.cpp",
                  "brick_round_host", brick_pallas.K3.argtypes[:-1]
                  + [ctypes.c_void_p, None])
    B = o.shape[0]
    got = dict(hit=torch.full((B,), True),
               attr=torch.full((B,), -7, dtype=torch.int32),
               hvox=torch.full((B,), -7, dtype=torch.int32),
               t=torch.full((B,), -7.0),
               iters=torch.full((B,), -7, dtype=torch.int32))
    traced = torch.full((B,), -1, dtype=torch.int64)
    assert fn(*brick_pallas._args(scene), max_rounds, o.data_ptr(),
              d.data_ptr(), alive.view(torch.uint8).data_ptr(),
              None if order is None else order.data_ptr(), B,
              *[got[f].data_ptr() for f in brick_pallas.FIELDS],
              traced.data_ptr()) == 0
    return got, traced


def _k3_rays(scene, n=2048, seed=19):
    o, d = random_rays(n, seed=seed)
    o[::97] = np.nan
    o = ((torch.from_numpy(o) - 1.0) * float(scene.world_size)).contiguous()
    d = torch.from_numpy(d)
    alive = torch.isfinite(o).all(1)
    alive[5::50] = False
    return o, d, alive


@pytest.mark.parametrize("name", ["sphere-64", "terrain-64",
                                  "heightmap-256"])
@pytest.mark.parametrize("max_rounds", [24, 2])
def test_brick_round_source_body_equals_plain(name, max_rounds):
    """K3 on random rays, with inactive and non-finite ones, with every
    round and cut at 2 rounds."""
    scene = (brick_scene.brickify(_esvo_tree(name)) if name != "heightmap-256"
             else _scene(name)).to_device("cpu")
    o, d, alive = _k3_rays(scene)
    want = brick_pallas.trace_plain(scene, o, d, alive, max_rounds)
    got, _ = _k3_host(scene, o, d, alive, max_rounds)
    assert _equal(want, got) == []
    assert want["hit"].any() and not want["hit"].all()


K3_SCHEDULE_CASES = ("B=0", "B=1", "B=37", "B=129", "all dead",
                     "tile order", "random order")


@pytest.mark.parametrize("max_rounds", [24, 2])
@pytest.mark.parametrize("case", K3_SCHEDULE_CASES)
def test_brick_round_source_schedule_equals_plain(case, max_rounds):
    """K3's schedule (csrc/brick_round.cu, emulated by
    brick_round_host.cpp) over the rays in a permutation (a 64x32
    image's tile order, or a random one), one id per thread, batches
    that fill no block included: every slot is written, each id traces
    ray order[id], and every field equals trace_plain in ray order."""
    scene = brick_scene.brickify(_esvo_tree("terrain-64")).to_device("cpu")
    o, d, alive = _k3_rays(scene)
    B = {"B=0": 0, "B=1": 1, "B=37": 37, "B=129": 129}.get(case, 64 * 32)
    o, d, alive = o[:B].contiguous(), d[:B].contiguous(), alive[:B].clone()
    if case == "all dead":
        alive[:] = False
    order = (traverse.tile_order(64, 32, "cpu") if case == "tile order"
             else torch.from_numpy(np.random.default_rng(3).permutation(B)))
    want = brick_pallas.trace_plain(scene, o, d, alive, max_rounds)
    got, traced = _k3_host(scene, o, d, alive, max_rounds, order)
    assert _equal(want, got) == []
    assert not (got["iters"] == -7).any()
    assert torch.equal(traced, order)
    if case == "all dead":
        assert not want["hit"].any() and not want["iters"].any()
    elif B == 64 * 32:
        assert want["hit"].any() and not want["hit"].all()


def _column_scene():
    """A 64^3 world (G = 2) whose occupancy words differ from column to
    column: in brick (0,0,0) voxel columns (9,9) and (9,11) are empty but
    (10,9) and (9,12) hold voxel z = 5; brick (1,0,0) is empty and brick
    (1,1,0) holds one voxel, so its L0 column differs from (1,0)'s."""
    vox = np.zeros((64,) * 3, np.uint8)
    vox[10, 9, 5] = vox[9, 12, 5] = 3
    vox[40, 40, 20] = 1
    return brick_scene.brickify(build_np.build_octree_np(vox)).to_device(
        "cpu")


def test_brick_round_source_reloads_word_on_xy_steps():
    """Rays whose first step crosses an x or a y cell edge into a column
    that holds the next solid voxel (phase 1) or brick (phase 2) hit it:
    a DDA that kept the old column's word across steps (a design that
    measured slower, PERF.md §6) would march past.  A ray stepping along
    z stays in its empty column and misses."""
    scene = _column_scene()
    o = torch.tensor([[9.99, 9.5, 5.5],      # +x into column (10, 9)
                      [9.5, 11.99, 5.5],     # +y into column (9, 12)
                      [9.5, 9.5, 4.99],      # +z in column (9, 9): miss
                      [40.5, 31.99, 20.5],   # L0: +y into brick (1,1,0)
                      [31.99, 40.5, 20.5]])  # L0: +x into brick (1,1,0)
    d = torch.tensor([[1.0, 0.01, 0.02], [0.01, 1.0, 0.02],
                      [0.01, 0.02, 1.0], [0.01, 1.0, 0.02],
                      [1.0, 0.01, 0.02]])
    d = d / d.norm(dim=1, keepdim=True)
    alive = torch.ones(5, dtype=torch.bool)
    want = brick_pallas.trace_plain(scene, o, d, alive, 24)
    got, _ = _k3_host(scene, o, d, alive, 24)
    assert _equal(want, got) == []
    hv = want["hvox"]
    vox = torch.stack([hv // 64 // 64, hv // 64 % 64, hv % 64], 1)
    assert want["hit"].tolist() == [True, True, False, True, True]
    assert vox[0].tolist() == [10, 9, 5] and vox[1].tolist() == [9, 12, 5]
    assert vox[3].tolist() == [40, 40, 20] == vox[4].tolist()


# GI_SHADE's bounce directions (unit rows) within 4 ulps of 1.0, and the
# mask within 4 ulps of 1.0 times |mask * albedo|: the g++ build's glibc
# cos and sin and torch's CPU ones differ by up to an ulp (1.5 and 1.83
# ulps of 1.0 measured after the normalisation and n.l)
GI_ULPS = 4 * 2.0 ** -23


def _gi_host(first, mirrors, accum, mask, depth, iters_out, active, o, d, r,
             res):
    """gi_update's outputs by the g++ build of GI_SHADE's body; every
    slot starts as a sentinel."""
    fn = _host_fn("gi_shade_host", "gi_shade_host.cpp", "gi_shade_host",
                  shade.GI_SHADE.argtypes)
    B = accum.shape[0]
    out = (torch.full((B, 3), -7.0), torch.full((B, 3), -7.0),
           torch.full((B,), -7.0), torch.full((B,), -7, dtype=torch.int32),
           torch.full((B,), True), torch.full((B, 3), -7.0),
           torch.full((B, 3), -7.0))
    assert fn(B, int(first), shade._mirror_words(mirrors),
              active.data_ptr(), accum.data_ptr(), mask.data_ptr(),
              depth.data_ptr(), iters_out.data_ptr(), o.data_ptr(),
              *o.stride(), d.data_ptr(), *d.stride(), r.data_ptr(),
              res.hit.data_ptr(),
              res.value.data_ptr(), res.iters.data_ptr(), res.t.data_ptr(),
              res.normal.data_ptr(), res.voxel_pos.data_ptr(),
              *[x.data_ptr() for x in out]) == 0
    return out


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("mirrors", [(), (7,), (2, 7)])
def test_gi_shade_source_equals_plain(first, mirrors):
    """GI_SHADE's body against gi_update_plain on a segment of hits,
    misses and inactive rays (chip_smoke.gi_segment): active, iters,
    depth, origin and accum (its sun disk decided by acos) exactly; the
    direction and the mask exactly wherever cos and sin do not enter (a
    mirror's reflection, the -d fallback of a degenerate normal, every
    ray but the hits) and within GI_ULPS where they do.  Every branch
    occurs: primary and bounce misses with the sun disk on and off,
    mirrors, fallbacks of whole rows and of single components, palette
    and other materials, either bounce axis."""
    seg = chip_smoke.gi_segment(1 << 14, first, seed=11)
    accum, mask, depth, iters_out, active, o, d, r, res = seg
    fields = chip_smoke.GI_FIELDS
    want = dict(zip(fields, shade.gi_update_plain(first, mirrors, *seg)))
    got = dict(zip(fields, _gi_host(first, mirrors, *seg)))
    exact = ("accum", "depth", "iters_out", "active", "o")
    assert _equal({k: want[k] for k in exact}, got) == []

    hit = active & res.hit
    w = torch.nan_to_num(res.normal)
    bounce = shade.cosine_bounce(w, r)
    mirror = torch.zeros_like(hit)
    for v in mirrors:
        mirror = mirror | (res.value == v)
    trig = hit[:, None] & ~mirror[:, None] & torch.isfinite(bounce)
    gap = (want["d"] - got["d"]).abs()
    assert torch.equal(want["d"][~trig], got["d"][~trig])
    assert bool((gap[trig] <= GI_ULPS).all()), gap.max()
    row = trig.any(1)
    scale = (mask * shade.material_color(res.value, res.voxel_pos)).abs()
    gap = (want["mask"] - got["mask"]).abs()
    assert torch.equal(want["mask"][~row], got["mask"][~row])
    assert bool((gap[row] <= GI_ULPS * scale[row]).all())

    miss = active & ~res.hit
    sun = torch.arccos((d * torch.tensor(shade.SUN_DIR_GI)).sum(-1).clamp(
        -1.0, 1.0)) < 0.4
    pre = torch.where(mirror[:, None], shade.mirror_bounce(d, w), bounce)
    fell = hit[:, None] & ~torch.isfinite(pre)
    palette = (res.value >= 1) & (res.value <= 3)
    use_y = w[:, 0].abs() > 0.1
    assert (miss & sun).any() and (miss & ~sun).any() and (~active).any()
    assert fell.all(1).any()
    # only a mirror's reflection can overflow in some components alone
    assert bool((fell.any(1) & ~fell.all(1)).any()) == bool(mirrors)
    assert (hit & palette).any() and (hit & ~palette).any()
    assert (hit & use_y).any() and (hit & ~use_y).any()
    assert bool((hit & mirror).any()) == bool(mirrors)


# DECODE's cases: (scene, prepare's attr16 and attr2d, origins one
# camera row expanded, as a camera-mode frame's primary segment)
DECODE_CASES = {
    "sphere-64": ("sphere-64", False, None, False),
    "heightmap-256": ("heightmap-256", False, None, False),
    "heightmap-256-attr16": ("heightmap-256", True, None, False),
    "heightmap-256-2d": ("heightmap-256", False, True, False),
    "heightmap-256-camera-row": ("heightmap-256", False, None, True),
    "g64": ("g64", False, None, False),
    "g64-attr16-2d": ("g64", True, True, False),
    "paged-4096": ("paged-4096", False, None, False),
    "paged-4096-attr16": ("paged-4096", True, None, False),
    "paged-4096-2d": ("paged-4096", False, True, False),
}


def _decode_host(ws, rec, o, d):
    """The HitResult fields DECODE writes, by the g++ build of its body;
    every slot starts as a sentinel."""
    fn = _host_fn("decode_host", "decode_host.cpp", "decode_host",
                  wavefront.DECODE.argtypes)
    B = rec[0].shape[0]
    out = {f: torch.full((B, 3) if f in ("normal", "hit_pos", "voxel_pos")
                         else (B,), -7, dtype=dt)
           for f, dt in zip(wavefront.DECODE_OUTPUTS, (
               torch.bool, torch.int32, torch.float32, torch.float32,
               torch.int32, torch.float32, torch.float32, torch.float32,
               torch.int32))}
    assert fn(*wavefront._decode_layout(ws, B), ws.brick_slot.data_ptr(),
              ws.attr_comb.data_ptr(), *[x.data_ptr() for x in rec[:4]],
              o.data_ptr(), *o.stride(), d.data_ptr(), *d.stride(),
              *[out[f].data_ptr() for f in wavefront.DECODE_OUTPUTS]) == 0
    return out


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_source_equals_plain(case):
    """DECODE's body against _finish_plain on the records of K1's plain
    version (chip_smoke.decode_segment: misses, uniform and mixed hits,
    capped rays, non-finite and inactive rays), with raw-555 normals
    planted in the table (NaN in the same places): every field
    bit-equal, NaN compared by position, on each table layout (G = 2, 8,
    64 and paged G = 128; int32, attr16 and 2-D) and on a stride-0
    origin row."""
    name, attr16, attr2d, row = DECODE_CASES[case]
    scene = _scene(name)
    ws = wavefront.prepare(scene, "cpu", attr16=attr16, attr2d=attr2d)
    chip_smoke.plant_normal_555(ws)
    if row:      # outside the world, facing its side: uniform hits too
        cam = Camera(pos=np.array([0.6, 1.2, 0.6]))
        cam.rotate(0.0, 3.2)
        cam5 = torch.tensor(cam.uniform(), dtype=torch.float32)
        o, d, _, _ = render_wave._frame_rays(cam5, 64, 40)
        assert o.stride(0) == 0
        active = None
    else:
        o, d = random_rays(2048, seed=29)
        if name in ("g64", "paged-4096"):
            ao, ad = chip_smoke.aimed_rays(scene, 2048, seed=8)
            o, d = np.concatenate([o, ao]), np.concatenate([d, ad])
        o[::97] = np.nan
        d[5::89] = np.inf
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        active = torch.ones(o.shape[0], dtype=torch.bool)
        active[7::41] = False
    rec = chip_smoke.decode_segment(ws, o, d, active)
    want = wavefront._finish_plain(ws, rec, o, d)
    got = _decode_host(ws, rec, o, d)
    assert _equal({f: getattr(want, f) for f in wavefront.DECODE_OUTPUTS},
                  got) == []
    assert all(got[f].dtype == getattr(want, f).dtype for f in got)
    status = rec[0]
    assert (status == wavefront.MIXED).any() and (
        status == wavefront.MISS).any() and (status == wavefront.CAPPED
                                             ).any()
    assert (status == wavefront.UNIFORM).any() or name == "sphere-64"
    assert got["normal"][got["hit"]].isnan().any()
    assert (~got["normal"][got["hit"]].isnan()).any()
    assert (got["node"] == -1).any() and (got["node"] >= 0).any()


# RAYGEN's frames: block-major with pad rows, row-major (W % 32 != 0) and
# block-major with no pad rows (H % 32 == 0)
RAYGEN_SIZES = [(1920, 1080), (100, 37), (64, 64)]
RAYGEN_STATE = ("accum", "mask", "depth", "iters", "active")


def _raygen_camera():
    cam = Camera(pos=np.array([1.37, 1.81, 1.29]))
    cam.rotate(-0.6, 0.7)
    return torch.tensor(cam.uniform(), dtype=torch.float32)


def _raygen_host(cam5, W, H, frame):
    """frame_start's fields by the g++ build of RAYGEN's body; every slot
    starts as a sentinel, and without ``frame`` only the directions are
    given."""
    fn = _host_fn("raygen_host", "raygen_host.cpp", "raygen_host",
                  render_wave.RAYGEN.argtypes)
    B = render_wave._frame_B(W, H)
    out = {"dirs": torch.full((B, 3), -7.0)}
    if frame is not None:
        out.update(rand=torch.full((B,), -7.0),
                   accum=torch.full((B, 3), -7.0),
                   mask=torch.full((B, 3), -7.0),
                   depth=torch.full((B,), -7.0),
                   iters=torch.full((B,), -7, dtype=torch.int32),
                   active=torch.zeros(B, dtype=torch.bool))
    offsets = (0.0, 0.0) if frame is None else rng.frame_offsets(frame)
    ptrs = [x.data_ptr() for x in out.values()]
    nbx = W // 32 if render_wave._use_block(W) else 0
    assert fn(B, W, H, nbx, int(frame is not None), *offsets,
              cam5.data_ptr(), *cam5.stride(), *ptrs,
              *[None] * (7 - len(ptrs))) == 0
    return out


def _circular(a, b):
    d = (a.double() - b.double()).abs()
    return torch.minimum(d, 1.0 - d)


@pytest.mark.parametrize("frame", [1, 7, 4095, None])
@pytest.mark.parametrize("W, H", RAYGEN_SIZES)
def test_raygen_source_equals_plain(W, H, frame):
    """RAYGEN's body against _frame_start_plain (frame None: modes 1-3,
    the directions alone, from a column-major camera uniform, as
    Camera.uniform gives it, and a row-major one): directions and the
    shading state bit-equal;
    the random, whose sinf is glibc's here and torch's (SLEEF's) in the
    plain version, an ulp apart on some arguments, held to
    test_torch_shade.py::test_pixel_rand_statistics's contract for two
    sins an ulp apart, its exact share printed."""
    cam5 = _raygen_camera()
    want = render_wave._frame_start_plain(cam5, W, H, frame)
    got = _raygen_host(cam5, W, H, frame)
    assert torch.equal(want.dirs, got["dirs"])
    if frame is None:     # the camera read through either layout's strides
        assert want.rand is None and len(got) == 1
        assert not cam5.is_contiguous()
        rows = _raygen_host(cam5.contiguous(), W, H, None)
        assert torch.equal(rows["dirs"], got["dirs"])
        return
    assert _equal({k: getattr(want, k) for k in RAYGEN_STATE}, got) == []
    assert all(got[k].dtype == getattr(want, k).dtype for k in RAYGEN_STATE)
    r, g = want.rand, got["rand"]
    exact = float((r == g).double().mean())
    print(f"{W}x{H} frame {frame}: random exact on {exact:.4f}")
    assert (_circular(r, g) <= 1e-2).double().mean() >= 0.85
    assert abs(float(r.double().mean() - g.double().mean())) <= 5e-3
    hr = torch.histc(r, bins=10, min=0, max=1) / r.numel()
    hg = torch.histc(g, bins=10, min=0, max=1) / g.numel()
    assert float((hr - hg).abs().max()) <= 0.01
    assert bool(((g >= 0) & (g < 1)).all())


def test_frame_start_cpu_takes_the_plain_path():
    """A CPU camera takes _frame_start_plain (no RAYGEN launch); a mode-0
    start holds the rays of _frame_rays, pixel_rand of its pixels (pad
    rows' own row) and the state's fills."""
    cam5 = _raygen_camera()
    before = render_wave.RAYGEN.launches
    got = render_wave.frame_start(cam5, 64, 40, 3)
    assert render_wave.RAYGEN.launches == before
    o, d, px, py = render_wave._frame_rays(cam5, 64, 40)
    assert py.max() == 63 and got.origins.stride(0) == 0
    assert torch.equal(got.origins, o) and torch.equal(got.dirs, d)
    assert torch.equal(got.rand, rng.pixel_rand(px, py, 3))
    B = 64 * 64
    assert torch.equal(got.accum, torch.zeros(B, 3))
    assert torch.equal(got.mask, torch.ones(B, 3))
    assert torch.equal(got.depth, torch.full((B,), -1.0))
    assert torch.equal(got.iters, torch.zeros(B, dtype=torch.int32))
    assert bool(got.active.all()) and got.active.dtype == torch.bool
    rays = render_wave.frame_start(cam5, 64, 40)
    assert torch.equal(rays.dirs, d) and rays[2:] == (None,) * 6


@pytest.mark.parametrize("cam5, W, H", [
    (torch.zeros(4, 3), 64, 40), (torch.zeros(5, 3, dtype=torch.float64),
                                  64, 40),
    (torch.zeros(15), 64, 40), (torch.zeros(5, 3), 0, 40),
    (torch.zeros(5, 3), 64, 0)])
def test_frame_start_refuses_bad_input(cam5, W, H):
    with pytest.raises(ValueError):
        render_wave.frame_start(cam5, W, H, 1)


def test_raygen_wrapper_refuses_int32_overflow():
    """A frame of 2^31 rays or more passes RAYGEN's int32 ray ids: refused
    before anything is allocated or launched."""
    before = render_wave.RAYGEN.launches
    with pytest.raises(ValueError, match="int32"):
        render_wave._frame_start_kernel(_raygen_camera(), 65536, 32768, 1)
    assert render_wave.RAYGEN.launches == before
