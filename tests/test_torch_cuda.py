"""Kernels K1 (explicit and camera mode, its ray keys and its persistent
schedule), KE (its plain and binned schedules, through a permutation),
K2 (in ray order) and K3 (through a permutation), each with its
wrapper launching the kernel alone, on a CUDA GPU against their plain
PyTorch versions; GI_SHADE against gi_update_plain on a bench-sized
segment and in each caller's mode-0 frame; DECODE against _finish_plain
on bench-sized primary and bounce segments, on each table layout and in
a gi-3 frame; RAYGEN against _frame_start_plain on 1080p and odd-sized
frames and in mode-0 and mode-2 frames; the noise on the card
against the CPU's, the bench's small pipeline on the card, and the
differentiable renderers' compositor and train steps on the card
against the CPU's; the edit path (apply_patch, DeviceTree) and a viewer
session on the card against the CPU's; a traced frame's device records
under its ``svo.*`` spans.  Needs
a card and nvcc; skipped elsewhere.  The file imports no jax, so on a GPU host
without JAX it runs from the repository root with
``python -m pytest --noconftest tests/test_torch_cuda.py``."""

import os

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
    before = wavefront.K1.launches, wavefront.K1_KEYS.launches
    got = wavefront.trace(ws, o, d, alive)
    torch.cuda.synchronize()
    assert (wavefront.K1.launches, wavefront.K1_KEYS.launches) == (
        before[0] + 1, before[1] + 1)
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
        before = traverse.KE.launches + traverse.KE_BINNED.launches
        got = traverse.trace(packed, o, d, alive, **kw)
        torch.cuda.synchronize()
        assert (traverse.KE.launches + traverse.KE_BINNED.launches
                == before + 1)
        want = traverse.intersect_plain(packed, o, d, alive, **kw)
        assert _equal_fields(want, got) == [], kw
        assert (want["done"] == 1).any()
        deeper = ((want["done"] == 1)
                  & (traverse.MAX_SCALE - want["scale"] > 3))
        assert bool(deeper.any()) == (kw.get("max_depth", 13) > 3
                                      or kw.get("cone_trace", False)), kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["B=0", "B=1", "B=37", "B=1000",
                                  "all-dead", "stack_depth=23", "tiles"])
def test_esvo_schedule_edges_on_gpu(case):
    """KE's schedules against intersect_plain: the plain one and, on
    cone-traced rays, the binned one (KE_BINNED), each in frame order and
    through a permutation (a 128x64 image's tile order, or a random one):
    batches that are no multiple of the block, no rays, no live ray, the
    full stack window.  Every slot is written (compared field by field)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import traverse
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7)
                                    ).to_device("cuda")
    packed = traverse.make_packed_table(tree)
    o, d = _rays(8192, seed=8)
    alive = torch.ones(8192, dtype=torch.bool, device="cuda")
    alive[5::33] = False
    B = {"B=0": 0, "B=1": 1, "B=37": 37, "B=1000": 1000}.get(case, 8192)
    o, d, alive = o[:B].contiguous(), d[:B].contiguous(), alive[:B].clone()
    if case == "all-dead":
        alive[:] = False
    extra = (dict(stack_depth=23, max_depth=23) if case == "stack_depth=23"
             else {})
    perm = (traverse.tile_order(128, 64, "cuda") if B == 8192 else
            torch.from_numpy(np.random.default_rng(4).permutation(B)).cuda())
    for cone in (False, True):
        kw = dict(cone_trace=cone, **extra)
        want = traverse.intersect_plain(packed, o, d, alive, **kw)
        for order in (perm, None):
            before = traverse.KE_BINNED.launches
            got = traverse.intersect_kernel(packed, o, d, alive, order=order,
                                            **kw)
            torch.cuda.synchronize()
            assert traverse.KE_BINNED.launches - before == int(cone and B > 0)
            assert _equal_fields(want, got) == [], (kw, order is None)


@pytest.mark.gpu
def test_esvo_render_schedule_on_gpu():
    """A mode-0 gi-1 render: one KE launch per segment, the bounce in the
    binned schedule; both segments in the image's tile order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import shade, traverse
    from svo_raytracer_torch.utils.camera import Camera
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7)
                                    ).to_device("cuda")
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")
    k = (traverse.KE, traverse.KE_BINNED)
    before = [x.launches for x in k]
    stats = []
    with chip_smoke.capture(traverse, "intersect_kernel") as calls:
        shade.render_image(tree, cam5, 96, 64, render_mode=0, gi_bounces=1,
                           stats=stats)
    torch.cuda.synchronize()
    assert [x.launches - b for x, b in zip(k, before)] == [1, 1]
    assert [s["launches"] for s in stats] == [1, 1]
    tiles = traverse.tile_order(96, 64, "cuda")
    assert all(kw["order"] is tiles for _, kw in calls)


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


@pytest.mark.gpu
@pytest.mark.parametrize("W, H", [(64, 40), (48, 40), (1920, 1080)])
def test_camera_kernel_equals_plain_on_gpu(W, H):
    """K1 in camera mode against trace_camera_plain: block-major frames
    with pad rows (W % 32 == 0) and a row-major one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import render_wave
    from svo_raytracer_torch.utils.camera import Camera
    hm, mm = bigworld.fractal_heightmap(256, seed=3, lo=0.3, hi=0.9)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 256),
                           "cuda")
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam16 = wavefront.cam16(torch.tensor(cam.uniform(), dtype=torch.float32,
                                         device="cuda"))
    n = render_wave._frame_B(W, H)
    nbx = W // 32 if render_wave._use_block(W) else 0
    before = wavefront.K1.launches, wavefront.K1_CAMERA.launches
    got = wavefront.trace_camera(ws, cam16, n, W, H, nbx)
    torch.cuda.synchronize()
    assert (wavefront.K1.launches, wavefront.K1_CAMERA.launches) == (
        before[0], before[1] + 1)
    want = wavefront.trace_camera_plain(ws, cam16, n, W, H, nbx)
    for field, a, b in zip(("status", "t", "cell", "widx", "iters"), want,
                           got):
        assert torch.equal(a, b), field
    hits = (want[0] == wavefront.MIXED) | (want[0] == wavefront.UNIFORM)
    assert hits.any() and not hits.all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sphere-64", "terrain-64"])
def test_brick_round_kernel_equals_plain_on_gpu(name):
    """Kernel K3 against brick_pallas.trace_plain: every field of every
    ray, inactive and non-finite rays included, and with few rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_pallas, brick_scene
    vox = (chip_smoke.sphere_voxels(64, 24) if name == "sphere-64"
           else chip_smoke.terrain_voxels(64, 7))
    scene = brick_scene.brickify(build_np.build_octree_np(vox)).to_device(
        "cuda")
    o, d = _rays(8192, seed=7)
    ov = ((o - 1.0) * float(scene.world_size)).contiguous()
    alive = torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
    alive[3::40] = False
    for rounds in (24, 2):
        before = brick_pallas.K3.launches
        got = brick_pallas.trace(scene, ov, d, alive, rounds)
        torch.cuda.synchronize()
        assert brick_pallas.K3.launches == before + 1
        want = brick_pallas.trace_plain(scene, ov, d, alive, rounds)
        assert _equal_fields(want, got) == [], rounds
        assert want["hit"].any() and not want["hit"].all()


def _terrain_bricks(dev):
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_scene
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7))
    return brick_scene.brickify(tree).to_device(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("max_rounds", [24, 2])
@pytest.mark.parametrize("case", ["B=0", "B=1", "B=37", "all-dead",
                                  "tile-order", "permutation"])
def test_brick_round_schedule_on_gpu(case, max_rounds):
    """K3 over the rays in a permutation (a 64x32 image's tile order or a
    random one) and in ray order against trace_plain: every field of
    every slot, batches that fill no block, no live ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import brick_pallas, traverse
    scene = _terrain_bricks("cuda")
    o, d = _rays(2048, seed=21)
    ov = ((o - 1.0) * float(scene.world_size)).contiguous()
    alive = torch.isfinite(ov).all(1)
    alive[4::33] = False
    B = {"B=0": 0, "B=1": 1, "B=37": 37}.get(case, 2048)
    ov, d, alive = ov[:B].contiguous(), d[:B].contiguous(), alive[:B].clone()
    if case == "all-dead":
        alive[:] = False
    order = (traverse.tile_order(64, 32, "cuda") if case == "tile-order"
             else chip_smoke.permutation(B, "cuda"))
    want = brick_pallas.trace_plain(scene, ov, d, alive, max_rounds)
    for perm in (order, None):
        before = brick_pallas.K3.launches
        got = brick_pallas.trace(scene, ov, d, alive, max_rounds, perm)
        torch.cuda.synchronize()
        assert brick_pallas.K3.launches == before + (B > 0)
        assert _equal_fields(want, got) == [], perm is None


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 32, 64])
@pytest.mark.parametrize("case", ["B=0", "B=1", "B=37", "all-dead",
                                  "300000 rays", "expanded-no-active"])
def test_dda_schedule_on_gpu(G, case):
    """K2 (resident blocks, a static grid stride) against
    coarse_dda_plain; with one direction row expanded over the batch and
    no active mask, as the skip frames' shadow and primary segments pass
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import brick_dda, brick_scene
    gen = np.random.default_rng(G + 7)
    tab = torch.from_numpy(brick_scene.table_rows(brick_scene.pack_occupancy(
        gen.random((G, G, G)) < 0.05))).cuda()
    B = {"B=0": 0, "B=1": 1, "B=37": 37}.get(case, 300000)
    o = torch.from_numpy(gen.uniform(-G, 2 * G, (B, 3)).astype(
        np.float32)).cuda()
    d = torch.from_numpy(gen.normal(size=(B, 3)).astype(np.float32)).cuda()
    d = d / d.norm(dim=1, keepdim=True)
    alive = torch.from_numpy(gen.random(B) < 0.9).cuda()
    if case == "all-dead":
        alive[:] = False
    if case == "expanded-no-active":
        d, alive = d[0].expand(B, 3), None
    live = torch.ones(B, dtype=torch.bool, device="cuda") \
        if alive is None else alive
    want = brick_dda.coarse_dda_plain(tab, o, d.contiguous(), G, 3 * G, live)
    before = brick_dda.K2.launches
    got = brick_dda.coarse_dda(tab, o, d, G, active=alive)
    torch.cuda.synchronize()
    assert brick_dda.K2.launches == before + (B > 0)
    assert _equal_fields(want, got) == []


@pytest.mark.gpu
def test_k2_k3_wrappers_launch_their_kernel_alone_on_gpu():
    """One call of K2's and of K3's wrapper on bool masks, packed and
    expanded rows launches that kernel and no other device kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import brick_dda, brick_pallas, brick_scene
    tab = torch.from_numpy(brick_scene.table_rows(brick_scene.pack_occupancy(
        np.random.default_rng(1).random((64,) * 3) < 0.05))).cuda()
    o, d = _rays(4096, seed=3)
    o = o.nan_to_num()
    alive = torch.ones(4096, dtype=torch.bool, device="cuda")
    order = chip_smoke.permutation(4096, "cuda")
    sun = torch.tensor([0.3, 0.8, 0.5], device="cuda").expand(4096, 3)
    og = o * 64.0
    brick_dda.coarse_dda(tab, og, d, 64)          # built and loaded
    chip_smoke.only_kernel("K2", lambda: brick_dda.coarse_dda(
        tab, og, sun, 64, active=alive), "K2")
    scene = _terrain_bricks("cuda")
    ov = ((o - 1.0) * float(scene.world_size)).contiguous()
    brick_pallas.trace(scene, ov, d, alive, 24)
    chip_smoke.only_kernel("K3", lambda: brick_pallas.trace(
        scene, ov, d, alive, 24, order), "K3")


@pytest.mark.gpu
def test_render_gives_ke_the_tiles_and_k2_ray_order_on_gpu():
    """With a skip grid, render_image on the card hands KE the cached
    tile permutation and K2 the rays in ray order, one K2 launch per
    segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_dda, brick_scene, shade
    from svo_raytracer_torch.ops import skip_grid, traverse
    from svo_raytracer_torch.utils.camera import Camera
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7)
                                    ).to_device("cuda")
    tab = torch.from_numpy(brick_scene.table_rows(
        skip_grid.build_skip_grid(tree, 32))).cuda()
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")
    before = brick_dda.K2.launches
    with chip_smoke.capture(traverse, "trace") as ke, \
            chip_smoke.capture(brick_dda, "coarse_dda") as k2:
        shade.render_image(tree, cam5, 96, 64, render_mode=2,
                           skip_tab=tab, skip_grid_size=32)
    torch.cuda.synchronize()
    assert brick_dda.K2.launches == before + 2
    tiles = traverse.tile_order(96, 64, "cuda")
    assert len(ke) == 2 and all(k["order"] is tiles for _, k in ke)
    assert len(k2) == 2 and all("order" not in k for _, k in k2)


def _terrain_world():
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_scene
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7))
    return wavefront.prepare(brick_scene.brickify(tree), "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["B=0", "B=1", "B=37", "B=1000",
                                  "all-dead", "one-live", "dead-interleaved"])
def test_kernel_schedule_edges_on_gpu(case):
    """K1's persistent schedule against trace_plain, in key order and in
    frame order: batches that are no multiple of 32 or of the block size,
    no rays, no live ray, one live ray, and a permutation with dead rays
    between live ones.  Every slot is written (none keeps the sentinel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ws = _terrain_world()
    o, d = _rays(1000, seed=9)
    o, d, alive = wavefront._rays(ws, o, d)
    B = {"B=0": 0, "B=1": 1, "B=37": 37}.get(case, 1000)
    o, d, alive = o[:B].contiguous(), d[:B].contiguous(), alive[:B].clone()
    if case == "all-dead":
        alive[:] = False
    elif case == "one-live":
        live = int(torch.nonzero(wavefront.trace_plain(ws, o, d, alive)[0]
                                 == wavefront.MIXED)[0])
        alive[:] = False
        alive[live] = True
    order = wavefront.ray_order(ws, o, d, alive)
    if case == "dead-interleaved":
        order = torch.from_numpy(np.random.default_rng(4).permutation(B)
                                 ).cuda()
    want = wavefront.trace_plain(ws, o, d, alive)
    for perm in (order, None):
        got = wavefront.trace_kernel(ws, o, d, alive, perm)
        torch.cuda.synchronize()
        for field, a, b in zip(("status", "t", "cell", "widx", "iters"),
                               want, got):
            assert torch.equal(a, b), (field, perm is None)


@pytest.mark.gpu
def test_kernel_g64_camera_and_grid_on_gpu():
    """The G = 64 world in camera mode and in key order against the plain
    versions, and K1's persistent grid: the 7 resident blocks per SM that
    its __launch_bounds__ asks for, in both modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import render_wave
    from svo_raytracer_torch.utils.camera import Camera
    scene = chip_smoke.g64_scene()
    ws = wavefront.prepare(scene, "cuda")
    for camera in (False, True):
        info = wavefront.launch_info(ws, camera=camera)
        assert info["blocks_per_sm"] >= 7 and info["threads"] == 128
        assert info["grid"] == info["blocks_per_sm"] * info["sms"]
    o, d = chip_smoke.aimed_rays(scene, 8192, seed=2)
    o, d, alive = wavefront._rays(ws, torch.from_numpy(o).cuda(),
                                  torch.from_numpy(d).cuda())
    cam = Camera(pos=np.array([1.5, 1.9, 1.5]))
    cam.rotate(-1.2, 0.3)
    cam16 = wavefront.cam16(torch.tensor(cam.uniform(), dtype=torch.float32,
                                         device="cuda"))
    n = render_wave._frame_B(128, 96)
    want = (wavefront.trace_plain(ws, o, d, alive),
            wavefront.trace_camera_plain(ws, cam16, n, 128, 96, 4))
    got = (wavefront.trace(ws, o, d, alive),
           wavefront.trace_camera(ws, cam16, n, 128, 96, 4))
    torch.cuda.synchronize()
    for mode, w, g in zip(("explicit", "camera"), want, got):
        for field, a, b in zip(("status", "t", "cell", "widx", "iters"),
                               w, g):
            assert torch.equal(a, b), (field, mode)


@pytest.mark.gpu
def test_launch_counters_once_per_segment():
    """A gi-2 frame: one K1 launch per explicit segment and one of its
    camera-mode entry for the primary, each entry counting its own, one
    key launch per explicit segment, one DECODE and one GI_SHADE launch
    per segment, and one RAYGEN launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import render_wave, shade
    from svo_raytracer_torch.utils.camera import Camera
    hm, mm = bigworld.fractal_heightmap(256, seed=3, lo=0.3, hi=0.9)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 256),
                           "cuda")
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")
    k = (wavefront.K1, wavefront.K1_CAMERA, wavefront.K1_KEYS,
         shade.GI_SHADE, wavefront.DECODE, render_wave.RAYGEN)
    before = [x.launches for x in k]
    stats = []
    render_wave.render_frame_wavefront(ws, cam5, 64, 48, render_mode=0,
                                       gi_bounces=2, stats=stats)
    torch.cuda.synchronize()
    assert [x.launches - b for x, b in zip(k, before)] == [2, 1, 2, 3, 3, 1]
    assert [s["launches"] for s in stats] == [1, 1, 1]


@pytest.mark.gpu
def test_failed_launch_raises_and_is_not_counted():
    """Kernel.launch passes torch's current stream last, turns a non-zero
    cudaError into a RuntimeError naming the entry point and counts only
    the launches that succeed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import kernel_build
    k = kernel_build.Kernel("wavefront", ["wavefront.cu"], "wf_trace", [])
    calls = []
    k.fn = lambda *args: calls.append(args) or 700
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="wf_trace.*cudaError 700"):
            k.launch(torch.device("cuda"), 3, 4)
    assert calls == [(3, 4, side.cuda_stream)]
    assert k.launches == 0
    k.fn = lambda *args: 0
    k.launch(torch.device("cuda"))
    assert k.launches == 1


@pytest.mark.gpu
def test_frame_spans_hold_the_device_records_on_gpu():
    """A few traced gi-3 frames on the card (the benchmark's trace and
    span readers, portbench/trace.py and spans.py): at least 99% of the
    device records were launched inside a child span of ``svo.frame``,
    and K1's launches and the ray order's fall under ``svo.k1`` and
    ``svo.order``; ``svo.shade`` holds one record a segment, GI_SHADE's,
    and ``svo.decode`` one, DECODE's; ``svo.assembly`` holds RAYGEN's
    record and the three copies of _unblock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from portbench import spans, trace
    from svo_raytracer_torch.ops import render_wave
    from svo_raytracer_torch.utils.camera import Camera
    hm, mm = bigworld.fractal_heightmap(256, seed=3, lo=0.3, hi=0.9)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 256),
                           "cuda")
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")

    def run(step):
        for i in range(6):
            render_wave.render_frame_wavefront(ws, cam5, 256, 160,
                                               render_mode=0,
                                               frame_number=i + 1,
                                               gi_bounces=3)
            torch.cuda.synchronize()
            step()

    _, t = trace.traced(run, 2, 4, torch.cuda.synchronize)
    s = spans.split(t)
    inside = sum(v for k, v in s.shares.items() if k != "svo.frame")
    assert inside >= 0.99, (s.shares, s.unattributed, s.unlaunched)
    # K1 once a segment, the keys and the sort's kernels per explicit one
    assert s.kernels["svo.k1"] == 4 and s.kernels["svo.order"] >= 3
    assert s.kernels["svo.shade"] == 4
    assert s.kernels["svo.decode"] == 4
    assert s.kernels["svo.assembly"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["primary", "bounce", "mirrors",
                                  "columns"])
def test_gi_shade_kernel_equals_plain_on_gpu(kind):
    """GI_SHADE against gi_update_plain on the card, on a segment of the
    bench frame's 1920 x 1088 rays (chip_smoke.gi_segment: hits, misses,
    inactive rays, degenerate and infinite normals): every output equal
    on every ray, one launch, and the inputs left as they were.
    ``columns``: the record's fields are columns of wider tensors, as
    parallel/bricks.py's nearest-hit merge returns them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import shade
    first = kind == "primary"
    mirrors = (2, 7) if kind == "mirrors" else ()
    seg = chip_smoke.gi_segment(1920 * 1088, first, seed=21, device="cuda")
    if kind == "columns":
        res = seg[-1]
        ints = torch.stack([res.value, res.depth, res.iters], 1)
        floats = torch.cat([res.t[:, None], res.normal, res.voxel_pos], 1)
        seg = seg[:-1] + (res._replace(
            value=ints[:, 0], iters=ints[:, 2], t=floats[:, 0],
            normal=floats[:, 1:4], voxel_pos=floats[:, 4:7]),)
        assert not seg[-1].normal.is_contiguous()
    inputs = [a.clone() for a in seg[:-1]]
    before = shade.GI_SHADE.launches
    got = shade.gi_update(first, mirrors, *seg)
    torch.cuda.synchronize()
    assert shade.GI_SHADE.launches == before + 1
    want = shade.gi_update_plain(first, mirrors, *seg)
    fields = chip_smoke.GI_FIELDS
    assert _equal_fields(dict(zip(fields, want)),
                         dict(zip(fields, got))) == []
    assert all(torch.equal(a, b) for a, b in zip(inputs, seg[:-1]))


def _gi_frame(caller, cam5, tmp_path):
    """(segments a frame, render()) of one caller of gi_update on the card:
    render_frame_wavefront (gi-3, a mirror), the ESVO render_image (gi-2,
    a mirror), render_progressive (threefry random, 2 samples of gi-1) or
    make_wave_sharded_render (gi-2) on a one-rank gloo mesh."""
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import render_wave, shade
    from svo_raytracer_torch.parallel import distributed, mesh
    from svo_raytracer_torch.parallel import render_wave_sharded as rws
    if caller in ("esvo", "progressive"):
        tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7)
                                        ).to_device("cuda")
        if caller == "esvo":
            return 3, lambda: shade.render_image(
                tree, cam5, 96, 64, render_mode=0, gi_bounces=2,
                mirror_values=(3,))
        return 4, lambda: shade.render_progressive(tree, cam5, 96, 64,
                                                   spp=2, gi_bounces=1)
    hm, mm = bigworld.fractal_heightmap(256, seed=3, lo=0.3, hi=0.9)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 256),
                           "cuda")
    if caller == "wavefront":
        return 4, lambda: render_wave.render_frame_wavefront(
            ws, cam5, 256, 160, render_mode=0, gi_bounces=3,
            mirror_values=(2,))
    distributed.init_distributed("gloo", f"file://{tmp_path}/store", 1, 0)
    render = rws.make_wave_sharded_render(mesh.tile_mesh(1), ws, 128, 96,
                                          render_mode=0, gi_bounces=2)
    return 3, lambda: render(ws, cam5)


@pytest.mark.gpu
@pytest.mark.parametrize("caller", ["wavefront", "esvo", "progressive",
                                    "sharded"])
def test_gi_frames_equal_plain_shading_on_gpu(caller, monkeypatch,
                                              tmp_path):
    """Each caller of gi_update renders on the card the frame that
    gi_update_plain shades (_gi_frame), with one GI_SHADE launch per
    segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import shade
    from svo_raytracer_torch.utils.camera import Camera
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")
    try:
        segments, render = _gi_frame(caller, cam5, tmp_path)
        before = shade.GI_SHADE.launches
        got = render()
        torch.cuda.synchronize()
        assert shade.GI_SHADE.launches == before + segments
        monkeypatch.setattr(shade, "gi_update", shade.gi_update_plain)
        want = render()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    for a, b in zip(want, got):
        if isinstance(a, torch.Tensor):
            assert bool(chip_smoke.same(a, b).all())
        else:
            assert a == b


def _decode_case(kind):
    """(ws, record, origins, dirs) of a DECODE case on the card, raw-555
    normals planted in the table (chip_smoke.plant_normal_555).
    ``primary`` and ``bounce``: a 1920 x 1080 frame's segments on a 256^3
    heightmap (1920 x 1088 rays; the primary in K1's camera mode, its
    origins one camera row expanded; the bounce explicit rays from the
    primary's hits); the rest: random and aimed rays on each table
    layout."""
    from svo_raytracer_torch.ops import render_wave
    from svo_raytracer_torch.utils.camera import Camera
    name, attr16, attr2d = {
        "primary": ("heightmap-256", False, None),
        "bounce": ("heightmap-256", False, None),
        "attr16": ("heightmap-256", True, None),
        "2d": ("heightmap-256", False, True),
        "g64": ("g64", False, None),
        "paged-4096": ("paged-4096", False, None),
        "paged-4096-attr16-2d": ("paged-4096", True, True)}[kind]
    if name == "g64":
        scene = chip_smoke.g64_scene()
    elif name == "paged-4096":
        scene = chip_smoke.sparse_paged_scene()
    else:
        hm, mm = bigworld.fractal_heightmap(256, seed=3, lo=0.3, hi=0.9)
        scene = bigworld.heightmap_brick_scene(hm, mm, 256)
    ws = wavefront.prepare(scene, "cuda", attr16=attr16, attr2d=attr2d)
    chip_smoke.plant_normal_555(ws)
    if kind not in ("primary", "bounce"):
        o, d = _rays(1 << 16, seed=31)
        if name != "heightmap-256":
            ao, ad = chip_smoke.aimed_rays(scene, 1 << 16, seed=9)
            o = torch.cat([o, torch.from_numpy(ao).cuda()])
            d = torch.cat([d, torch.from_numpy(ad).cuda()])
        return ws, chip_smoke.decode_segment(ws, o, d), o, d
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")
    W, H = 1920, 1080
    o, d, _, _ = render_wave._frame_rays(cam5, W, H)
    rec = wavefront.trace_camera(ws, wavefront.cam16(cam5), d.shape[0], W,
                                 H, W // 32)
    rec[0][::13] = wavefront.CAPPED
    if kind == "primary":
        return ws, rec, o, d
    prim = wavefront._finish_plain(ws, rec, o, d)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rd = torch.randn(d.shape, device="cuda", generator=gen)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    rd = torch.where((rd * torch.nan_to_num(prim.normal)).sum(
        -1, keepdim=True) < 0, -rd, rd)
    o2 = prim.voxel_pos.contiguous()
    return ws, chip_smoke.decode_segment(ws, o2, rd, prim.hit), o2, rd


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["primary", "bounce", "attr16", "2d", "g64",
                                  "paged-4096", "paged-4096-attr16-2d"])
def test_decode_kernel_equals_plain_on_gpu(kind):
    """DECODE against _finish_plain on the card (_decode_case: misses,
    uniform and mixed hits, capped, non-finite and inactive rays, NaN
    normals): every HitResult field bit-equal, NaN compared by position,
    one launch, and the record and rays left as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ws, rec, o, d = _decode_case(kind)
    inputs = [a.clone() for a in (*rec, o, d)]
    before = wavefront.DECODE.launches
    got = wavefront._finish(ws, rec, o, d)
    torch.cuda.synchronize()
    assert wavefront.DECODE.launches == before + 1
    want = wavefront._finish_plain(ws, rec, o, d)
    assert _equal_fields(want._asdict(), got._asdict()) == []
    assert all(a.dtype == b.dtype and a.shape == b.shape
               for a, b in zip(want, got))
    assert all(bool(chip_smoke.same(a, b).all())
               for a, b in zip(inputs, (*rec, o, d)))
    assert o.stride(0) == (0 if kind == "primary" else 3)
    status = rec[0]
    assert (status == wavefront.MIXED).any() and (
        status == wavefront.CAPPED).any() and (status == wavefront.MISS).any()
    assert got.normal[got.hit].isnan().any()


@pytest.mark.gpu
def test_gi_frame_equals_plain_decode_on_gpu(monkeypatch):
    """A gi-3 frame through render_frame_wavefront, with one DECODE launch
    per segment, equals in every output the frame whose segments
    _finish_plain decodes on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import render_wave
    from svo_raytracer_torch.utils.camera import Camera
    hm, mm = bigworld.fractal_heightmap(256, seed=3, lo=0.3, hi=0.9)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 256),
                           "cuda")
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")

    def render():
        return render_wave.render_frame_wavefront(
            ws, cam5, 256, 160, render_mode=0, frame_number=3, gi_bounces=3)

    before = wavefront.DECODE.launches
    got = render()
    torch.cuda.synchronize()
    assert wavefront.DECODE.launches == before + 4
    monkeypatch.setattr(wavefront, "_finish", wavefront._finish_plain)
    want = render()
    assert wavefront.DECODE.launches == before + 4
    for a, b in zip(want, got):
        if isinstance(a, torch.Tensor):
            assert bool(chip_smoke.same(a, b).all())
        else:
            assert a == b


def _raygen_camera():
    """The heightmap frames' camera, its uniform column-major as
    Camera.uniform gives it."""
    from svo_raytracer_torch.utils.camera import Camera
    cam = Camera(pos=np.array([1.3, 1.8, 1.3]))
    cam.rotate(-0.5, 0.6)
    return torch.tensor(cam.uniform(), dtype=torch.float32, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("frame", [1, 7, 4095, None])
@pytest.mark.parametrize("W, H", [(1920, 1080), (100, 37), (64, 64)])
def test_raygen_kernel_equals_plain_on_gpu(W, H, frame):
    """RAYGEN against _frame_start_plain (_frame_rays, rng.pixel_rand and
    the state's fills) on the card: block-major with pad rows, row-major
    (W % 32 != 0) and block-major without pad rows; render mode 0 at
    frames 1, 7 and 4095 (sin arguments past 105,615, where sinf takes
    its slow reduction), and modes 1-3 (frame None, the directions
    alone).  Every field bit-equal, the random included, in one launch;
    the camera, read through its column-major strides, left as it
    was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import render_wave
    cam5 = _raygen_camera()
    assert not cam5.is_contiguous()
    kept = cam5.clone()
    before = render_wave.RAYGEN.launches
    got = render_wave.frame_start(cam5, W, H, frame)
    torch.cuda.synchronize()
    assert render_wave.RAYGEN.launches == before + 1
    want = render_wave._frame_start_plain(cam5, W, H, frame)
    assert torch.equal(cam5, kept)
    assert got.origins.stride(0) == 0
    for field in render_wave.FrameStart._fields:
        a, b = getattr(want, field), getattr(got, field)
        if a is None:
            assert b is None and frame is None, field
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), (field, int((a != b).sum()))
    assert got.dirs.shape[0] == render_wave._frame_B(W, H)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 2])
def test_raygen_frames_equal_plain_assembly_on_gpu(mode, monkeypatch):
    """A gi-3 mode-0 frame and a mode-2 frame through
    render_frame_wavefront, with one RAYGEN launch a frame, equal in
    every output the frames whose start _frame_start_plain assembles on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.ops import render_wave
    hm, mm = bigworld.fractal_heightmap(256, seed=3, lo=0.3, hi=0.9)
    ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 256),
                           "cuda")
    cam5 = _raygen_camera()

    def render():
        return render_wave.render_frame_wavefront(
            ws, cam5, 256, 160, render_mode=mode, frame_number=4093,
            gi_bounces=3, mirror_values=(2,))

    before = render_wave.RAYGEN.launches
    got = render()
    torch.cuda.synchronize()
    assert render_wave.RAYGEN.launches == before + 1
    monkeypatch.setattr(render_wave, "_frame_start_kernel",
                        render_wave._frame_start_plain)
    want = render()
    assert render_wave.RAYGEN.launches == before + 1
    for a, b in zip(want, got):
        assert bool(chip_smoke.same(a, b).all())
    assert (got[1] > 0).any() and (got[1] <= 0).any()


@pytest.mark.gpu
def test_noise_on_gpu_equals_cpu():
    """The noise is float32 operations in the same order on both devices:
    cnoise, snoise and worley on 10^5 points, two 64^3 chunks of the
    bench world and its near-threshold voxels (tests/data/
    bench_world_near.npz) equal the CPU's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.models import procgen
    from svo_raytracer_torch.ops import noise
    a = torch.from_numpy((np.random.default_rng(4).uniform(
        -1, 1, (3, 100000)) * 3000).astype(np.float32))
    for fn, n in ((noise.cnoise, 2), (noise.snoise, 3), (noise.worley, 2)):
        cpu, gpu = fn(*a[:n]), fn(*a[:n].cuda())
        if fn is not noise.worley:      # worley gives (F1, F2)
            cpu, gpu = (cpu,), (gpu,)
        for c, g in zip(cpu, gpu):
            assert torch.equal(c, g.cpu()), fn.__name__
    for origin in ((448, -192, 512), (960, -128, 64)):
        assert torch.equal(procgen.generate_chunk(origin, 64).cpu(),
                           procgen.generate_chunk(origin, 64, device="cpu"))
    data = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "bench_world_near.npz"))
    xyz = [torch.from_numpy(np.ascontiguousarray(data["xyz"][:, i],
                                                 np.int32)) for i in range(3)]
    gpu = noise.sample_perlin_terrain(*(t.cuda() for t in xyz)).cpu()
    assert torch.equal(gpu, noise.sample_perlin_terrain(*xyz))
    assert torch.equal(gpu, torch.from_numpy(data["voxel"]))


@pytest.mark.gpu
def test_bench_small_on_gpu(monkeypatch):
    """The bench's 64^3 pipeline on the card: every segment through K1,
    n_left 0, the card named in the row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch import bench
    monkeypatch.setattr(bench, "WARM_FRAMES", 1)
    monkeypatch.setattr(bench, "TIMED_FRAMES", 1)
    k1 = (wavefront.K1, wavefront.K1_CAMERA)
    launches = sum(k.launches for k in k1)
    rows = []
    bench.run(64, 64, 64, 40, emit=rows.append)
    assert sum(k.launches for k in k1) - launches >= 2 * (2 + 4)
    assert rows[-1]["n_left"] == dict(prim=0, gi1=0, gi2=0, gi3=0)
    assert rows[-1]["device"] == bench.card("cuda")
    assert rows[-1]["max_memory_allocated"] > 0


def _random_chain(dev, K=3, B=4096, n=1000, seed=4):
    """A float32 K-hit chain whose indices repeat within and across
    stages (scatter collisions), its sky colour and random tables."""
    from svo_raytracer_torch.diff import wave_diff as wd
    rng = np.random.default_rng(seed)
    t = {k: torch.from_numpy(a).to(dev) for k, a in dict(
        aidx=rng.integers(0, n, (K, B)).astype(np.int32),
        hitm=(rng.uniform(size=(K, B)) < 0.8).astype(np.float32),
        ds=rng.uniform(1 / 1024, 1 / 32, (K, B)).astype(np.float32),
        light=rng.uniform(0.3, 1.0, (K, B)).astype(np.float32),
        bg=rng.uniform(0.2, 1.0, (B, 3)).astype(np.float32),
        albedo=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        density=rng.uniform(-2.0, 40.0, n).astype(np.float32),
        g=rng.normal(size=(B, 3)).astype(np.float32)).items()}
    chain = wd.HitChain(t["aidx"], t["hitm"], t["ds"], t["light"])
    return chain, t


@pytest.mark.gpu
def test_composite_backward_on_gpu_equals_cpu():
    """composite_khit on the card: forward values equal the CPU's within
    1e-6, its gradients (index_add_ adds in no fixed order there) within
    atol 1e-5, and the hand-written backward equals autograd of
    composite_khit_ref on the card (rtol 1e-4, atol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.diff import wave_diff as wd

    def run(dev, fn=wd.composite_khit):
        chain, t = _random_chain(dev)
        a = t["albedo"].requires_grad_()
        d = t["density"].requires_grad_()
        col = fn(a, d, chain, t["bg"])
        return (col.detach(),) + torch.autograd.grad(
            (col * t["g"]).sum(), (a, d))

    cpu, gpu = run("cpu"), run("cuda")
    ref = run("cuda", wd.composite_khit_ref)
    assert (cpu[0] - gpu[0].cpu()).abs().max() <= 1e-6
    for c, g in zip(cpu[1:], gpu[1:]):
        assert (c - g.cpu()).abs().max() <= 1e-5
        assert (c != 0).sum() > 500
    for g, r in zip(gpu, ref):
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_two_wall_train_step_on_gpu_equals_cpu():
    """tests/test_wave_diff.py's two-wall step (16x8, K = 2, lr 400) on
    the card gives the CPU's tables within atol 1e-5 and its loss within
    rtol 1e-5, two steps running; K1 launches twice a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.diff import wave_diff as wd
    from svo_raytracer_torch.ops import brick_scene
    scene = brick_scene.brickify(build_np.build_octree_np(
        chip_smoke.two_wall_voxels()))
    W, H = chip_smoke.TWO_WALL_FRAME
    out = []
    for dev in ("cuda", "cpu"):
        ws = wavefront.prepare(scene, dev)
        step = wd.make_wave_train_step(ws, W, H, K=2, lr=400.0)
        cam5 = torch.from_numpy(chip_smoke.two_wall_camera()).to(dev)
        p, losses = wd.init_params(ws, 4.0), []
        launches = wavefront.K1.launches + wavefront.K1_CAMERA.launches
        for _ in range(2):
            p, loss = step(p, cam5, torch.zeros(H, W, 3, device=dev))
            losses.append(float(loss))
        if dev == "cuda":
            assert (wavefront.K1.launches + wavefront.K1_CAMERA.launches
                    - launches == 4)
        out.append((p, losses))
    (pg, lg), (pc, lc) = out
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for g, c in zip(pg, pc):
        assert (g.cpu() - c).abs().max() <= 1e-5


@pytest.mark.gpu
def test_render_diff_step_on_gpu_equals_cpu():
    """One render_diff SGD step on a 64^3 terrain octree: KE on the card
    gives the CPU's image, and the step the CPU's tables within atol
    1e-5 and loss within rtol 1e-5; KE launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.diff import render_diff as rd
    from svo_raytracer_torch.ops import traverse
    from svo_raytracer_torch.utils.camera import Camera
    host = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 7))
    cam = Camera(pos=np.array([1.13, 1.93, 1.17]))
    cam.rotate(-0.6, 3.9)
    out = []
    for dev in ("cuda", "cpu"):
        tree = host.to_device(dev)
        cam5 = torch.tensor(cam.uniform(), dtype=torch.float32, device=dev)
        p = rd.init_params(tree)
        target = 0.8 * rd.render_diff(p, tree, cam5, 64, 40)
        launches = traverse.KE.launches + traverse.KE_BINNED.launches
        q, loss = rd.train_step(p, tree, cam5, target, 64, 40, lr=300.0)
        if dev == "cuda":
            assert (traverse.KE.launches + traverse.KE_BINNED.launches
                    - launches == 1)
        out.append((target, q, float(loss)))
    (tg, qg, lg), (tc, qc, lc) = out
    assert torch.equal(tg.cpu(), tc)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for g, c in zip(qg, qc):
        assert (g.cpu() - c).abs().max() <= 1e-5


@pytest.mark.gpu
def test_apply_patch_on_gpu_equals_cpu():
    """brickify_patch + apply_patch of two edits on a 64^3 terrain: the
    WaveScene written in place on the card equals the CPU's, table for
    table, and neither prepares in full."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy
    from svo_raytracer_torch.core import build_np, sdf
    from svo_raytracer_torch.ops import brick_scene
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 9))
    scene = brick_scene.brickify(tree)
    scenes = {d: copy.deepcopy(scene) for d in ("cuda", "cpu")}
    ws = {d: wavefront.prepare(s, d) for d, s in scenes.items()}
    for center, radius, value in (((32, 36, 32), 9, 1),
                                  ((30, 20, 34), 12, 0)):
        ball = sdf.Sphere(np.asarray(center), radius)
        tree, _ = sdf.use_sdf_brush(tree, ball, value)
        for d in ws:
            p = brick_scene.brickify_patch(tree, scenes[d], ball.min,
                                           ball.max)
            stats = {}
            ws[d] = wavefront.apply_patch(ws[d], scenes[d], p, stats=stats)
            assert not stats["full"]
    for f in wavefront.WaveScene.ARRAYS:
        assert torch.equal(getattr(ws["cuda"], f).cpu(),
                           getattr(ws["cpu"], f)), f


@pytest.mark.gpu
def test_device_tree_on_gpu_equals_fresh_upload():
    """DeviceTree's ranged update on the card (and its growth) equals a
    fresh padded upload, and its packed words a fresh make_packed_table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.core import build_np, sdf
    from svo_raytracer_torch.ops import traverse
    from svo_raytracer_torch.runtime.renderer import DeviceTree
    tree = build_np.build_octree_np(chip_smoke.terrain_voxels(64, 9))
    dt = DeviceTree(tree, "cuda", min_capacity=tree.n_nodes + 1024,
                    slack=1.0)
    grew = []
    for center, radius, value in (((32, 36, 32), 9, 1),
                                  ((30, 20, 34), 12, 0),
                                  ((20, 30, 20), 20, 2)):
        tree, cb = sdf.use_sdf_brush(tree, sdf.Sphere(center, radius), value)
        dt.ranged_update(tree, cb)
        grew.append(dt.last_upload["full"])
        fresh = tree.to_device("cuda", pad_to=dt.capacity)
        for a, b in zip(dt.arrays(), fresh.arrays()):
            assert torch.equal(a, b)
        assert torch.equal(dt.packed, traverse.make_packed_table(fresh))
    # 31,120 nodes + 448, + 6,488 (past the capacity: doubled), + 17,928
    assert grew == [False, True, False]


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["wavefront", "esvo"])
def test_viewer_session_on_gpu_equals_cpu(engine, tmp_path):
    """chip_smoke's viewer script on the 64^3 sphere demo at 64x40: the
    same edits on the card as on the CPU and the same world at the end.
    Mode-2 frames: the CPU's hit mask on every pixel; wavefront depth
    equal, colour within 1e-5; ESVO depth and colour within 1e-5 (an ulp
    apart on the card: 2.4e-7 and 1.2e-7 at most on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from svo_raytracer_torch.apps import viewer
    out = {}
    for dev in ("cuda", "cpu"):
        v = viewer.Viewer(viewer._demo_tree("sphere", 64), 64, 40,
                          str(tmp_path / dev),
                          commands=list(chip_smoke.VIEWER_SCRIPT),
                          engine=engine, device=dev)
        (tmp_path / dev).mkdir()
        frames, render = [], v.render

        def rec(cam5, *a, v=v, render=render, frames=frames):
            res = render(cam5, *a)
            if v.render_mode == 2 and not a:
                frames.append(tuple(x.cpu() for x in res[:2]))
            return res

        v.render = rec
        v.launch(max_frames=len(chip_smoke.VIEWER_SCRIPT))
        out[dev] = (v, frames)
    (vg, fg), (vc, fc) = out["cuda"], out["cpu"]
    assert [e["target"] for e in vg.edits] == [e["target"]
                                               for e in vc.edits]
    assert len(fg) == len(fc) > 4
    for (cg, dg), (cc, dc) in zip(fg, fc):
        dcol = (cg.nan_to_num(-1) - cc.nan_to_num(-1)).abs().max(-1).values
        ddep = (dg - dc).abs()
        same_hit = ((dg > 0) == (dc > 0)).float().mean().item()
        print(f"{engine}: hit mask equal on {same_hit:.4f}; max |d "
              f"colour| {dcol.max().item():.3g}, max |d depth| "
              f"{ddep.max().item():.3g}")
        assert same_hit == 1.0 and dcol.max() <= 1e-5
        assert torch.equal(dg, dc) if engine == "wavefront" else \
            ddep.max() <= 1e-5
    for a, b in zip(vg.tree_host.arrays(), vc.tree_host.arrays()):
        np.testing.assert_array_equal(a, b)
