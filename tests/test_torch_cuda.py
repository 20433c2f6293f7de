"""Kernels K1 (explicit and camera mode, its ray keys and its persistent
schedule), KE (its plain and binned schedules, through a permutation),
K2 and K3 on a CUDA GPU against their plain PyTorch versions.  Needs a
card and nvcc; skipped elsewhere.  The file imports no
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
    assert [x.launches - b for x, b in zip(k, before)] == [2, 1]
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
        before[0] + 1, before[1] + 1)
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
    """A gi-2 frame: one K1 launch per segment (the primary one in camera
    mode) and one key launch per explicit segment."""
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
    k = (wavefront.K1, wavefront.K1_CAMERA, wavefront.K1_KEYS)
    before = [x.launches for x in k]
    stats = []
    render_wave.render_frame_wavefront(ws, cam5, 64, 48, render_mode=0,
                                       gi_bounces=2, stats=stats)
    torch.cuda.synchronize()
    assert [x.launches - b for x, b in zip(k, before)] == [3, 1, 2]
    assert [s["launches"] for s in stats] == [1, 1, 1]
