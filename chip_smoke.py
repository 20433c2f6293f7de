#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svo_raytracer_torch) on one GPU.

First, bench.py's own world through the port's bench module
(svo_raytracer_torch/bench.py): the 1024^3 perlin terrain generated and
built on the card as eight 512^3 chunks (models/procgen, models/world),
brickified on the host and prepared, the probe camera, and bench.py's
gi-1 and gi-3 frames at 1920x1080 (K1 (a), camera-mode primaries (b),
K1's keys), with n_left 0 on every segment; K1 held equal to
trace_plain on sampled rays and on both segments of a gi-1 frame, camera
mode to trace_camera_plain, and one ESVO mode-2 frame on the same octree
through shade.render_image with KE held to traverse.intersect_plain
(lines ``[bench-world ...]``).

On the same world, octree and camera, the differentiable renderers
train at 1920x1080 (lines ``[train ...]``): SGD steps of the wavefront
K-hit chain with K = 2 and K = 3 (diff/wave_diff.py, K launches of K1 a
step) and of the ESVO render_diff (diff/render_diff.py, one KE launch a
step), with falling losses; the hand-written compositor backward held
to autograd, gradients on exactly the hit entries, K1 held to
trace_plain on every stage's rays (stages 2 and 3 start inside solid),
KE on render_diff's frame, a small train step on the card held to the
CPU's, and checkpoints read back bit-equal.

Then the viewer and its edit path on the same world (lines
``[viewer ...]``): apps/worldgen writes bench.py's world to an .svo file
at its defaults, and apps/viewer opens it and runs a scripted session at
1920x1080 through the wavefront engine (K1) and then the ESVO engine
(KE): mode 2, mode 0 accumulating over idle frames, a move, mode 2,
put_sphere and subtract_sphere patched into the device tables in place,
a screenshot, save and re-read.  Each command's frame is timed, each
edit's stages and bytes printed beside a full rebuild's; the patched
tables render the frames of a full re-prepare or a fresh upload on every
pixel, and K1 and KE equal their plain versions on sampled rays and rays
at each edit.  Those sessions' launches join the bench world's K1 and
the 1024^3 KE lines of the kernels table.

Then the rest of the single-card API on the same world (lines
``[entry]``, ``[staged ...]``, ``[progressive]``, ``[bricks]``), each
path driven with the launch counts set to 0 just before it and read
just after: the entry point's analog (svo_raytracer_torch/entry.py) on
the card, its KE segments held to intersect_plain, and its forward at
1920x1080 on the bench world's octree; shade.render_frame_staged in
modes 2, 0 gi-1 and 3 and with the G = 32 skip grid (KE, K2), each frame
equal to render_image's, KE and K2 held on its beam, primary and shadow
segments; render_progressive (threefry, spp 4) with the card's
threefry bits equal to the CPU's; and brick_trace.intersect_bricks, the
plain-PyTorch brick reference engine, held against K1 on sampled
primaries and bounce rays, a witness that walks the world's generator
deciding every ray where the two part.  Their KE and K2 launches form
three kernels lines of their own; their K1 launches join the bench
world's.

Then the multi-device layer on the same world (lines ``[multi ...]``):
four ranks share the card over gloo (svo_raytracer_torch/parallel,
spawned processes handed the world in one file) and run
build_world_sharded over a 4-rank tile mesh, equal to the serial world;
wavefront tile renders (mode 0 gi-1, mode 2, interleaved rows), ESVO
tile renders (modes 1-3) and brick renders on a 2x2 (tiles, bricks) grid
(mode 2, mode 0 gi-1), each held to the single-card frame; and sharded
train steps (ESVO, wavefront K = 2, bricks) with falling losses, the
first held to the single-card step; then K1, its keys and KE are held to
their plain versions on each rank's own rays, and one rank renders the
same frames over nccl.  The ranks' launches join the bench world's K1,
key and KE lines.

Then it drives the main path at full size on three seeded heightmap worlds
(value noise, built directly as BrickScenes), each through its own part of
kernel K1, with the camera placed by bench.py's downward-probe rule and
render mode 0 at 1920x1080; every primary segment runs in K1's camera
mode (each thread derives its ray from its id and the camera):

  * 1024^3, flat L0 (G = 32): gi-1 and gi-3 frames, and a mode-2 frame
    (direct light with a shadow segment);
  * 2048^3, flat L0 with two-word mixed columns (G = 64): gi-1 frames;
  * 4096^3, paged L0 (G = 128, 2^3 pages): gi-1 and gi-3 frames, and the
    same world prepared with half-word (attr16) attributes.

Every world's K1 records are held equal to its plain PyTorch version,
trace_plain, on the card (the 4096^3 world's segments through bounce 1),
as are those of the small test scenes (G = 2, G = 64 and a sparse paged
4096^3 scene) first.  K1 traces explicit rays
in the order of their sort keys (wavefront.ray_order: K1's key kernel,
held equal to ray_keys_plain on every set, then torch.sort); each check
prints the key-and-sort time apart from K1's own, and on bounce segment
1 of every world K1 also runs in frame order, held to the same records.
On every world K1's camera mode is held equal to trace_camera_plain on
the 1080p primary segment, and against explicit rays to the JAX
package's contract.

After the 1024^3 wavefront world, its host BrickScene goes to the card
for kernel K3, the v1 brick-round engine (brick_pallas.
intersect_bricks_tpu), which renders 1920x1080 mode-2 frames as the
intersect_fn of shade.shade_direct, both segments in the image's 8x4
pixel tiles; K3 is held equal to its plain version
(brick_pallas.trace_plain) on the small scenes (also cut at a few rounds)
and on both segments of a frame, in that order and in ray order, and its
primary hit mask against the wavefront mode-2 frame's (the pixels that
differ go to svo_raytracer_torch/_build/k3_mask_rays.npz).

Then the ESVO path runs on the same heightmap and camera: the octree is
built on the card (models/heightmap.generate_chunk_heightmap,
core/build_device), with its packed node table and skip grids at G = 32
and 64, and render_image draws 1920x1080 frames in mode 2 without a skip
grid and with each, and in mode 0 (gi-1) with the G = 32 grid, through
kernels KE (the per-ray ESVO traversal) and K2 (the skip grid's coarse
DDA).  Both are held equal to their plain versions
(traverse.intersect_plain, brick_dda.coarse_dda_plain) on small scenes (KE
also cut at a depth below the trees' and cone-traced), on sampled rays of
the world and on every segment of each skip-grid frame, as the render
traces them: KE in the image's 8x4 pixel tiles (the mode-0 bounce in
KE's binned schedule, and again in ray order), K2 in ray order.
KE's two kernels-line entries split its launches: mode-2 segments, and
cone-traced bounces.  K2's and K3's wrappers are held to launch their
kernel alone.

Each kernels-line entry gives the kernel's device time (CUDA events
behind a spin kernel, device_ms) beside its time per call.

Each check's bound counts the ray inputs and records once, the distinct
table words its plain version gathers, and its steps' operations.

    python3 chip_smoke.py            # needs one CUDA GPU; builds K1, KE,
                                     # K2 and K3 with nvcc, all at once

The 1024^3 and 4096^3 wavefront frames and the ESVO skip-grid frames are
also profiled with torch.profiler (device kernels, device busy, the
kernels' share, idle share per frame); the chrome traces are left in
svo_raytracer_torch/_build/profile/.

Phases print their own lines; any failure raises (exit code != 0).  The
line before the last two is the kernel table as JSON, then the card's
name and power limit from nvidia-smi, then the final result line.
Exits nonzero without a result when no CUDA device is present.  Imports
nothing of jax or of the JAX package.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 1          # heightmap seed: bench.py's camera rule then sees sky
W, H = 1920, 1080
WARM_FRAMES, TIMED_FRAMES = 2, 20
BIG_TIMED_FRAMES = 10     # 2048^3 and 4096^3 worlds
PROFILED_FRAMES = 5
ESVO_WARM_FRAMES, ESVO_TIMED_FRAMES = 3, 10
SKIP_G = 32               # skip-grid cells per edge (render_image's default)
SKIP_GS = (SKIP_G, 2 * SKIP_G)   # the frames' skip grids; K2 marches at 64
# share of pixels whose first hit may move when a skip restarts the ray
# nearer a grazed voxel edge (esvo_skip_checks; 15 of 2,073,600 primaries
# from the 1024^3 probe camera at G = 64 on an H100)
SKIP_RESTART_SHARE = 1e-4

# The least time the card could take (NVIDIA's data-sheet peaks of the
# H100 SXM): bytes over the HBM rate, or operations over the
# float32 rate outside the tensor cores, integer and compare operations
# counted at that rate too.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# loop-body operations per step (arithmetic, compares, address math),
# counted from the kernels' sources: K1's coarse DDA step
# (csrc/wf_ray.cuh dda_cr), KE's ESVO step (csrc/esvo_ray.cuh, PUSH or
# ADVANCE + POP), K2's grid step (csrc/brick_dda.cuh), K3's voxel or L0
# DDA step (csrc/brick_round.cuh dda_vec); and K1's key kernel per ray
# (csrc/wf_ray.cuh ray_key: six finiteness tests, three brick coordinates,
# three Morton spreads, the octant)
OPS_PER_STEP = {"K1": 40, "KE": 50, "K2": 30, "K3": 30, "K1 keys": 75}
K3_ROUNDS = 24            # intersect_bricks_tpu's default max_rounds
K3_CUT_ROUNDS = 2         # few enough rounds that some rays run out

# bench.py's world (svo_raytracer_torch/bench.py, bench_world_phase): its
# nodes, mixed bricks, and the probe camera's surface and height.  The
# JAX package built it with 16,083,240 nodes, n_mixed 4,589 and the
# camera at 1.399 over 1.349 (BENCH_r05.json, printed to 1e-3).  The
# port's grid differs from jitted JAX's on 47 voxels, each within 5e-6
# of a noise threshold (tests/data/bench_world_near.npz, listed on the
# card by scripts/bench_world_margins.py and held against JAX in
# tests/test_torch_worldgen.py); with them flipped the port builds
# 16,083,240 nodes.
BENCH_WORLD = dict(n_nodes=16_083_312, n_mixed=4_589, surface_y=1.349,
                   camera_y=1.399)
BENCH_CAMERA_TOL = 1e-3
# bench.py's probe camera looks down on this world: 96.7% of its 1080p
# primaries hit the terrain (NVIDIA H100 80GB HBM3, 700 W), above the
# heightmap worlds' (0.05, 0.95).  The bench world's frames take this
# range, and the ESVO frame's hit mask must agree with the wavefront's on
# BENCH_HIT_AGREEMENT of the pixels.
BENCH_HIT_RANGE = (0.05, 0.99)
BENCH_HIT_AGREEMENT = 0.999
# [staged]: the staged frame with the skip grid traces its coarse beam
# rays through the skip grid, which restarts each at its skip distance;
# where that moves a beam cell's t by an ulp, colour and depth may move by
# this much against render_image (tests/test_torch_staged.py's bar)
STAGED_SKIP_BEAM_TOL = 1e-6
# rays of the [bricks] oracle phase: half sampled 1080p primaries, half
# sampled rays of a gi-1 bounce segment
BRICK_ORACLE_RAYS = 1 << 17
# [bricks]: K1 reports a hit in a voxel entered across a brick face at its
# brick-exit nudge, 1e-2 voxels past the face (wavefront._EXIT_EPS), the
# oracle at the face, so where both hit one voxel their t differ by up to
# that plus a few float32 ulps at 1024 voxels (1.2e-4 each).  Rays that
# part by more, or name other voxels, go to the witness (brick_witness).
BRICK_DT_VOX = 0.0105

# The train phase (train_phase) on the bench world at 1920x1080: warm
# and timed SGD steps of each kind, the learning rates and the entries
# sampled for the zero-gradient gate.  A per-entry gradient is diluted by
# the mean over 6.2 M values, and a 1/1024 voxel at density 10 has alpha
# ~0.01, so the rates are large: in a sweep of powers of ten
# (scripts/train_lr_sweep.py; NVIDIA H100 80GB HBM3, 700 W) the losses of
# 7 steps fell at every rate up to 1e7 for both kinds and rose at 1e8;
# 1e6 leaves a factor of ten.
TRAIN_WARM, TRAIN_TIMED = 2, 5
TRAIN_LR = {"wave": 1e6, "esvo": 1e6}
TRAIN_GRAD_SAMPLE = 1 << 20

# The [multi] phase (multi_phase) on the bench world: MULTI_RANKS ranks
# sharing the card over gloo, the (tiles, bricks) grid of the brick paths,
# warm and timed frames per path, train steps per kind (the first held to
# the single card's), rays sampled per segment for the kernel checks; the
# bars: wavefront frames within MULTI_FRAME_TOL of the single card's on
# MULTI_FRAME_SHARE of the pixels (tests/test_wave_sharded.py's), ESVO
# frames within ESVO_TOL on every pixel (tests/test_parallel.py's)
MULTI_RANKS = 4
MULTI_GRID = (2, 2)
MULTI_WARM, MULTI_TIMED = 1, 3
MULTI_STEPS = 4
MULTI_SAMPLE = 4096
MULTI_FRAME_TOL, MULTI_FRAME_SHARE = 1e-5, 0.999
ESVO_TOL = 2e-5
# each kind's first sharded step against the single card's: loss within
# rtol 1e-5, parameters within STEP_ATOL (tests/test_parallel.py's bars).
# The brick step's single-card step traces every brick on one card
# (intersect_bricks_local); against the monolith's step it is only
# reported: a brick ray's origin rounds once at + 1.0, which moves the
# hits of grazing rays, and at lr 1e6 each moved hit moves its node's
# parameters (1,254 albedo entries past STEP_ATOL on the bench world at
# 1080p; NVIDIA H100 80GB HBM3, 700 W)
STEP_ATOL = 1e-5

# K1 vs trace_plain on every segment of a frame stops at bounce 1 on the
# paged 4096^3 world (its gi-3 bounces 2 and 3 take 38 s of plain version,
# run twice, on an NVIDIA H100 80GB HBM3 host); the 1024^3 and 2048^3
# worlds check all
PAGED_COMPARE_BOUNCES = 1

# The worlds of the main path, each through its part of kernel K1 (every
# primary segment in camera mode, sub-slice (b)): (size, n_mixed class,
# GI bounces, timed frames, profiled, K1 part, its TPU source line, the
# small scenes that exercised it, first).  The first world also renders a
# wavefront mode-2 frame and runs the K3 and the ESVO paths on the same
# heightmap from the same camera.
WORLDS = (
    (1024, (2000, 6000), (1, 3), TIMED_FRAMES, True,    # bench: 4,589
     "(a) flat L0", 891, ("sphere-64", "terrain-64"), True),
    (2048, (8000, 30000), (1,), BIG_TIMED_FRAMES, False,
     "(c) G=64 two-word mixed columns", 1358, ("g64",), False),
    (4096, (30000, 120000), (1, 3), BIG_TIMED_FRAMES, True,
     "(d) paged L0", 1077, ("paged-4096",), False))


def bound(nbytes, ops):
    """(bound_ms, bound_by) of work that moves ``nbytes`` and does
    ``ops`` operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def say(*a):
    print(*a, flush=True)


def sphere_voxels(size, radius):
    """tests/conftest.py make_sphere_voxels."""
    c = size // 2
    x, y, z = np.meshgrid(*(np.arange(size),) * 3, indexing="ij")
    dist = np.round(np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
                    - radius)
    return np.where(dist <= 0, 1, 0).astype(np.uint8)


def terrain_voxels(size, seed):
    """tests/conftest.py make_terrain_voxels."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.2, 0.8, (4, 4))
    hx = np.clip(np.linspace(0, 3, size).astype(int), 0, 3)
    heights = (coarse[hx[:, None], hx[None, :]] * size).astype(int)
    x, y, z = np.meshgrid(*(np.arange(size),) * 3, indexing="ij")
    solid = y <= heights[x, z]
    mat = np.where(y >= heights[x, z] - 3, 3, 1)
    return np.where(solid, mat, 0).astype(np.uint8)


def two_wall_voxels():
    """tests/test_wave_diff.py's 32^3 scene: two parallel 1-voxel walls
    normal to +z, material 1 at z = 10 and material 2 at z = 20."""
    v = np.zeros((32, 32, 32), np.int32)
    v[8:24, 8:24, 10] = 1
    v[8:24, 8:24, 20] = 2
    return v


# test_wave_diff.py's train step on the two walls: the camera stands past
# the walls and looks back (-z) at a 16x8 frame
TWO_WALL_FRAME = (16, 8)


def two_wall_camera():
    """The two-wall train step's (5, 3) float32 camera uniform."""
    from svo_raytracer_torch.utils.camera import Camera
    return Camera(pos=np.array([1.5, 1.5, 1.95])).uniform().astype(
        np.float32)


def g64_scene():
    """Hand-built 2048^3 BrickScene (G = 64, tests/test_wavefront.py
    test_g64_world): 22 half-filled random mixed bricks on a diagonal band,
    some with z > 31 (the second z-word of an L0 mixed column), and two
    uniform-solid bricks."""
    from svo_raytracer_torch.ops import brick_scene
    G = 64
    rs = np.random.RandomState(3)
    occ3 = np.zeros((G, G, G), bool)
    brick_slot = np.full(G * G * G, -1, np.int32)
    brick_attr = np.zeros(G * G * G, np.int32)
    cells = []
    for i in range(0, G, 3):
        occ3[i, G - 1 - i, i] = True
        cells.append((i * G + (G - 1 - i)) * G + i)
    n_mixed = len(cells)
    occ_words = np.zeros((n_mixed, 8, 128), np.int32)
    attrs = np.zeros((n_mixed, 256, 128), np.int32)
    for s, c in enumerate(cells):
        brick_slot[c] = s
        vox = rs.rand(32, 32, 32) < 0.3
        occ_words[s] = brick_scene.pack_occupancy(vox).reshape(8, 128)
        attrs[s] = ((vox.reshape(256, 128) != 0)
                    * (2 + (559 << 8) + (11 << 24))).astype(np.int32)
    for (ux, uy, uz) in ((4, 4, 40), (50, 50, 50)):
        occ3[ux, uy, uz] = True
        brick_attr[(ux * G + uy) * G + uz] = 1 + (559 << 8) + (6 << 24)
    return brick_scene.BrickScene(
        world_size=2048, grid_size=G, n_mixed=n_mixed,
        l0_table=brick_scene.pack_occupancy(occ3).reshape(-1, 128),
        brick_slot=brick_slot, brick_attr=brick_attr, occ_words=occ_words,
        attrs=attrs)


def sparse_paged_scene():
    """Sparse 4096^3 BrickScene (G = 128, 2^3 pages; tests/test_paged.py
    _sparse_4096_scene): a 24x24 uniform-solid brick patch, 64 half-filled
    mixed bricks above it, one uniform brick in another page and one mixed
    brick in page (1,1,1).  Raw normal 555 decodes to NaN by design."""
    from svo_raytracer_torch.ops import brick_scene
    G = 128

    def cid(x, y, z):
        return (x * G + y) * G + z

    brick_slot = np.full(G * G * G, -1, np.int32)
    brick_attr = np.zeros(G * G * G, np.int64)
    uni_attr = 1 | (555 << 8) | (7 << 24)
    for x in range(52, 76):
        for z in range(52, 76):
            brick_attr[cid(x, 40, z)] = uni_attr
    brick_attr[cid(20, 20, 20)] = uni_attr
    cells = [cid(x, 41, z) for x in range(56, 72, 2) for z in range(56, 72, 2)]
    cells.append(cid(100, 100, 100))
    n_mixed = len(cells)
    brick_slot[np.asarray(cells)] = np.arange(n_mixed, dtype=np.int32)
    vy = (np.arange(32768) // 32) % 32
    attrs = np.zeros((n_mixed, 32768), np.int32)
    attrs[:, :] = np.where(vy < 16, 2 | (595 << 8) | (12 << 24), 0)[None]
    l0 = ((brick_attr & 0xFF) != 0) | (brick_slot >= 0)
    return brick_scene.BrickScene(
        world_size=4096, grid_size=G, n_mixed=n_mixed,
        l0_table=brick_scene.table_rows(
            brick_scene.pack_occupancy(l0.reshape(G, G, G))),
        brick_slot=brick_slot, brick_attr=brick_attr.astype(np.int32),
        occ_words=brick_scene.occupancy_words(attrs),
        attrs=attrs.reshape(n_mixed, 256, 128))


def aimed_rays(scene, n, seed):
    """Rays toward random points of random occupied bricks of a sparse
    scene, even rays from inside the world cube and odd rays from around
    it (world units): most of them hit, after long empty marches."""
    rs = np.random.RandomState(seed)
    G = scene.grid_size
    occ = np.nonzero((scene.brick_slot >= 0)
                     | ((scene.brick_attr & 0xFF) != 0))[0]
    cells = occ[rs.randint(0, len(occ), n)]
    brick = np.stack([cells // (G * G), (cells // G) % G, cells % G], 1)
    target = 1.0 + (brick * 32 + rs.rand(n, 3) * 32) / scene.world_size
    o = 1.02 + 0.96 * rs.rand(n, 3)
    o[1::2] = 0.2 + 2.6 * rs.rand(n // 2, 3)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def random_rays(n, seed, inside_bias=0.5):
    """tests/test_traverse_batch.py random_rays: outside-in rays toward the
    cube mixed with rays from inside it (world units, cube [1,2]^3)."""
    rng = np.random.default_rng(seed)
    origins = np.empty((n, 3), np.float32)
    dirs = np.empty((n, 3), np.float32)
    for i in range(n):
        if rng.uniform() < inside_bias:
            o = rng.uniform(1.05, 1.95, 3)
            d = rng.normal(size=3)
        else:
            o = rng.uniform(0.2, 2.8, 3)
            d = rng.uniform(1.2, 1.8, 3) - o
        origins[i] = o
        dirs[i] = d / np.linalg.norm(d)
    return origins, dirs


def timed(fn, reps=1, warm=True):
    """(result of the last call, mean ms per call) by CUDA events."""
    import torch
    out = fn() if warm else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def frame_ms(render, warm, timed_n):
    """(median, all) host ms of ``timed_n`` frames ``render(i)`` after
    ``warm``, each ended by a synchronize."""
    import torch
    times = []
    for i in range(warm + timed_n):
        t0 = time.perf_counter()
        render(i)
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def same(a, b):
    """Elementwise equality, NaN equal to NaN."""
    if a.is_floating_point():
        return (a == b) | (a.isnan() & b.isnan())
    return a == b


# the name (a substring) of a kernel's device records in a profiler trace
KERNEL_NAMES = {"K2": "dda_kernel", "K3": "round_kernel"}


# Device time.  torch.profiler on the H100 hosts lost device records in a
# long process (every record of 3 launches, 120-200 s into two smoke
# runs, the second with sessions that waited 50 ms after their launches
# and were taken five times) and clipped others (K1 at half its
# duration): its records cannot time a kernel there.  CUDA events do: each
# call is bracketed by two events queued behind a spin kernel that keeps
# the card busy while the host enqueues the call, so the events time the
# card's work and not the host's.
SPIN_CYCLES = 5_000_000       # torch.cuda._sleep: ~3 ms on an H100
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_ms(fn, reps):
    """Device time (ms) of one call of ``fn``, the mean over ``reps``
    calls after a warm one, each bracketed by CUDA events behind a spin
    kernel: the time from the call's first device work to its last, gaps
    included.  A kernel's wrapper that launches the kernel alone (K2,
    K3) gives the kernel's own time; K1's adds a 4-byte memset, KE's a
    byte conversion of its active mask (a few microseconds)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def profiled(fn, reps):
    """The events of ``reps`` calls of ``fn`` under torch.profiler: the
    device's (DEVICE_CATS) and the host's kernel launches (cuda_runtime
    and cuda_driver events named *LaunchKernel*)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return trace_events(prof, "calls")


def trace_events(prof, tag):
    """The device events (DEVICE_CATS) and host kernel launches of a
    torch.profiler run, through its chrome trace
    (svo_raytracer_torch/_build/profile/trace_<tag>.json)."""
    from svo_raytracer_torch.ops import kernel_build
    outdir = kernel_build.BUILD_DIR / "profile"
    outdir.mkdir(parents=True, exist_ok=True)
    path = str(outdir / f"trace_{tag.replace(' ', '_')}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and (
                    e.get("cat") in DEVICE_CATS
                    or (e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and "LaunchKernel" in e.get("name", "")))]


def is_launch(e):
    return e["cat"] in ("cuda_runtime", "cuda_driver")


def only_kernel(what, fn, kname, reps=3):
    """Gate: each of ``reps`` calls of ``fn`` (a kernel's wrapper on a
    main-path input) launches one kernel (the host's launch calls in a
    torch.profiler trace), and every kernel the trace's device records
    name is that kernel (device records may be lost: see the note above
    device_ms)."""
    ev = profiled(fn, reps)
    launches = sum(is_launch(e) for e in ev)
    names = [e["name"] for e in ev if e["cat"] == "kernel"]
    say(f"    {what}: kernel launches of {reps} calls {launches}; device "
        f"records {len(names)}: "
        f"{ {n[:60]: names.count(n) for n in set(names)} }")
    if launches != reps or any(KERNEL_NAMES[kname] not in n for n in names):
        raise AssertionError(f"{what}: {launches} launches, kernels {names}")


def kernel_times(fn, reps):
    """(result of the last call, the kernel's device ms, ms per call):
    ``reps`` calls timed back to back by CUDA events after a warm one,
    then ``reps`` more by device_ms."""
    out, call_ms = timed(fn, reps)
    return out, device_ms(fn, reps), call_ms


class Gathered:
    """Within ``with``, the distinct words of ``tables`` that indexing
    (``Tensor.__getitem__``, the plain versions' gathers) reads, through
    a torch function mode; ``words()`` counts them."""

    def __init__(self, tables):
        import torch
        from torch.overrides import TorchFunctionMode
        seen = {t.data_ptr(): torch.zeros(t.numel(), dtype=torch.bool,
                                          device=t.device)
                for t in tables if t.numel()}

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                t = args[0] if func is torch.Tensor.__getitem__ else None
                if (t is not None and t.dim() == 1
                        and isinstance(args[1], (int, torch.Tensor))):
                    mark = seen.get(t.data_ptr())
                    if mark is not None and t.numel() == mark.numel():
                        mark[args[1]] = True
                return func(*args, **(kwargs or {}))

        self.seen, self.mode = seen, Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)

    def words(self):
        return sum(int(m.sum()) for m in self.seen.values())


def unequal(rec_a, rec_b):
    """({field: rays that differ}, max |a - b| over float fields) of two
    records (dicts), NaN equal to NaN."""
    diff, err = {}, 0.0
    for f, a in rec_a.items():
        b = rec_b[f]
        if a.is_floating_point() and a.numel():
            err = max(err, (a - b).abs().nan_to_num().max().item())
        diff[f] = int((~same(a, b)).sum())
    return diff, err


class Held:
    """A kernel against its plain version on one input set: every field of
    the (dict) records equal on every ray, NaN equal to NaN.  Times the
    kernel (``ms``: its device time, device_ms; ``call_ms``: per call by
    CUDA events) and its plain version once.
    ``bound_ms`` is the least time for the set's own work: ``ray_bytes``
    (ray inputs and records, once) plus the distinct words of ``tables``
    that the plain version gathers (counted on a second, untimed run), and
    the steps times OPS_PER_STEP."""

    def __init__(self, kname, name, kernel, plain, ray_bytes, tables, steps,
                 reps=3):
        rec_k, self.ms, self.call_ms = kernel_times(kernel, reps)
        rec_p, self.plain_ms = timed(plain, warm=False)
        diff, self.err = unequal(rec_k, rec_p)
        self.rec, self.rec_p = rec_k, rec_p
        with Gathered(tables) as g:
            plain()
        self.words = g.words()
        n_steps = steps(rec_k)
        self.nbytes = ray_bytes + 4 * self.words
        self.ops = n_steps * OPS_PER_STEP[kname]
        self.bound_ms, self.bound_by = bound(self.nbytes, self.ops)
        say(f"  {kname} {name}: rays {len(next(iter(rec_k.values())))} "
            f"steps {n_steps} table words read {self.words} unequal fields "
            f"{ {f: n for f, n in diff.items() if n} or 0} kernel "
            f"{self.ms:.4f} ms of device time ({self.call_ms:.4f} ms per "
            f"call) plain {self.plain_ms:.1f} ms bound {self.bound_ms:.4f} "
            f"ms ({self.bound_by})")
        if any(diff.values()):
            raise AssertionError(f"{kname} {name}: kernel record differs "
                                 f"from its plain version on {diff}")


def hold_keys(ws, name, o, d, alive):
    """K1's key kernel vs ray_keys_plain on voxel-unit rays; one step per
    ray."""
    from svo_raytracer_torch.ops import wavefront as wf
    return Held("K1 keys", name,
                lambda: dict(key=wf.ray_keys_kernel(ws, o, d, alive)),
                lambda: dict(key=wf.ray_keys_plain(ws, o, d, alive)),
                o.shape[0] * (12 + 12 + 1 + 4), [],
                lambda r: r["key"].numel())


class Agreement(Held):
    """K1 vs trace_plain on one ray set, the rays in key order
    (wavefront.ray_order, as the main path traces explicit rays): every
    record field (status, t, cell, widx, iters) of every ray, as Held.
    Holds K1's key kernel against ray_keys_plain on the set (``keys``)
    and times the keys and their sort apart from K1 (``key_sort_ms`` by
    CUDA events, ``key_sort_device_ms`` the device time of all they
    launch).  With ``frame_order``, K1 also runs over the rays in frame
    order, held to the same records and timed (``frame_ms``, device
    time).  Keeps the kernel's
    decoded HitResult (``res_k``) for the next segment of a frame and
    prints K1's active rays, hits, coarse steps per active ray and step
    rate."""

    FIELDS = ("status", "t", "cell", "widx", "iters")

    def __init__(self, ws, name, origins, dirs, active=None, reps=3,
                 frame_order=False):
        from svo_raytracer_torch.ops import wavefront as wf
        o, d, alive = wf._rays(ws, origins, dirs, active)
        self.keys = hold_keys(ws, name, o, d, alive)
        order, self.key_sort_ms = timed(lambda: wf.ray_order(ws, o, d,
                                                             alive), reps)
        self.key_sort_device_ms = device_ms(
            lambda: wf.ray_order(ws, o, d, alive), reps)

        def record(trace, *perm):
            return lambda: dict(zip(self.FIELDS, trace(ws, o, d, alive,
                                                       *perm)))

        tables = [getattr(ws, f) for f in ("l0_occ", "l0_mixed", "l0_sc",
                                           "brick_slot", "occ_words",
                                           "sc_words")]
        super().__init__("K1", name, record(wf.trace_kernel, order),
                         record(wf.trace_plain),
                         o.shape[0] * (12 + 12 + 1 + 20), tables,
                         lambda r: int(r["iters"][alive].sum()), reps)
        self.res_k = wf._finish(ws, tuple(self.rec[f] for f in self.FIELDS),
                                origins, dirs)
        steps = self.rec["iters"][alive].double()
        self.active = int(alive.sum())
        self.rate = rate = steps.sum().item() / 1e6   # G steps per ms
        say(f"    active {self.active} hits "
            f"{int(self.res_k.hit.sum())}; coarse steps per ray mean "
            f"{steps.mean().item():.1f} max "
            f"{int(steps.max().item()) if steps.numel() else 0}; K1 in key "
            f"order {self.ms:.4f} ms, {rate / self.ms:.3f} G steps/s; keys "
            f"+ sort {self.key_sort_device_ms:.4f} ms of device time "
            f"({self.key_sort_ms:.4f} ms by events)")
        self.frame_ms = None
        if frame_order:
            rec_f, self.frame_ms, _ = kernel_times(
                record(wf.trace_kernel, None), reps)
            diff, _ = unequal(rec_f, self.rec_p)
            say(f"    K1 in frame order {self.frame_ms:.4f} ms, "
                f"{rate / self.frame_ms:.3f} G steps/s; unequal fields "
                f"{ {f: n for f, n in diff.items() if n} or 0}; key order "
                f"{self.frame_ms / self.ms:.3f}x faster, "
                f"{self.frame_ms / (self.ms + self.key_sort_device_ms):.3f}"
                f"x with its keys and sort")
            if any(diff.values()):
                raise AssertionError(f"K1 {name} in frame order differs from "
                                     f"trace_plain on {diff}")


def hold_ke(name, packed, o, d, alive, order=None, **kw):
    """KE vs traverse.intersect_plain, the kernel over the rays in
    ``order`` (a render's tile order, or None: ray order; cone-traced sets
    take the binned schedule); steps are the ESVO iterations.  Prints the
    step rate."""
    from svo_raytracer_torch.ops import traverse as tr
    o, d, alive = o.contiguous(), d.contiguous(), alive.contiguous()
    held = Held("KE", name,
                lambda: tr.intersect_kernel(packed, o, d, alive, order=order,
                                            **kw),
                lambda: tr.intersect_plain(packed, o, d, alive, **kw),
                o.shape[0] * (12 + 12 + 1 + 4 * (len(tr.F_FIELDS)
                                                 + len(tr.I_FIELDS))),
                [packed], lambda r: int(r["iters"].sum()))
    held.steps = int(held.rec["iters"].sum())
    held.rate = held.steps / held.ms / 1e6       # G steps per s
    live = int((held.rec["iters"] > 0).sum())
    say(f"    {'tile' if order is not None else 'ray'} order"
        f"{', binned' if kw.get('cone_trace') else ''}: steps per traced "
        f"ray {held.steps / max(live, 1):.1f}, {held.rate:.1f} G steps/s")
    return held


def hold_in_both_orders(held, kname, kernel):
    """After ``held`` (the kernel over the rays in a permutation, the new
    schedule): the kernel in ray order (``kernel(None)``), held to the
    same records and timed (``ray_ms`` device, ``ray_call_ms`` by
    events)."""
    rec, held.ray_ms, held.ray_call_ms = kernel_times(lambda: kernel(None),
                                                      3)
    diff, _ = unequal(rec, held.rec_p)
    say(f"    ray order: kernel {held.ray_ms:.4f} ms of device time "
        f"({held.ray_call_ms:.4f} ms per call), unequal fields "
        f"{ {f: n for f, n in diff.items() if n} or 0}; the permutation "
        f"{held.ray_ms / held.ms:.3f}x faster")
    if any(diff.values()):
        raise AssertionError(f"{kname} in ray order differs from its plain "
                             f"version on {diff}")
    return held


def permutation(n, dev, seed=5):
    """A seeded random (n,) int64 permutation on dev."""
    import torch
    return torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(
        dev)


def hold_k2(name, tab, G, o, d, alive):
    """K2 vs brick_dda.coarse_dda_plain on the rays as the caller gives
    them (``alive`` None: every ray; directions may be one row expanded).
    The bytes are what K2 reads and writes: 12 a ray of origins, one
    direction row (12 bytes) or 12 a ray, a byte a ray of ``alive``
    where there is one, and 21 a ray of records.  Steps are the cells
    visited (the crossings plus the cell each live ray starts or stops
    in)."""
    import torch
    from svo_raytracer_torch.ops import brick_dda
    B = o.shape[0]
    live = (torch.ones(B, dtype=torch.bool, device=o.device)
            if alive is None else alive)
    dir_bytes = 12 * (1 if brick_dda._row_stride(d) == 0 else B)
    return Held("K2", name,
                lambda: brick_dda.coarse_dda_kernel(tab, o, d, G, 3 * G,
                                                    alive),
                lambda: brick_dda.coarse_dda_plain(tab, o, d, G, 3 * G,
                                                   live),
                B * (12 + 1 + 4 * 5) + dir_bytes
                + (0 if alive is None else B), [tab],
                lambda r: int(r["steps"].sum()) + int(live.sum()))


def hold_camera(ws, cam5):
    """K1 in camera mode vs trace_camera_plain on the 1080p primary
    segment (block-major, W*ceil(H/32)*32 rays); the rays' only input is
    the 16 camera scalars."""
    from svo_raytracer_torch.ops import render_wave
    from svo_raytracer_torch.ops import wavefront as wf
    B, nbx = render_wave._frame_B(W, H), W // 32
    cam = wf.cam16(cam5)

    def record(trace):
        return lambda: dict(zip(Agreement.FIELDS,
                                trace(ws, cam, B, W, H, nbx)))

    tables = [getattr(ws, f) for f in ("l0_occ", "l0_mixed", "l0_sc",
                                       "brick_slot", "occ_words",
                                       "sc_words")]
    return Held("K1", "camera-mode primary segment",
                record(wf.trace_camera_kernel), record(wf.trace_camera_plain),
                64 + B * 20, tables, lambda r: int(r["iters"].sum()))


def camera_contract(ws, cam_held, explicit, origins, dirs):
    """Camera mode against explicit rays on the primary segment, to the
    JAX package's contract (tests/test_wavefront.py
    test_camera_mode_matches_explicit): hit equal on every ray, value
    equal where both hit, t within 1e-5.  Prints how many rays differ in
    any record field."""
    import torch
    from svo_raytracer_torch.ops import wavefront as wf
    fields = Agreement.FIELDS
    cam = wf._finish(ws, tuple(cam_held.rec[f] for f in fields), origins,
                     dirs)
    exp = explicit.res_k
    diff = torch.zeros_like(cam.hit)
    for f in fields:
        diff |= cam_held.rec[f] != explicit.rec[f]
    differ = int(diff.sum())
    both = cam.hit & exp.hit
    hit_eq = bool((cam.hit == exp.hit).all())
    value_eq = bool((cam.value[both] == exp.value[both]).all())
    dt = float((cam.t[both] - exp.t[both]).abs().max()) if bool(
        both.any()) else 0.0
    say(f"[camera vs explicit {ws.world_size}] primary segment: rays "
        f"differing in any record field {differ} of {cam.hit.numel()}; hit "
        f"equal {hit_eq}, value equal on common hits {value_eq}, max |dt| "
        f"{dt:.3e}")
    if not (hit_eq and value_eq and dt <= 1e-5):
        raise AssertionError("camera mode breaks the explicit-mode contract")
    return dict(rays_differing=differ, max_abs_dt=dt)


def hold_k3(name, scene, o, d, alive, order, max_rounds=K3_ROUNDS):
    """K3 vs brick_pallas.trace_plain, the kernel over the rays in
    ``order`` (a render's tile order, or a permutation), then in ray
    order; steps are the DDA steps over all rounds (both phases)."""
    from svo_raytracer_torch.ops import brick_pallas as bp
    o, d, alive = o.contiguous(), d.contiguous(), alive.contiguous()

    def kernel(perm):
        return bp.trace_kernel(scene, o, d, alive, max_rounds, perm)

    held = Held("K3", name, lambda: kernel(order),
                lambda: bp.trace_plain(scene, o, d, alive, max_rounds),
                o.shape[0] * (12 + 12 + 1 + 1 + 4 * (len(bp.FIELDS) - 1)),
                [getattr(scene, f) for f in scene.ARRAYS],
                lambda r: int(r["iters"].sum()))
    return hold_in_both_orders(held, "K3", kernel)


def k3_small_checks(dev, small):
    """K3 vs its plain version on the small scenes' 4,096 random rays
    (every 50th inactive), then on terrain-64 cut at K3_CUT_ROUNDS rounds,
    each over a random permutation and in ray order.  Gate: the cut
    leaves some rays pending that finish with all rounds."""
    import torch
    out, full = [], {}
    for sname, scene, (o, d) in small:
        dscene = scene.to_device(dev)
        ov = ((torch.from_numpy(o) - 1.0) * float(scene.world_size)).to(dev)
        dv = torch.from_numpy(d).to(dev)
        alive = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
        alive[::50] = False
        perm = permutation(o.shape[0], dev)
        full[sname] = hold_k3(sname, dscene, ov, dv, alive, perm)
        out.append(full[sname])
        if sname == "terrain-64":
            cut = hold_k3(f"{sname} max_rounds {K3_CUT_ROUNDS}", dscene, ov,
                          dv, alive, perm, K3_CUT_ROUNDS)
            out.append(cut)
            ran_out = int((cut.rec["iters"] < full[sname].rec["iters"])
                          .sum())
            say(f"    {sname}: rays out of rounds at {K3_CUT_ROUNDS}: "
                f"{ran_out}")
            if ran_out == 0:
                raise AssertionError("no ray ran out of rounds")
    return out


class capture:
    """Within ``with``, record the arguments of every call of
    ``module.<name>`` (the call itself runs as usual)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def recorded(*a, **kw):
            self.calls.append((a, kw))
            return orig(*a, **kw)

        setattr(self.module, self.name, recorded)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def build_esvo_world(dev, hm, mm, size):
    """The octree world of a heightmap on dev: voxel chunk, device build,
    packed node table and a skip grid for each G of SKIP_GS, each step
    timed.  Returns (DeviceOctree, packed, {G: skip table})."""
    import torch
    from svo_raytracer_torch.core import build_device
    from svo_raytracer_torch.models import heightmap
    from svo_raytracer_torch.ops import brick_scene, skip_grid, traverse
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    secs = {}

    def step(name, fn):
        t0 = time.time()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs[name] = round(time.time() - t0, 3)
        return out

    vox = step("voxels", lambda: heightmap.generate_chunk_heightmap(
        hm, mm, chunk_size=size, height_scale=size // 2, device=dev))
    solid = int((vox != 0).sum())
    tree = step("octree", lambda: build_device.build_octree_device(vox))
    del vox
    packed = step("packed", lambda: traverse.make_packed_table(tree))
    tabs = {G: step(f"skip grid {G}", lambda: torch.from_numpy(
        brick_scene.table_rows(skip_grid.build_skip_grid(tree, G))).to(dev))
        for G in SKIP_GS}
    nbytes = sum(a.numel() * 4 for a in tree.arrays())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    say(f"[esvo {size}] octree world on {dev}: solid voxels {solid}, "
        f"n_nodes {tree.n_nodes}, seconds {secs}; node table {nbytes} B, "
        f"packed {packed.numel() * 4} B, skip grids "
        f"{ {G: t.numel() * 4 for G, t in tabs.items()} } B; "
        f"peak device memory {peak / 2**30:.3f} GiB ({peak} B)")
    return tree, packed, tabs


def esvo_small_checks(dev):
    """KE and K2 vs their plain versions on sphere-64 and terrain-64 (octree
    depth 6): 4,096 random rays each, traced in full, cut at max_depth 3,
    and cone-traced from max_depth 3 (the LOD clamp lifts rays past
    t = 0.05 to depth 11); the scenes' skip grids at G = 8 and 32 on the
    same rays.  Gates that the depth cutoff and the clamp both fired."""
    import torch
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_scene, skip_grid, traverse
    ke, k2 = [], []
    for sname, vox, seed in (("sphere-64", sphere_voxels(64, 24), 11),
                             ("terrain-64", terrain_voxels(64, 7), 12)):
        tree = build_np.build_octree_np(vox).to_device(dev)
        packed = traverse.make_packed_table(tree)
        o, d = (torch.from_numpy(a).to(dev) for a in random_rays(4096, seed))
        alive = torch.ones(4096, dtype=torch.bool, device=dev)
        full, cut, cone = (
            hold_ke(f"{sname}{label}", packed, o, d, alive, **kw)
            for label, kw in (("", {}), (" max_depth 3", dict(max_depth=3)),
                              (" cone max_depth 3",
                               dict(cone_trace=True, max_depth=3))))
        ke += [full, cut, cone]

        def deeper(h, n):   # finished rays that ended deeper than depth n
            r = h.rec
            return int(((r["done"] == 1)
                        & (traverse.MAX_SCALE - r["scale"] > n)).sum())

        say(f"    {sname}: finished deeper than 3: full {deeper(full, 3)}, "
            f"max_depth 3 {deeper(cut, 3)}, cone {deeper(cone, 3)}")
        if deeper(full, 3) == 0 or deeper(cut, 3) or deeper(cone, 3) == 0:
            raise AssertionError(f"{sname}: the depth cutoff or the cone "
                                 f"clamp did not fire")
        for G in (8, 32):
            tab = torch.from_numpy(brick_scene.table_rows(
                skip_grid.build_skip_grid(tree, G))).to(dev)
            k2.append(hold_k2(f"{sname} G={G}", tab, G, (o - 1.0) * float(G),
                              d, alive))
    return ke, k2


def esvo_configs(tabs):
    """render_image arguments of the ESVO frames, by label."""
    def skip(G):
        return dict(skip_tab=tabs[G], skip_grid_size=G)

    return {"mode-2": dict(render_mode=2),
            **{f"mode-2 skip G={G}": dict(render_mode=2, **skip(G))
               for G in SKIP_GS},
            f"mode-0 gi-1 skip G={SKIP_G}": dict(render_mode=0, gi_bounces=1,
                                                 **skip(SKIP_G))}


def esvo_frames(tree, packed, tabs, cam5):
    """The ESVO main path: 1920x1080 frames in mode 2 without the skip grid
    and with it at each G of SKIP_GS, and mode 0 (gi-1) with the G = 32
    grid; one with per-segment stats, then ESVO_WARM_FRAMES and
    ESVO_TIMED_FRAMES timed alone each.  Gates: finite colour on >= 99.9%
    of pixels, primary hit fraction in (0.05, 0.95), a KE launch in every
    segment and a K2 launch in every skip-grid frame."""
    import torch
    from svo_raytracer_torch.ops import brick_dda, shade, traverse
    out = {}
    for label, kw in esvo_configs(tabs).items():
        def render(frame, stats=None):
            return shade.render_image(tree, cam5, W, H, packed=packed,
                                      frame_number=frame, stats=stats, **kw)
        stats = []
        ke0, k20 = traverse.KE.launches, brick_dda.K2.launches
        col, depth, _ = render(1, stats)
        torch.cuda.synchronize()
        ke, k2 = traverse.KE.launches - ke0, brick_dda.K2.launches - k20
        ms, times = frame_ms(lambda i: render(i + 2), ESVO_WARM_FRAMES,
                             ESVO_TIMED_FRAMES)
        rays = sum(s["rays"] for s in stats)
        # mode 2: depth 0 on a primary miss; mode 0: -1
        hit = depth > 0 if kw["render_mode"] == 2 else depth != -1.0
        hitfrac = hit.float().mean().item()
        finite = torch.isfinite(col).all(-1).float().mean().item()
        out[label] = dict(ms=ms, times=times, rays=rays, mrays=rays / ms /
                          1e3, ke=ke, k2=k2, hitfrac=hitfrac, depth=depth,
                          capped=[s["capped"] for s in stats])
        say(f"[esvo frame {label}] {W}x{H}: median {ms:.3f} ms/frame of "
            f"{ESVO_TIMED_FRAMES} (min {min(times):.3f}, max "
            f"{max(times):.3f}); rays traced {rays} "
            f"({rays / ms / 1e3:.2f} Mrays/s); KE launches {ke}, K2 "
            f"launches {k2} per frame; primary hit fraction {hitfrac:.4f}; "
            f"finite colour {finite:.6f}")
        for i, s in enumerate(stats):
            say(f"  segment {i}: rays {s['rays']} hits {s['hits']} "
                f"ITER_CAP-retired {s['capped']} KE launches "
                f"{s['launches']}")
        if not 0.05 < hitfrac < 0.95:
            raise AssertionError(f"hit fraction {hitfrac} out of range")
        if finite < 0.999:
            raise AssertionError(f"finite colour on {finite} of pixels")
        if any(s["launches"] < 1 for s in stats):
            raise AssertionError("a segment did not launch KE")
        if "skip_tab" in kw and k2 < 1:
            raise AssertionError("a skip-grid frame did not launch K2")
    return out


def esvo_segment_checks(tree, packed, tabs, cam5):
    """KE and K2 against their plain versions on every segment of one frame
    of each skip-grid configuration (their inputs recorded as
    render_image makes them; KE in the render's tile order, the bounce in
    the binned schedule, K2 in ray order).  The mode-0 bounce segment's
    KE is also traced in ray order and held to the same records.  Returns
    ({label: (KE checks, K2 checks)}, the bounce's ray-order check).
    Gates that KE took the render's tile permutation and K2 none, that
    K2's wrapper launches K2 alone, and that K2 marches (takes steps) on
    the G = 64 frame."""
    import torch
    from svo_raytracer_torch.ops import brick_dda, shade, traverse
    out, bounce_ray_order = {}, None
    for label, kw in esvo_configs(tabs).items():
        if "skip_tab" not in kw:
            continue
        with capture(traverse, "trace") as ke_calls, \
                capture(brick_dda, "coarse_dda") as k2_calls:
            shade.render_image(tree, cam5, W, H, packed=packed, **kw)
        segs = ("primary", "shadow" if kw["render_mode"] == 2 else "bounce")
        ke = [hold_ke(f"{label} {n} segment", *a, **k)
              for n, (a, k) in zip(segs, ke_calls)]
        if kw["render_mode"] == 0:
            a, k = ke_calls[1]
            bounce_ray_order = hold_ke(f"{label} bounce segment in ray order",
                                       *a, **dict(k, order=None))
            say(f"    bounce: tile order {ke[1].ms:.4f} ms, ray order "
                f"{bounce_ray_order.ms:.4f} ms "
                f"({bounce_ray_order.ms / ke[1].ms:.3f}x)")
        tiles = traverse.tile_order(W, H, cam5.device)
        if not (all(k["order"] is tiles for _, k in ke_calls)
                and all("order" not in k for _, k in k2_calls)):
            raise AssertionError(f"{label}: KE did not take the render's "
                                 f"tile order, or K2 took an order")
        k2 = []
        for n, ((occ, o, d), k) in zip(segs, k2_calls):
            k2.append(hold_k2(f"{label} {n} segment", occ, k["grid_size"], o,
                              d, k["active"]))
            only_kernel(f"K2's wrapper on the {label} {n} segment",
                        lambda: brick_dda.coarse_dda(occ, o, d, **k), "K2")
        out[label] = (ke, k2)
    marched = int(out[f"mode-2 skip G={2 * SKIP_G}"][1][0].rec["steps"].sum())
    if marched == 0:
        raise AssertionError("K2 took no step on the G=64 primary segment")
    return out, bounce_ray_order


def esvo_sampled_rays(tree, packed, cam5):
    """16,384 rays of the octree world: 8,192 sampled primaries and the
    8,192 shadow rays toward the sun of sampled primary hits."""
    import torch
    from svo_raytracer_torch.ops import shade, traverse
    dev = cam5.device
    gen = np.random.default_rng(SEED)
    dirs = shade._normalize(shade.pixel_dirs_device(cam5, W, H))
    pick = torch.from_numpy(gen.choice(dirs.shape[0], 8192,
                                       replace=False)).to(dev)
    o, d = cam5[0].expand(8192, 3), dirs[pick]
    prim = traverse.intersect_octree(tree, o, d, packed=packed)
    hits = torch.nonzero(prim.hit).flatten()
    src = hits[torch.from_numpy(gen.integers(0, hits.numel(), 8192)).to(dev)]
    sun = torch.tensor(shade.SUN_DIR_DIRECT, device=dev).expand(8192, 3)
    o = torch.cat([o, prim.voxel_pos[src]]).contiguous()
    d = torch.cat([d, sun]).contiguous()
    return o, d, torch.ones(o.shape[0], dtype=torch.bool, device=dev)


def esvo_skip_checks(tree, cam5, tabs, frames):
    """The skip grids against the mode-2 frame without one.  Gates, exact:
    the skip is conservative (no primary hit of the skip-off frame lies in
    a ray the grid calls a definite miss or before its skip distance).
    Then skip on vs off (tests/test_skip_grid.py): equal in hit class on
    every pixel with t within 2e-3 where no ray moves (G = 32: every
    primary starts in an occupied cell); where rays restart nearer the
    surface, the restarted ray's float rounding (origin ~1e-4 voxel at
    1024^3) may flip a hit that grazes a voxel edge, so at most a share
    SKIP_RESTART_SHARE of pixels may differ.  A reading: the share of
    primaries each grid keeps and their mean skip in voxels."""
    from svo_raytracer_torch.ops import shade, skip_grid
    dirs = shade._normalize(shade.pixel_dirs_device(cam5, W, H))
    origins = cam5[0].expand_as(dirs)
    t_off = frames["mode-2"]["depth"].reshape(-1)
    hit = t_off > 0
    out = {}
    for G, tab in tabs.items():
        skip, maybe = skip_grid.skip_distances(tab, origins, dirs,
                                               grid_size=G)
        kept = maybe.float().mean().item()
        vox = (skip[maybe].mean().item() * tree.world_size
               if bool(maybe.any()) else 0.0)
        lost = int((hit & ~maybe).sum())
        past = int((hit & (skip > t_off)).sum())
        t_on = frames[f"mode-2 skip G={G}"]["depth"].reshape(-1)
        flips = int(((t_on > 0) != hit).sum())
        far = int((hit & (t_on > 0) & ((t_on - t_off).abs() > 2e-3)).sum())
        moved = bool((skip > 0).any())
        out[G] = dict(kept=kept, mean_skip_voxels=vox, hit_class_differ=flips,
                      t_differ=far)
        say(f"[esvo skip G={G}] primary rays kept {kept:.4f}, mean skip "
            f"{vox:.2f} voxels; skip-off hits called misses {lost}, skipped "
            f"past {past}; skip on vs off: hit class differs on {flips}, "
            f"|dt| > 2e-3 on {far} of {t_off.numel()} pixels")
        if lost or past:
            raise AssertionError(f"the G={G} skip grid is not conservative")
        limit = SKIP_RESTART_SHARE * t_off.numel() if moved else 0
        if flips + far > limit:
            raise AssertionError(f"the G={G} skip grid changed {flips} hit "
                                 f"classes and {far} t (limit {limit})")
    return out


def esvo_phase(dev, size, cam5, ws):
    """The ESVO path on the octree world of the size^3 heightmap, seen from
    the wavefront world's camera ``cam5``; ``ws`` is that wavefront world,
    for the hit-mask reading.  Returns (summary, kernel entries)."""
    import torch
    from svo_raytracer_torch.models import bigworld
    from svo_raytracer_torch.ops import brick_dda, render_wave, shade
    from svo_raytracer_torch.ops import traverse
    t0 = time.time()
    hm, mm = bigworld.fractal_heightmap(size, seed=SEED)
    tree, packed, tabs = build_esvo_world(dev, hm, mm, size)
    say("[esvo compare] KE and K2 vs their plain versions on the card")
    ke_small, k2_small = esvo_small_checks(dev)
    # ---- the main path, with the launch counts set to 0 just before
    traverse.KE.launches = traverse.KE_BINNED.launches = 0
    brick_dda.K2.launches = 0
    t_tiles = time.perf_counter()
    traverse.tile_order(W, H, dev)
    tile_ms = (time.perf_counter() - t_tiles) * 1e3
    frames = esvo_frames(tree, packed, tabs, cam5)
    launches = dict(KE=traverse.KE.launches,
                    KE_binned=traverse.KE_BINNED.launches,
                    K2=brick_dda.K2.launches)
    say(f"[esvo main path {size}] launches {launches}; the tile order of "
        f"{W}x{H} built once in {tile_ms:.1f} ms (host clock)")
    if min(launches.values()) < 1:
        raise AssertionError(f"the ESVO main path missed a kernel: "
                             f"{launches}")
    seg, bounce_ray_order = esvo_segment_checks(tree, packed, tabs, cam5)
    sampled = hold_ke("world-16384", packed,
                      *esvo_sampled_rays(tree, packed, cam5))
    # a reading, not a gate: ESVO's primary hits vs the wavefront frame's
    _, wdepth, _ = render_wave.render_frame_wavefront(ws, cam5, W, H,
                                                      render_mode=3)
    edepth = frames["mode-2"]["depth"]
    agree = ((wdepth > 0) == (edepth > 0)).float().mean().item()
    both = (wdepth > 0) & (edepth > 0)
    med = (wdepth - edepth)[both].abs().median().item()
    say(f"[esvo vs wavefront {size}] primary hit mask agrees on "
        f"{agree:.6f} of pixels; median |depth difference| on common hits "
        f"{med:.3e}")
    skip_reading = esvo_skip_checks(tree, cam5, tabs, frames)
    configs = esvo_configs(tabs)
    prof = {label: profile_window(
        f"esvo {size} {label}",
        lambda i, kw=configs[label]: shade.render_image(
            tree, cam5, W, H, packed=packed, frame_number=i + 2, **kw),
        {"KE": "esvo_trace_kernel", "K2": "dda_kernel"},
        frames[label]["ms"])
        for label in configs if "skip_tab" in configs[label]}
    summary = dict(
        frames={k: {f: v[f] for f in ("ms", "times", "rays", "mrays", "ke",
                                      "k2", "hitfrac", "capped")}
                for k, v in frames.items()},
        wavefront_hit_agreement=agree, median_abs_ddepth=med, profile=prof,
        skip_reading=skip_reading,
        segment_ms={label: dict(KE=[c.ms for c in ke], K2=[c.ms for c in k2])
                    for label, (ke, k2) in seg.items()},
        segment_call_ms={label: dict(KE=[c.call_ms for c in ke],
                                     K2=[c.call_ms for c in k2])
                         for label, (ke, k2) in seg.items()},
        segment_ke_g_steps_per_s={label: [c.rate for c in ke]
                                  for label, (ke, _) in seg.items()},
        bounce_ray_order_ms=bounce_ray_order.ms, tile_order_build_ms=tile_ms,
        segment_plain_ms={label: dict(KE=[c.plain_ms for c in ke],
                                      K2=[c.plain_ms for c in k2])
                          for label, (ke, k2) in seg.items()})
    ke_seg = [c for ke, _ in seg.values() for c in ke]
    k2_seg = [c for _, k2 in seg.values() for c in k2]
    bounce = seg[f"mode-0 gi-1 skip G={SKIP_G}"][0][1]
    cone_small = ke_small[2::3]          # the cone-traced small sets
    plain_checks = ([c for c in ke_small if c not in cone_small]
                    + [c for c in ke_seg if c is not bounce] + [sampled])
    G2 = 2 * SKIP_G
    mode2 = dict(kernel_entry(
        f"KE per-ray ESVO traversal, {size}^3 octree, mode-2 segments",
        "svo_raytracer_torch/csrc/esvo.cu",
        "svo_raytracer_tpu/ops/traverse.py:382",
        launches["KE"] - launches["KE_binned"],
        seg[f"mode-2 skip G={SKIP_G}"][0], plain_checks),
        tpu_kernel="none: an XLA while_loop (traverse.py:415-423), no "
                   "Pallas counterpart")
    binned = dict(kernel_entry(
        f"KE per-ray ESVO traversal, {size}^3 octree, cone-traced bounce "
        f"segments (binned schedule)", "svo_raytracer_torch/csrc/esvo.cu",
        "svo_raytracer_tpu/ops/traverse.py:382", launches["KE_binned"],
        [bounce], cone_small + [bounce, bounce_ray_order]),
        tpu_kernel=mode2["tpu_kernel"])
    kernels = [
        kernel_entry(f"K2 skip-grid coarse DDA, G={G2} mode-2 segments",
                     "svo_raytracer_torch/csrc/brick_dda.cu",
                     "svo_raytracer_tpu/ops/brick_dda.py:85",
                     launches["K2"], seg[f"mode-2 skip G={G2}"][1],
                     k2_small + k2_seg),
        mode2, binned]
    def excess(n, line):
        return n * (line["ms"] - line["bound_ms"])

    say(f"[esvo {size}] KE's excess on one line (all {launches['KE']} "
        f"launches x (mode-2 line ms - its bound)): "
        f"{excess(launches['KE'], mode2):.1f} ms; by line: mode-2 "
        f"{excess(mode2['launches'], mode2):.1f}, bounce "
        f"{excess(binned['launches'], binned):.1f} ms; ordering: the cached "
        f"tile permutation, no keys or sort per segment")
    del tree, packed, tabs
    torch.cuda.empty_cache()
    say(f"[esvo {size}] phase took {time.time() - t0:.1f} s")
    return summary, kernels


def k3_phase(dev, scene, cam5, wave_depth, small_checks):
    """The K3 path on a world's host BrickScene: shade.shade_direct (render
    mode 2) at W x H from the probe camera, its intersect_fn
    brick_pallas.intersect_bricks_tpu over the scene on the card, the rays
    in the image's 8x4 pixel tiles (two K3 launches per frame: primary
    and shadow).  One frame with per-segment
    stats, then ESVO_WARM_FRAMES and ESVO_TIMED_FRAMES timed alone each,
    with K3's launch count set to 0 just before and read just after; then
    K3 vs its plain version on both segments of a frame, and a profile of
    the frame.  Gates: finite colour on >= 99.9% of pixels and the primary
    hit mask equal to that of the wavefront mode-2 frame (``wave_depth``)
    on >= 99.9% of pixels; the primaries where the two differ are written
    to svo_raytracer_torch/_build/k3_mask_rays.npz (scripts/
    k3_mask_rays.py reads them); both segments took the tile order and
    K3's wrapper launches K3 alone.  Returns (summary, kernel entry)."""
    import functools
    import torch
    from svo_raytracer_torch.ops import brick_pallas as bp
    from svo_raytracer_torch.ops import kernel_build, shade, traverse
    size = scene.world_size
    t0 = time.time()
    dscene = scene.to_device(dev)
    torch.cuda.synchronize()
    nbytes = sum(getattr(dscene, f).numel() * 4 for f in dscene.ARRAYS)
    say(f"[k3 {size}] BrickScene -> {dev} in {time.time() - t0:.1f} s: "
        f"n_mixed {dscene.n_mixed}, table bytes {nbytes}")
    dirs = shade._normalize(shade.pixel_dirs_device(cam5, W, H))
    origins = cam5[0].expand_as(dirs)
    # both segments trace the W*H pixel rays in the image's 8x4 tiles
    tiles = traverse.tile_order(W, H, dev)
    isect = functools.partial(bp.intersect_bricks_tpu, dscene, order=tiles)
    stats = []

    def isect_stats(o, d, active=None, **kw):
        res = isect(o, d, active=active, **kw)
        stats.append(dict(rays=o.shape[0] if active is None
                          else int(active.sum()), hits=int(res.hit.sum()),
                          iters=int(res.iters.sum())))
        return res

    # ---- the main path, with the launch count set to 0 just before
    bp.K3.launches = 0
    col, depth, _ = shade.shade_direct(None, origins, dirs,
                                       intersect_fn=isect_stats)
    times = []
    for i in range(ESVO_WARM_FRAMES + ESVO_TIMED_FRAMES):
        t1 = time.perf_counter()
        shade.shade_direct(None, origins, dirs, intersect_fn=isect)
        torch.cuda.synchronize()
        if i >= ESVO_WARM_FRAMES:
            times.append((time.perf_counter() - t1) * 1e3)
    launches = bp.K3.launches
    ms = float(np.median(times))
    rays = sum(s["rays"] for s in stats)
    finite = torch.isfinite(col).all(-1).float().mean().item()
    hit = (depth > 0).reshape(H, W)
    agree = (hit == (wave_depth > 0)).float().mean().item()
    both = hit & (wave_depth > 0)
    med = (depth.reshape(H, W) - wave_depth)[both].abs().median().item()
    say(f"[k3 frame {size} mode-2] {W}x{H}: median {ms:.3f} ms/frame of "
        f"{ESVO_TIMED_FRAMES} (min {min(times):.3f}, max {max(times):.3f}); "
        f"rays traced {rays} ({rays / ms / 1e3:.2f} Mrays/s); K3 launches "
        f"{launches} on the main path; primary hit fraction "
        f"{hit.float().mean().item():.4f}; finite colour {finite:.6f}")
    for i, s in enumerate(stats):
        say(f"  segment {i}: rays {s['rays']} hits {s['hits']} DDA steps "
            f"{s['iters']}")
    # the primaries where the masks differ, traced again with 4x the
    # rounds: those that change ran out of rounds in the frame
    off = torch.nonzero((hit != (wave_depth > 0)).reshape(-1)).flatten()
    more = bp.intersect_bricks_tpu(dscene, origins[off], dirs[off],
                                   max_rounds=4 * K3_ROUNDS)
    changed = int((more.hit != hit.reshape(-1)[off]).sum())
    # the rays for a reading on the CPU against the JAX package's engines
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(kernel_build.BUILD_DIR / "k3_mask_rays.npz",
             pixel=off.cpu().numpy(), origins=origins[off].cpu().numpy(),
             dirs=dirs[off].cpu().numpy(),
             k3_hit=hit.reshape(-1)[off].cpu().numpy(),
             k3_depth=depth.reshape(-1)[off].cpu().numpy(),
             wave_depth=wave_depth.reshape(-1)[off].cpu().numpy(),
             k3_hit_more_rounds=more.hit.cpu().numpy(),
             cam5=cam5.cpu().numpy(), width=W, height=H, world_size=size,
             seed=SEED)
    say(f"[k3 vs wavefront {size}] mode-2 primary hit mask agrees on "
        f"{agree:.6f} of pixels ({off.numel()} differ; of these, "
        f"{changed} change with {4 * K3_ROUNDS} rounds instead of "
        f"{K3_ROUNDS}); median |depth difference| on common hits "
        f"{med:.3e}")
    if launches < 1:
        raise AssertionError("the K3 main path never launched K3")
    if finite < 0.999:
        raise AssertionError(f"finite colour on {finite} of pixels")
    if agree < 0.999:
        raise AssertionError(f"K3 and wavefront hit masks agree on {agree}")
    # ---- K3 vs plain on both segments of a frame
    with capture(bp, "trace") as calls:
        shade.shade_direct(None, origins, dirs, intersect_fn=isect)
    segs = []
    for n, ((sc, o, d, alive, rounds, order), _) in zip(
            ("primary", "shadow"), calls):
        if order is not tiles:
            raise AssertionError(f"the {n} segment did not take the tile "
                                 f"order")
        segs.append(hold_k3(f"mode-2 {n} segment", sc, o, d, alive, order,
                            rounds))
        only_kernel(f"K3's wrapper on the {n} segment",
                    lambda: bp.trace(sc, o, d, alive, rounds, order), "K3")
    prof = profile_window(
        f"k3 {size} mode-2",
        lambda i: shade.shade_direct(None, origins, dirs, intersect_fn=isect),
        {"K3": "round_kernel"}, ms)
    summary = dict(frame_ms_median=ms, frame_ms=times, rays=rays,
                   mrays=rays / ms / 1e3, launches=launches, profile=prof,
                   wavefront_hit_agreement=agree, median_abs_ddepth=med,
                   differing_pixels=off.numel(),
                   differing_changed_by_more_rounds=changed,
                   segment_ms=[c.ms for c in segs],
                   segment_call_ms=[c.call_ms for c in segs],
                   segment_ray_order_ms=[c.ray_ms for c in segs],
                   segment_plain_ms=[c.plain_ms for c in segs])
    entry = kernel_entry(f"K3 v1 brick-round traversal, {size}^3 mode-2 "
                         f"segments", "svo_raytracer_torch/csrc/brick_round.cu",
                         "svo_raytracer_tpu/ops/brick_pallas.py:149",
                         launches, segs, small_checks + segs)
    del dscene
    torch.cuda.empty_cache()
    return summary, entry


def build_world(dev, size, n_mixed_range, **prepare_kw):
    """A seeded size^3 heightmap world, built on the host and prepared on
    dev; returns (host BrickScene, WaveScene)."""
    from svo_raytracer_torch.models import bigworld
    t0 = time.time()
    hm, mm = bigworld.fractal_heightmap(size, seed=SEED)
    scene = bigworld.heightmap_brick_scene(hm, mm, size)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    say(f"[world {size}] {size}^3 heightmap scene: G {scene.grid_size}, "
        f"n_mixed {scene.n_mixed}, host build {time.time() - t0:.1f} s, "
        f"host peak RSS so far {rss:.1f} GiB")
    if not n_mixed_range[0] <= scene.n_mixed <= n_mixed_range[1]:
        raise AssertionError(f"n_mixed {scene.n_mixed} off {n_mixed_range}")
    return scene, prepare_world(dev, scene, **prepare_kw)


def prepare_world(dev, scene, **prepare_kw):
    """prepare() on dev, timed; prints the layout and the table bytes."""
    import torch
    from svo_raytracer_torch.ops import wavefront as wf
    t0 = time.time()
    ws = wf.prepare(scene, dev, **prepare_kw)
    torch.cuda.synchronize()
    nbytes = ws.nbytes
    layout = (f"{'paged' if ws.pages else 'flat'} L0, attr_comb "
              f"{'2-D' if ws.attr_comb.dim() == 2 else 'flat'} "
              f"{tuple(ws.attr_comb.shape)} {ws.attr_comb.dtype}")
    say(f"[world {scene.world_size}] prepare{prepare_kw or ''} -> {dev} in "
        f"{time.time() - t0:.1f} s: capacity {ws.capacity}, {layout}, "
        f"table bytes {nbytes}")
    return ws


def frame_configs(bounces_list, timed_frames, mode2=False):
    """The wavefront frames of a world's main path: label -> (render
    arguments, warm frames, timed frames).  Mode 0 at each GI bounce
    count, and with ``mode2`` a mode-2 frame (ESVO_WARM_FRAMES,
    ESVO_TIMED_FRAMES, as the ESVO frames)."""
    out = {f"gi{b}": (dict(render_mode=0, gi_bounces=b), WARM_FRAMES,
                      timed_frames) for b in bounces_list}
    if mode2:
        out["mode2"] = (dict(render_mode=2), ESVO_WARM_FRAMES,
                        ESVO_TIMED_FRAMES)
    return out


def render_frames(ws, cam5, configs):
    """Frames at W x H for each of ``configs`` (frame_configs): one with
    per-segment stats, then the warm frames and the timed frames timed
    alone each (host clock, synchronized).  Checks the primary hit
    fraction, finite colour, a K1 launch in every segment and camera mode
    on every primary segment.  Mrays/s: mode 0 counts (bounces + 1) * W * H
    rays per frame (bench.py's convention), mode 2 the rays traced."""
    import torch
    from svo_raytracer_torch.ops import render_wave
    size = ws.world_size
    frames = {}
    for label, (kw, warm, n_timed) in configs.items():
        stats, times = [], []
        col, depth, _ = render_wave.render_frame_wavefront(
            ws, cam5, W, H, frame_number=1, stats=stats, **kw)
        torch.cuda.synchronize()
        for i in range(warm + n_timed):
            t0 = time.perf_counter()
            render_wave.render_frame_wavefront(ws, cam5, W, H,
                                               frame_number=i + 2, **kw)
            torch.cuda.synchronize()
            if i >= warm:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        rays = (kw["gi_bounces"] + 1) * W * H if kw["render_mode"] == 0 \
            else sum(s["rays"] for s in stats)
        mrays = rays / (ms * 1e-3) / 1e6
        finite = torch.isfinite(col).all(-1).float().mean().item()
        hitfrac = stats[0]["hits"] / stats[0]["rays"]
        frames[label] = dict(ms=ms, mrays=mrays, times=times, depth=depth)
        say(f"[frame {size} {label}] {W}x{H}: median {ms:.3f} ms/frame "
            f"of {n_timed} (min {min(times):.3f}, max {max(times):.3f}; "
            f"{mrays:.2f} Mrays/s), primary hit fraction {hitfrac:.4f}, "
            f"finite colour {finite:.6f}")
        for i, s in enumerate(stats):
            say(f"  segment {i}: rays {s['rays']} hits {s['hits']} "
                f"ITER_CAP-retired {s['capped']} K1 launches "
                f"{s['launches']}{' (camera mode)' if s['camera'] else ''}")
        if not 0.05 < hitfrac < 0.95:
            raise AssertionError(f"hit fraction {hitfrac} out of range")
        if finite < 0.999:
            raise AssertionError(f"finite colour on {finite} of pixels")
        if any(s["launches"] < 1 for s in stats):
            raise AssertionError("a segment did not launch K1")
        if not stats[0]["camera"]:
            raise AssertionError("the primary segment was not camera mode")
    return frames


def main_path(ws, configs):
    """The main path on one world: camera probe and frames, with K1's
    launch counts (and its key kernel's) set to 0 just before and read
    just after.  K1.launches counts both entry points of the library, so
    the explicit-ray entry's launches are K1's less K1_CAMERA's."""
    import torch
    from svo_raytracer_torch import bench
    from svo_raytracer_torch.ops import wavefront as wf
    torch.cuda.reset_peak_memory_stats()
    wf.K1.launches = wf.K1_CAMERA.launches = wf.K1_KEYS.launches = 0
    cam5, surf_y = bench.place_camera(ws)
    say(f"[camera] at y={float(cam5[0, 1]):.4f} (surface {surf_y:.4f})")
    frames = render_frames(ws, cam5, configs)
    launches = dict(K1_explicit=wf.K1.launches - wf.K1_CAMERA.launches,
                    K1_camera=wf.K1_CAMERA.launches,
                    K1_keys=wf.K1_KEYS.launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"[main path {ws.world_size}] launches {launches}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB ({peak} B)")
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path missed a kernel: {launches}")
    return cam5, frames, launches, peak


def bench_world_phase(dev):
    """bench.py's world through the port (svo_raytracer_torch/bench.py's
    functions, so the two cannot drift): the 1024^3 perlin terrain built
    on the card as eight 512^3 chunks, brickified on the host, prepared,
    the probe camera, and bench.py's gi-1 and gi-3 frames at 1920x1080 as
    the main path (K1 (a) at G = 32, camera-mode primaries, K1's keys),
    with the launch counts set to 0 just before and read just after.
    Gates: the world's node and mixed-brick counts and the camera
    (BENCH_WORLD), n_left 0 on every segment, the primary hit fraction
    (BENCH_HIT_RANGE), finite colour, the ESVO frame's hit mask against
    the wavefront's (BENCH_HIT_AGREEMENT).  Then K1 == trace_plain on
    16,384 sampled rays and on both segments of a gi-1 frame, camera mode
    == trace_camera_plain and the explicit-ray contract, and one ESVO
    mode-2 frame on the same DeviceOctree through shade.render_image with
    KE == intersect_plain on sampled rays.  Returns (summary, kernels
    entries, K1 key launches, the checks whose keys count, the ordering
    device ms, and (WaveScene, DeviceOctree, packed table, camera) for the
    train phase)."""
    import torch
    from svo_raytracer_torch import bench
    from svo_raytracer_torch.models import procgen
    from svo_raytracer_torch.ops import render_wave, shade, traverse
    from svo_raytracer_torch.ops import wavefront as wf
    t0 = time.time()
    size, chunk, width, height = bench.FULL
    if (width, height) != (W, H):
        raise AssertionError("the bench frame is not the smoke frame")
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, with the launch counts set to 0 just before
    wf.K1.launches = wf.K1_CAMERA.launches = wf.K1_KEYS.launches = 0
    tree, ws, cam5, info = bench.setup(size, chunk, dev)
    setup_peak = torch.cuda.max_memory_allocated()
    table_bytes = ws.nbytes
    cam_y = float(cam5[0, 1])
    # the noise alone: one chunk's peak above what is already allocated
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    chunk_vox = procgen.generate_chunk((0, -size // 2, 0), chunk,
                                       device=dev)
    torch.cuda.synchronize()
    noise_peak = torch.cuda.max_memory_allocated() - base
    del chunk_vox
    say(f"[bench-world] {size}^3 perlin terrain in {chunk}^3 chunks on the "
        f"card: noise {info['noise']:.3f} s, chunk builds "
        f"{info['build']:.3f} s, splices {info['splice']:.3f} s, in all "
        f"{info['build_s']:.3f} s; n_nodes {tree.n_nodes}; node table to "
        f"the host {info['to_host']:.3f} s, brickify {info['brickify']:.3f} "
        f"s, prepare {info['prepare']:.3f} s: G {ws.grid_size}, n_mixed "
        f"{ws.n_mixed}, table bytes {table_bytes}; peak device memory "
        f"{setup_peak / 2**30:.3f} GiB ({setup_peak} B), of one {chunk}^3 "
        f"chunk's noise (y-slabs of {procgen.SLAB}) "
        f"{noise_peak / 2**30:.3f} GiB")
    say(f"[bench-world] camera at y={cam_y:.5f} (surface "
        f"{info['surface_y']:.5f}); expected {BENCH_WORLD}")
    got = dict(n_nodes=tree.n_nodes, n_mixed=ws.n_mixed,
               surface_y=info["surface_y"], camera_y=cam_y)
    off = {k: (got[k], v) for k, v in BENCH_WORLD.items()
           if abs(got[k] - v) > (BENCH_CAMERA_TOL if isinstance(v, float)
                                 else 0)}
    if off:
        raise AssertionError(f"the bench world differs from its expected "
                             f"build: {off}")
    frames = {}
    for row, stats in bench.rows(ws, cam5, W, H, "Mrays/s (bench world)",
                                 dict(build_s=info["build_s"])):
        b = len(stats) - 1
        hitfrac = stats[0]["hits"] / stats[0]["rays"]
        frames[f"gi{b}"] = dict(stats=stats, hitfrac=hitfrac,
                                ms=row[f"frame_ms{'' if b == 1 else '_gi3'}"])
        say(f"[bench-world row] {json.dumps(row)}")
        say(f"[bench-world gi-{b}] primary hit fraction {hitfrac:.4f}; "
            f"n_left {bench.n_left(stats)}")
        for i, s in enumerate(stats):
            say(f"  segment {i}: rays {s['rays']} hits {s['hits']} "
                f"ITER_CAP-retired {s['capped']} K1 launches "
                f"{s['launches']}{' (camera mode)' if s['camera'] else ''}")
        if any(bench.n_left(stats).values()):
            raise AssertionError(f"rays left at ITER_CAP: {row['n_left']}")
        if not BENCH_HIT_RANGE[0] < hitfrac < BENCH_HIT_RANGE[1]:
            raise AssertionError(f"hit fraction {hitfrac} out of range")
        if not stats[0]["camera"] or any(s["launches"] < 1 for s in stats):
            raise AssertionError("a segment did not launch K1, or the "
                                 "primaries were not in camera mode")
    launches = dict(K1_explicit=wf.K1.launches - wf.K1_CAMERA.launches,
                    K1_camera=wf.K1_CAMERA.launches,
                    K1_keys=wf.K1_KEYS.launches)
    say(f"[bench-world main path] launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path missed a kernel: {launches}")
    _, col, _ = render_wave.render_frame_wavefront(ws, cam5, W, H,
                                                   render_mode=0,
                                                   gi_bounces=1)
    finite = torch.isfinite(col).all(-1).float().mean().item()
    if finite < 0.999:
        raise AssertionError(f"finite colour on {finite} of pixels")
    # ---- K1 against its plain versions on this world
    say(f"[bench-world compare] K1 vs trace_plain on 16384 sampled rays")
    sampled = Agreement(ws, "bench world-16384", *sampled_rays(ws, cam5))
    seg = compare_segments(ws, cam5, 1)
    say("[bench-world camera] K1 camera mode vs trace_camera_plain")
    cam = hold_camera(ws, cam5)
    origins, dirs, _, _ = render_wave._frame_rays(cam5, W, H)
    contract = camera_contract(ws, cam, seg[0], origins, dirs)
    del origins, dirs
    # ---- one ESVO mode-2 frame on the same octree
    packed = traverse.make_packed_table(tree)
    stats = []
    ke0 = traverse.KE.launches
    ecol, edepth, _ = shade.render_image(tree, cam5, W, H, render_mode=2,
                                         packed=packed, stats=stats)
    ehit = (edepth > 0).float().mean().item()
    _, wdepth, _ = render_wave.render_frame_wavefront(ws, cam5, W, H,
                                                      render_mode=3)
    agree = ((wdepth > 0) == (edepth > 0)).float().mean().item()
    say(f"[bench-world esvo] mode-2 frame on the {tree.n_nodes}-node "
        f"octree: KE launches {traverse.KE.launches - ke0}, primary hit "
        f"fraction {ehit:.4f}, finite colour "
        f"{torch.isfinite(ecol).all(-1).float().mean().item():.6f}; hit "
        f"mask vs the wavefront frame agrees on {agree:.6f} of pixels")
    if (traverse.KE.launches - ke0 < 1 or agree < BENCH_HIT_AGREEMENT
            or not BENCH_HIT_RANGE[0] < ehit < BENCH_HIT_RANGE[1]):
        raise AssertionError("the ESVO frame launched no KE, its hit "
                             "fraction is out of range or its hit mask "
                             "disagrees with the wavefront frame's")
    ke = hold_ke("bench world-16384", packed,
                 *esvo_sampled_rays(tree, packed, cam5))
    prof = {label: profile_window(
        f"bench-world {label}",
        lambda i, b=int(label[2:]): render_wave.render_frame_wavefront(
            ws, cam5, W, H, render_mode=0, frame_number=i + 2,
            gi_bounces=b),
        {"K1": "wf_trace_kernel", "K1 keys": "ray_key", "sort": "RadixSort"},
        f["ms"]) for label, f in frames.items()}
    checks = seg + [sampled]
    kernels = [
        kernel_entry(f"K1 wavefront traversal (a) flat L0, bench world "
                     f"{size}^3 perlin terrain",
                     "svo_raytracer_torch/csrc/wavefront.cu",
                     "svo_raytracer_tpu/ops/wavefront.py:891",
                     launches["K1_explicit"], checks, checks),
        kernel_entry(f"K1 wavefront traversal (b) camera-mode primaries on "
                     f"(a) flat L0, bench world {size}^3 perlin terrain",
                     "svo_raytracer_torch/csrc/wavefront.cu",
                     "svo_raytracer_tpu/ops/wavefront.py:987",
                     launches["K1_camera"], [cam], [cam])]
    order_ms = launches["K1_keys"] * seg[1].key_sort_device_ms
    summary = dict(
        world=dict(got, noise_s=info["noise"], build_s=info["build"],
                   splice_s=info["splice"], total_build_s=info["build_s"],
                   to_host_s=info["to_host"], brickify_s=info["brickify"],
                   prepare_s=info["prepare"], table_bytes=table_bytes,
                   setup_peak_bytes=setup_peak,
                   chunk_noise_peak_bytes=noise_peak),
        frames={k: dict(hitfrac=v["hitfrac"],
                        n_left=bench.n_left(v["stats"]))
                for k, v in frames.items()},
        row=row, launches=launches, camera_vs_explicit=contract,
        segment_ms=[a.ms for a in seg], camera_ms=cam.ms,
        esvo=dict(hitfrac=ehit, wavefront_hit_agreement=agree,
                  ke_sampled_ms=ke.ms), profile=prof,
        segment_key_sort_device_ms=[a.key_sort_device_ms for a in seg],
        segment_g_steps_per_s=[a.rate / a.ms for a in seg],
        segment_active=[a.active for a in seg],
        max_memory_allocated=torch.cuda.max_memory_allocated())
    say(f"[bench-world] phase took {time.time() - t0:.1f} s")
    return (summary, kernels, launches["K1_keys"],
            [a.keys for a in seg + [sampled]], order_ms,
            (ws, tree, packed, cam5))


def train_steps(label, step, params, launches):
    """TRAIN_WARM + TRAIN_TIMED SGD steps ``params, loss = step(params)``,
    each timed alone on the host clock and ended by
    torch.cuda.synchronize(), the peak device memory reset just before.
    ``launches()`` reads the kernel's launch count.  Gates: every loss
    finite, none above the one before, the last below the first.
    Returns (the trained params, the run's numbers)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = launches()
    losses, times = [], []
    for _ in range(TRAIN_WARM + TRAIN_TIMED):
        t0 = time.perf_counter()
        params, loss = step(params)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    out = dict(ms=float(np.median(times[TRAIN_WARM:])), times=times,
               losses=losses, peak_bytes=torch.cuda.max_memory_allocated(),
               launches_per_step=(launches() - n0) / len(times))
    say(f"[train {label}] median step {out['ms']:.3f} ms (timed "
        f"{', '.join(f'{t:.3f}' for t in times[TRAIN_WARM:])}); peak "
        f"device memory {out['peak_bytes'] / 2**30:.3f} GiB "
        f"({out['peak_bytes']} B); launches per step "
        f"{out['launches_per_step']:g}; losses "
        f"{', '.join(repr(v) for v in losses)}")
    if (not all(np.isfinite(losses))
            or any(b > a for a, b in zip(losses, losses[1:]))
            or not losses[-1] < losses[0]):
        raise AssertionError(f"train {label}: the loss did not fall: "
                             f"{losses}")
    return params, out


def grad_support(what, grads, hit_ids, n, dev):
    """Gate: the gradients of both tables are non-zero on every hit entry
    (``hit_ids``) and exactly zero on the entries no ray hit among
    TRAIN_GRAD_SAMPLE sampled ones (of ``n``)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sample = torch.randint(0, n, (TRAIN_GRAD_SAMPLE,), device=dev,
                           generator=gen)
    unhit = sample[~torch.isin(sample, hit_ids)]
    nz_den = int((grads.density[hit_ids] != 0).sum())
    nz_alb = int((grads.albedo[hit_ids] != 0).any(1).sum())
    stray = int((grads.density[unhit] != 0).sum()
                + (grads.albedo[unhit] != 0).any(1).sum())
    say(f"  [train grads {what}] hit entries {hit_ids.numel()}: non-zero "
        f"density {nz_den}, albedo {nz_alb}; unhit sampled entries "
        f"{unhit.numel()}: non-zero {stray}")
    if nz_den != hit_ids.numel() or nz_alb != hit_ids.numel() or stray:
        raise AssertionError(f"{what}: gradients off the hit entries or "
                             f"zero on some")
    return dict(hit=hit_ids.numel(), unhit_sampled=unhit.numel())


def train_phase(dev, ws, tree, packed, cam5):
    """The differentiable renderers at 1920x1080 on the bench world (its
    WaveScene, DeviceOctree and probe camera, from bench_world_phase).

    The main path, with the launch counts set to 0 just before and read
    just after: wavefront K-hit SGD steps (diff/wave_diff.py) with K = 2
    and K = 3 (K launches of K1 a step, each ordered by its keys), then
    the ESVO render_diff step (diff/render_diff.py, one KE launch a
    step); each TRAIN_WARM + TRAIN_TIMED steps toward 0.8 x its untrained
    image, at TRAIN_LR.  Gates: the losses (train_steps); the launches
    per step; composite_khit's backward equal to autograd of
    composite_khit_ref on the K = 3 chain (rtol 1e-4, atol 1e-6; forward
    within 1e-6); gradients non-zero on every hit entry and zero on
    sampled unhit ones (both renderers); K1 == trace_plain on every ray
    of the chain's three stages (stages 2 and 3 start just past the hit
    cube, mostly inside solid), KE == intersect_plain on render_diff's
    frame in its tile order; a two-wall train step (test_wave_diff.py's,
    16x8, K = 2) on the card equal to the CPU's (atol 1e-5, loss rtol
    1e-5); a checkpoint
    written on the card and read back bit-equal.  Then a profile of 5
    steps of each kind, and the compositor's device time.  Returns
    (summary, kernels entries, K1 key launches, the key checks)."""
    import torch
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.diff import checkpoint
    from svo_raytracer_torch.diff import render_diff as rd
    from svo_raytracer_torch.diff import wave_diff as wd
    from svo_raytracer_torch.ops import brick_scene, kernel_build, shade
    from svo_raytracer_torch.ops import traverse
    from svo_raytracer_torch.ops import wavefront as wf
    t0 = time.time()
    dirs = rd.d_unit(shade.pixel_dirs_device(cam5, W, H))
    origins = cam5[0].expand_as(dirs)
    say(f"[train] {W}x{H} on the bench world: {TRAIN_WARM} warm + "
        f"{TRAIN_TIMED} timed steps of each kind, lr {TRAIN_LR} (large: "
        f"a per-entry gradient is diluted by the mean over {3 * W * H} "
        f"values), targets 0.8 x the untrained image")
    # ---- the main path, with the launch counts set to 0 just before
    wf.K1.launches = wf.K1_CAMERA.launches = wf.K1_KEYS.launches = 0
    traverse.KE.launches = traverse.KE_BINNED.launches = 0
    n_wave = wd.param_size(ws)
    runs, targets, steps = {}, {}, {}
    for K in (2, 3):
        label = f"wave K={K}"
        p0 = wd.init_params(ws)
        targets[K] = 0.8 * wd.render_wave_diff(p0, ws, origins, dirs,
                                               K).reshape(H, W, 3)
        steps[K] = wd.make_wave_train_step(ws, W, H, K=K,
                                           lr=TRAIN_LR["wave"])
        runs[label] = train_steps(
            label, lambda p, K=K: steps[K](p, cam5, targets[K]), p0,
            lambda: wf.K1.launches)[1]
        del p0
    v0 = rd.init_params(tree)
    etarget = 0.8 * rd.render_diff(v0, tree, cam5, W, H, packed=packed)

    def esvo_step(p):
        return rd.train_step(p, tree, cam5, etarget, W, H,
                             lr=TRAIN_LR["esvo"], packed=packed)

    vtrained, runs["esvo"] = train_steps("esvo", esvo_step, v0,
                                         lambda: traverse.KE.launches)
    launches = dict(K1_explicit=wf.K1.launches - wf.K1_CAMERA.launches,
                    K1_camera=wf.K1_CAMERA.launches,
                    K1_keys=wf.K1_KEYS.launches, KE=traverse.KE.launches,
                    KE_binned=traverse.KE_BINNED.launches)
    say(f"[train main path] launches {launches}")
    n_steps = TRAIN_WARM + TRAIN_TIMED
    per = [runs["wave K=2"]["launches_per_step"],
           runs["wave K=3"]["launches_per_step"],
           runs["esvo"]["launches_per_step"]]
    if (per != [2, 3, 1] or launches["K1_camera"]
            or launches["KE_binned"]
            or launches["K1_explicit"] != (2 + 3) * (n_steps + 1)
            or launches["KE"] != n_steps + 1):
        raise AssertionError(f"the train path's launches: {launches}, per "
                             f"step {per}")
    # ---- the K = 3 chain as the step traces it: stages, backward, grads
    p0 = wd.init_params(ws)
    stats = []
    chain = wd.khit_chain(ws, origins, dirs, 3, stats)
    for k, s in enumerate(stats):
        say(f"  [train chain] stage {k + 1}: rays {s['rays']} hits "
            f"{s['hits']} ITER_CAP-retired {s['capped']} K1 launches "
            f"{s['launches']}")
    bg = shade.sky(dirs)

    def grads_of(composite, ch, target):
        return rd.loss_and_grads(lambda p: torch.mean(
            (composite(p.albedo, p.density, ch, bg).reshape(H, W, 3)
             - target) ** 2), p0)

    with torch.no_grad():
        col_c = wd.composite_khit(p0.albedo, p0.density, chain, bg)
        col_r = wd.composite_khit_ref(p0.albedo, p0.density, chain, bg)
    fwd_err = (col_c - col_r).abs().max().item()
    loss_c, g_c = grads_of(wd.composite_khit, chain, targets[3])
    loss_r, g_r = grads_of(wd.composite_khit_ref, chain, targets[3])
    close = {f: torch.allclose(getattr(g_c, f), getattr(g_r, f), rtol=1e-4,
                               atol=1e-6) for f in ("albedo", "density")}
    bwd_err = max((getattr(g_c, f) - getattr(g_r, f)).abs().max().item()
                  for f in close)
    say(f"  [train compositor] K = 3 chain: forward max |custom - ref| "
        f"{fwd_err:.3e}; backward max |custom - autograd| {bwd_err:.3e}, "
        f"allclose(rtol 1e-4, atol 1e-6) {close}; loss {float(loss_c)!r} "
        f"vs {float(loss_r)!r}")
    if fwd_err > 1e-6 or not all(close.values()):
        raise AssertionError("composite_khit's backward differs from "
                             "autograd of composite_khit_ref")
    del g_r
    hit_ids = torch.unique(chain.aidx[chain.hitm > 0].long())
    support = dict(wave=grad_support("wave K=3", g_c, hit_ids, n_wave, dev))
    del g_c
    # the compositor's device time (forward, loss, backward) per step
    comp_ms = {}
    for K in (2, 3):
        ch = wd.HitChain(*(a[:K] for a in chain))
        comp_ms[f"wave K={K}"] = device_ms(
            lambda ch=ch, K=K: grads_of(wd.composite_khit, ch, targets[K]),
            3)
    say(f"  [train compositor] device ms (forward + loss + backward): "
        f"{comp_ms}")
    # ---- K1 on the stages' own rays: stages 2 and 3 start just past a
    # hit cube, on this terrain mostly inside the solid voxel below it
    d_stage = rd.d_unit(dirs)      # the chain traces unit rows of dirs
    stage_checks = []
    for k, s in enumerate(stats):
        say(f"[train compare] K1 vs trace_plain on every ray of stage "
            f"{k + 1} ({s['rays']} active)")
        a = Agreement(ws, f"train stage {k + 1}", s["origins"].contiguous(),
                      d_stage, s["active"])
        at_start = (a.res_k.t[a.res_k.hit] == 0).float().mean().item()
        say(f"    stage {k + 1}: hits at their start point (t = 0) "
            f"{at_start:.4f} of hits")
        stage_checks.append(a)
    # ---- the ESVO step: KE on its frame, its gradients' support
    say("[train compare] KE vs intersect_plain on render_diff's frame")
    ke = hold_ke("train render_diff frame", packed, origins.contiguous(),
                 dirs, torch.ones(W * H, dtype=torch.bool, device=dev),
                 order=traverse.tile_order(W, H, dev))
    _, vg = rd.loss_and_grads(lambda p: rd.pixel_loss(
        p, tree, cam5, etarget, W, H, packed=packed), v0)
    res = traverse.intersect_octree(tree, origins, dirs, packed=packed)
    support["esvo"] = grad_support("esvo", vg, torch.unique(
        res.node[res.hit].long()), tree.n_nodes, dev)
    del vg, res
    # ---- the two-wall step on the card against the CPU's
    scene = brick_scene.brickify(build_np.build_octree_np(two_wall_voxels()))
    w2, h2 = TWO_WALL_FRAME
    two = []
    for d in (dev, torch.device("cpu")):
        ws2 = wf.prepare(scene, d)
        step2 = wd.make_wave_train_step(ws2, w2, h2, K=2, lr=400.0)
        two.append(step2(wd.init_params(ws2, 4.0),
                         torch.from_numpy(two_wall_camera()).to(d),
                         torch.zeros(h2, w2, 3, device=d)))
    (pg, lg), (pc, lc) = two
    two_err = max((getattr(pg, f).cpu() - getattr(pc, f)).abs().max().item()
                  for f in ("albedo", "density"))
    say(f"[train two walls] card vs CPU step (16x8, K = 2, lr 400): max "
        f"|params difference| {two_err:.3e}; loss {float(lg)!r} vs "
        f"{float(lc)!r}")
    if two_err > 1e-5 or not np.isclose(float(lg), float(lc), rtol=1e-5,
                                        atol=0):
        raise AssertionError("the two-wall step on the card differs from "
                             "the CPU's")
    # ---- checkpoints written on the card and read back
    path = str(kernel_build.BUILD_DIR / "train_checkpoint.npz")
    ck = {}
    for kind, p in (("voxel", vtrained), ("wave", pg)):
        t1 = time.time()
        checkpoint.save_params(p, path, step=n_steps)
        back, step = checkpoint.load_params(path, dev, kind)
        ck[kind] = dict(bytes=os.path.getsize(path), s=time.time() - t1,
                        equal=bool(step == n_steps and all(
                            torch.equal(a, b) for a, b in zip(back, p))))
        os.remove(path)
    say(f"[train checkpoint] written on the card and read back: {ck}")
    if not all(c["equal"] for c in ck.values()):
        raise AssertionError(f"a checkpoint did not read back equal: {ck}")
    del vtrained, two, pg, pc
    # ---- device time of each kind of step
    prof = {}
    for K in (2, 3):
        prof[f"wave K={K}"] = profile_window(
            f"train wave K={K}", lambda i, K=K: steps[K](p0, cam5,
                                                         targets[K]),
            {"K1": "wf_trace_kernel", "K1 keys": "ray_key",
             "sort": "RadixSort"}, runs[f"wave K={K}"]["ms"])
    prof["esvo"] = profile_window("train esvo", lambda i: esvo_step(v0),
                                  {"KE": "esvo_trace_kernel"},
                                  runs["esvo"]["ms"])
    for label, c_ms in comp_ms.items():
        say(f"  [train {label}] compositor {c_ms:.3f} ms, "
            f"{c_ms / prof[label]['device_busy_ms']:.1%} of the step's "
            f"device busy")
    kernels = [
        kernel_entry("K1 wavefront traversal (a) flat L0, K-hit chain of "
                     "the train steps (K = 2 and 3) on the bench world",
                     "svo_raytracer_torch/csrc/wavefront.cu",
                     "svo_raytracer_tpu/ops/wavefront.py:891",
                     launches["K1_explicit"], stage_checks, stage_checks),
        dict(kernel_entry("KE per-ray ESVO traversal, render_diff train "
                          "steps on the bench world octree",
                          "svo_raytracer_torch/csrc/esvo.cu",
                          "svo_raytracer_tpu/ops/traverse.py:382",
                          launches["KE"], [ke], [ke]),
             tpu_kernel="none: an XLA while_loop (traverse.py:415-423), no "
                        "Pallas counterpart")]
    summary = dict(
        lr=TRAIN_LR, runs=runs, launches=launches, profile=prof,
        compositor_ms=comp_ms, forward_err=fwd_err, backward_err=bwd_err,
        stages=[{k: v for k, v in s.items() if k not in ("origins",
                                                          "active")}
                for s in stats],
        stage_ms=[a.ms for a in stage_checks], ke_ms=ke.ms,
        grad_support=support, two_wall_err=two_err, checkpoint=ck,
        table_entries=dict(wave=n_wave, esvo=tree.n_nodes))
    say(f"[train] phase took {time.time() - t0:.1f} s")
    return (summary, kernels, launches["K1_keys"],
            [a.keys for a in stage_checks])


# The viewer phase (viewer_phase) on the bench world at 1920x1080: the
# scripted session of each engine (mode 2; mode 0 over two idle frames; a
# move that resets it; mode 2; put_sphere; subtract_sphere; a screenshot;
# save; re-read; quit) and the rays each edit's kernel check adds around
# the edit.  The edits follow a mode-2 frame: the brush goes where the
# crosshair's depth puts it, and a mode-0 frame's depth is its bounce
# segment's hit distance (the reference's, shade.gi_update).
VIEWER_SCRIPT = ("3", "1", "", "", "w", "3", "c", "x", "p", "0", "9", "Q")
VIEWER_EDIT_RAYS = 4096


def edit_rays(cam, target, radius, world_size, dev):
    """VIEWER_EDIT_RAYS primaries from the camera toward random points
    within 1.5 brush radii of an edit's centre (voxel coordinates)."""
    import torch
    gen = np.random.default_rng(SEED)
    c = 1.0 + (np.asarray(target, np.float64) + 0.5) / world_size
    p = c + gen.uniform(-1.5, 1.5, (VIEWER_EDIT_RAYS, 3)) * radius \
        / world_size
    d = p - cam.pos
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(cam.pos, d.shape)
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def frames_equal(what, a, b):
    """Gate: two (colour, depth, iters) frames equal on every pixel in
    colour and depth (NaN equal to NaN); returns the pixels that hit."""
    import torch
    col = torch.equal(a[0].nan_to_num(-7.0), b[0].nan_to_num(-7.0))
    dep = torch.equal(a[1], b[1])
    if not (col and dep):
        raise AssertionError(f"{what}: frames differ (colour equal {col}, "
                             f"depth equal {dep})")
    return int((a[1] > 0).sum())


def hits_equal(what, a, b, fields=("hit", "value", "t", "normal",
                                   "depth")):
    """Gate: two HitResults equal in ``fields`` on every ray."""
    import torch
    bad = [f for f in fields if not torch.equal(
        getattr(a, f).nan_to_num(-7.0) if getattr(a, f).is_floating_point()
        else getattr(a, f), getattr(b, f).nan_to_num(-7.0)
        if getattr(b, f).is_floating_point() else getattr(b, f))]
    if bad:
        raise AssertionError(f"{what}: rays differ in {bad}")


def render_saved(v, saved, cam5):
    """The viewer's current frame rendered from the tables held at a save
    (``saved``: the WaveScene, or the DeviceOctree and its packed words)."""
    from svo_raytracer_torch.ops import render_wave, shade
    if v.engine == "wavefront":
        return render_wave.render_frame_wavefront(
            saved["scene"], cam5, W, H, render_mode=v.render_mode,
            frame_number=v.frame_number)
    return shade.render_image(saved["dev"], cam5, W, H,
                              render_mode=v.render_mode,
                              frame_number=v.frame_number,
                              use_beam=v.use_beam, packed=saved["packed"])


def viewer_session(dev, engine, path, world_size, out_dir, cam, edit_check,
                   after_setup=None):
    """One scripted session of apps.viewer.Viewer (VIEWER_SCRIPT) on the
    .svo world at ``path`` at 1920x1080 from ``cam``, the launch counts
    of K1 (explicit, camera mode, keys) and KE (and its binned entry) set
    to 0 before and summed over the commands' frames alone.  Each
    command's frame is timed on the host, ended by
    torch.cuda.synchronize().  ``edit_check(v, before)`` gates each edit
    after its frame (``before``: the mode-2 frame of the world just
    before the edit); ``after_setup(v)`` gates the set-up.  Gates: the
    screenshot decodes to the frame's pixels, and after re-reading, the
    frame equals the saved world's.
    Returns (viewer, per-command records, launches, the viewer's set-up
    seconds)."""
    import torch
    from svo_raytracer_torch.apps import viewer as vw
    from svo_raytracer_torch.core import svo_format
    from svo_raytracer_torch.io import image
    from svo_raytracer_torch.ops import traverse
    from svo_raytracer_torch.ops import wavefront as wf

    def counts():
        return dict(K1=wf.K1.launches, K1_camera=wf.K1_CAMERA.launches,
                    K1_keys=wf.K1_KEYS.launches, KE=traverse.KE.launches,
                    KE_binned=traverse.KE_BINNED.launches)

    t0 = time.perf_counter()
    v = vw.Viewer(svo_format.read_svo_file(path, world_size=world_size), W, H,
                  out_dir, commands=list(VIEWER_SCRIPT), engine=engine,
                  device=dev)
    v.cam = cam
    read_s = time.perf_counter() - t0
    pre_run, update, update_late = v.pre_run, v.update_early, v.update_late
    setup = {}

    def timed_pre_run():
        t1 = time.perf_counter()
        pre_run()
        torch.cuda.synchronize()
        setup["pre_run_s"] = time.perf_counter() - t1
        if after_setup is not None:
            after_setup(v)

    records, saved = [], {}
    total = {k: 0 for k in counts()}

    def timed_update():
        cmd = v.commands[0] if v.commands else None
        n_edits = len(v.edits)
        before = (v.render(v.cam5(), 1, 2) if cmd in ("c", "x") else None)
        torch.cuda.synchronize()
        c0 = counts()
        t1 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        got = {k: n - c0[k] for k, n in counts().items()}
        for k, n in got.items():
            total[k] += n
        rec = dict(cmd=cmd, ms=ms, mode=v.render_mode, frame=v.frame_number,
                   accum=v._accum_n, launches=got)
        records.append(rec)
        say(f"  [viewer {engine}] command {cmd!r}: frame {v.frame_number} "
            f"mode {v.render_mode} (accumulated {v._accum_n}) {ms:.3f} ms "
            f"on the host; launches K1 {got['K1'] - got['K1_camera']} "
            f"explicit + {got['K1_camera']} camera, keys {got['K1_keys']}, "
            f"KE {got['KE']} (binned {got['KE_binned']})")
        if len(v.edits) > n_edits:
            rec["edit"] = edit_check(v, before)
        if cmd == "0":
            saved.update(scene=v.wave_scene, dev=v.device_tree.dev,
                         packed=v.device_tree.packed,
                         bytes=os.path.getsize(os.path.join(out_dir,
                                                            "level1.svo")))
        if cmd == "9":
            # the re-read world's frame against the saved world's, rendered
            # from the tables held at the save
            cam5 = v.cam5()
            n = frames_equal("re-read vs saved world",
                             render_saved(v, saved, cam5), v.render(cam5))
            rec["reread_hits"] = n
            say(f"  [viewer {engine}] re-read world: its frame equals the "
                f"saved world's on every pixel ({n} hit pixels); "
                f"level1.svo {saved['bytes']} B")

    def checked_update_late():
        update_late()     # takes the screenshot
        rec = records[-1]
        if rec["cmd"] == "p":
            shot = image.read_png(v.last_screenshot)
            if not np.array_equal(shot, image.quantize(v.color)):
                raise AssertionError("the screenshot does not decode to the "
                                     "frame's pixels")
            rec["screenshot"] = v.last_screenshot

    v.pre_run, v.update_early, v.update_late = (timed_pre_run, timed_update,
                                                checked_update_late)
    wf.K1.launches = wf.K1_CAMERA.launches = wf.K1_KEYS.launches = 0
    traverse.KE.launches = traverse.KE_BINNED.launches = 0
    v.launch(max_frames=len(VIEWER_SCRIPT))
    launches = dict(K1_explicit=total["K1"] - total["K1_camera"],
                    K1_camera=total["K1_camera"], K1_keys=total["K1_keys"],
                    KE=total["KE"], KE_binned=total["KE_binned"])
    say(f"[viewer {engine}] session launches {launches}; set-up: read "
        f"{read_s:.3f} s, pre_run {setup['pre_run_s']:.3f} s")
    return v, records, launches, dict(read_s=read_s, **setup)


def viewer_phase(dev, bench_ws):
    """The viewer and its edit path at 1920x1080 on the bench world:
    apps/worldgen writes the 1024^3 perlin world to an .svo file (its
    defaults; gates: the node count, and the native codec's import
    re-exports the same bytes); apps/viewer runs VIEWER_SCRIPT on it
    through the wavefront engine (K1) from the bench's probe camera (gate:
    its prepared WaveScene equals bench_world_phase's array for array),
    then through the ESVO engine (KE).  Each edit prints its stages (the
    brush, ranged_update, brickify_patch, apply_patch), the bytes it
    copied to the card and n_mixed, beside a full brickify + prepare of
    the edited tree (wavefront) or a full upload (ESVO).  Gates on each
    edit: the tree changed (put_sphere adds nodes) and so did some
    pixels; wavefront: the patched scene renders the frames of a full
    re-prepare (mode 2 and mode 0 at the same frame number: colour and
    depth on every pixel; the primaries' hit, value, t, normal and
    depth; node ids differ, as the patch appends slots), K1 ==
    trace_plain on sampled rays and rays at the edit; ESVO: the
    DeviceTree's arrays and packed words equal a fresh padded upload and
    make_packed_table, its frame equals a fresh DeviceOctree's, KE ==
    intersect_plain on sampled rays and rays at the edit.  Returns
    (summary, launches of each session, the K1 and KE checks)."""
    import torch
    from svo_raytracer_torch import bench
    from svo_raytracer_torch.apps import worldgen
    from svo_raytracer_torch.ops import (brick_scene, kernel_build,
                                         render_wave, shade, traverse)
    from svo_raytracer_torch.ops import wavefront as wf
    from svo_raytracer_torch.runtime import native
    t0 = time.time()
    out_dir = kernel_build.BUILD_DIR / "viewer"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "bench_world.svo")
    # ---- worldgen at its defaults: bench.py's world, to an .svo file
    host, wt = worldgen.main(["--out", path])
    n_nodes = host.n_nodes
    del host
    t1 = time.perf_counter()
    with open(path, "rb") as f:
        data = f.read()[4:]
    size = bench_ws.world_size
    tree = native.import_svo(data, world_size=size)
    import_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    same = native.export_svo(tree) == data
    reexport_s = time.perf_counter() - t1
    say(f"[viewer worldgen] {n_nodes} nodes: build {wt['build_s']:.3f} s "
        f"(noise {wt['noise']:.3f}, chunk builds {wt['build']:.3f}, "
        f"splices {wt['splice']:.3f}), node table to the host "
        f"{wt['to_host']:.3f} s, native export {wt['export']:.3f} s, file "
        f"{wt['bytes'] / 1e6:.3f} MB ({wt['bytes']} B); native import "
        f"{import_s:.3f} s, re-export {reexport_s:.3f} s, same bytes {same}")
    if n_nodes != BENCH_WORLD["n_nodes"] or tree.n_nodes != n_nodes \
            or not same:
        raise AssertionError("worldgen's world differs from the bench "
                             "world, or its file does not round-trip")
    del tree, data
    cam, _ = bench.probe_camera(bench_ws)
    checks = {"K1": [], "KE": []}

    # ---- the wavefront viewer
    def wave_edit(v, before):
        e = v.edits[-1]
        cam5 = v.cam5()
        t1 = time.perf_counter()
        full = wf.prepare(brick_scene.brickify(v.tree_host), dev)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t1
        after = v.render(cam5, 1, 2)
        frames_equal("patched vs full re-prepare, mode 2", after,
                     render_wave.render_frame_wavefront(
                         full, cam5, W, H, render_mode=2, frame_number=1))
        frames_equal("patched vs full re-prepare, mode 0", v.render(
            cam5, v.frame_number, 0), render_wave.render_frame_wavefront(
                full, cam5, W, H, render_mode=0,
                frame_number=v.frame_number))
        o, d, _, _ = render_wave._frame_rays(cam5, W, H)
        hits_equal("patched vs full re-prepare, primaries",
                   wf.intersect_wavefront(v.wave_scene, o, d),
                   wf.intersect_wavefront(full, o, d))
        del full, o, d
        changed = int((after[0] != before[0]).any(-1).sum())
        rays = [torch.cat(x) for x in zip(
            sampled_rays(v.wave_scene, cam5),
            edit_rays(v.cam, e["target"], e["radius"], size, dev))]
        checks["K1"].append(Agreement(v.wave_scene, f"edit {len(v.edits)}",
                                      *rays))
        up = e["scene_upload"]
        say(f"  [viewer wavefront edit {len(v.edits)}] value {e['value']} "
            f"at {e['target']} radius {e['radius']}: nodes "
            f"{e['n_nodes_before']} -> {e['n_nodes']}, ChangeBounds "
            f"{e['bounds']}; brush {e['ms']['brush']:.3f} ms, ranged_update "
            f"{e['ms']['ranged_update']:.3f} ms "
            f"({e['tree_upload']['bytes']} B), brickify_patch "
            f"{e['ms']['brickify_patch']:.3f} ms, apply_patch "
            f"{e['ms']['apply_patch']:.3f} ms ({up['bytes']} B to the card, "
            f"full {up['full']}); n_mixed {e['n_mixed_before']} -> "
            f"{e['n_mixed']}; a full brickify + prepare of the edited tree "
            f"{full_s:.3f} s ({v.wave_scene.nbytes} B of tables); "
            f"{changed} pixels changed; patched == full re-prepare on every "
            f"pixel (modes 2 and 0) and primary (node ids aside)")
        if up["full"] or not changed or (e["value"] and e["n_nodes"]
                                         <= e["n_nodes_before"]):
            raise AssertionError("the edit did not patch incrementally, "
                                 "grow the tree or change a pixel")
        return dict(e, full_rebuild_s=full_s, pixels_changed=changed)

    say(f"[viewer] wavefront session {VIEWER_SCRIPT} at {W}x{H}")
    pre = {}

    def compare_setup(v):
        got = {f: torch.equal(getattr(v.wave_scene, f), getattr(bench_ws, f))
               for f in wf.WaveScene.ARRAYS}
        pre.update(got)
        if not all(got.values()) or v.wave_scene.n_mixed != bench_ws.n_mixed:
            raise AssertionError(f"the viewer's WaveScene differs from the "
                                 f"bench world's: {got}")

    wv, wrec, wl, wsetup = viewer_session(
        dev, "wavefront", path, size, str(out_dir), cam, wave_edit,
        after_setup=compare_setup)
    say(f"[viewer wavefront] set-up WaveScene equals the bench world's "
        f"array for array: {pre}")
    del wv
    torch.cuda.empty_cache()

    # ---- the ESVO viewer
    def esvo_edit(v, before):
        e = v.edits[-1]
        dt = v.device_tree
        cam5 = v.cam5()
        t1 = time.perf_counter()
        fresh = v.tree_host.to_device(dev, pad_to=dt.capacity)
        fpacked = traverse.make_packed_table(fresh)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t1
        same = [torch.equal(a, b) for a, b in zip(dt.arrays(),
                                                    fresh.arrays())]
        same.append(torch.equal(dt.packed, fpacked))
        del fresh, fpacked
        if not all(same):
            raise AssertionError(f"DeviceTree differs from a fresh upload: "
                                 f"{same}")
        plain = v.tree_host.to_device(dev)
        after = v.render(cam5, 1, 2)
        frames_equal("DeviceTree vs a fresh DeviceOctree, mode 2", after,
                     shade.render_image(plain, cam5, W, H, render_mode=2,
                                        frame_number=1))
        del plain
        changed = int((after[0] != before[0]).any(-1).sum())
        o, d, alive = esvo_sampled_rays(dt.dev, dt.packed, cam5)
        eo, ed = edit_rays(v.cam, e["target"], e["radius"], size, dev)
        checks["KE"].append(hold_ke(
            f"edit {len(v.edits)}", dt.packed, torch.cat([o, eo]),
            torch.cat([d, ed]), torch.cat([alive, torch.ones_like(
                eo[:, 0], dtype=torch.bool)])))
        say(f"  [viewer esvo edit {len(v.edits)}] value {e['value']} at "
            f"{e['target']}: nodes {e['n_nodes_before']} -> {e['n_nodes']}, "
            f"ChangeBounds {e['bounds']}; brush {e['ms']['brush']:.3f} ms, "
            f"ranged_update {e['ms']['ranged_update']:.3f} ms "
            f"({e['tree_upload']['bytes']} B, full "
            f"{e['tree_upload']['full']}, packed words rebuilt on the card) "
            f"vs a full padded upload + pack {full_s * 1e3:.3f} ms "
            f"({16 * dt.capacity} B); {changed} pixels changed; DeviceTree "
            f"== fresh upload, frame == fresh DeviceOctree's")
        if e["tree_upload"]["full"] or not changed or (
                e["value"] and e["n_nodes"] <= e["n_nodes_before"]):
            raise AssertionError("the edit did not update in place, grow "
                                 "the tree or change a pixel")
        return dict(e, full_upload_s=full_s, pixels_changed=changed)

    say(f"[viewer] ESVO session {VIEWER_SCRIPT} at {W}x{H}")
    ev, erec, el, esetup = viewer_session(dev, "esvo", path, size,
                                          str(out_dir), cam, esvo_edit)
    del ev
    for name, launches in (("wavefront", wl), ("esvo", el)):
        need = ("K1_explicit", "K1_camera", "K1_keys") \
            if name == "wavefront" else ("KE",)
        if min(launches[k] for k in need) < 1:
            raise AssertionError(f"the {name} session missed a kernel: "
                                 f"{launches}")
    summary = dict(
        worldgen=dict(n_nodes=n_nodes, import_s=import_s,
                      reexport_s=reexport_s, **wt),
        wavefront=dict(commands=wrec, launches=wl, setup=wsetup),
        esvo=dict(commands=erec, launches=el, setup=esetup),
        k1_edit_ms=[c.ms for c in checks["K1"]],
        ke_edit_ms=[c.ms for c in checks["KE"]])
    say(f"[viewer] {json.dumps(summary)}")
    say(f"[viewer] phase took {time.time() - t0:.1f} s")
    return summary, dict(wavefront=wl, esvo=el), checks


# ------------------------------------------- the rest of the single-card API
def reset_counts():
    """Every kernel's launch count set to 0 (before a path is driven)."""
    from svo_raytracer_torch.ops import brick_dda, brick_pallas, traverse
    from svo_raytracer_torch.ops import wavefront as wf
    for k in (wf.K1, wf.K1_CAMERA, wf.K1_KEYS, traverse.KE,
              traverse.KE_BINNED, brick_dda.K2, brick_pallas.K3):
        k.launches = 0


def read_counts():
    """The launch counts of the path just driven, by kernels line."""
    from svo_raytracer_torch.ops import brick_dda, brick_pallas, traverse
    from svo_raytracer_torch.ops import wavefront as wf
    return dict(K1_explicit=wf.K1.launches - wf.K1_CAMERA.launches,
                K1_camera=wf.K1_CAMERA.launches, K1_keys=wf.K1_KEYS.launches,
                KE=traverse.KE.launches - traverse.KE_BINNED.launches,
                KE_binned=traverse.KE_BINNED.launches,
                K2=brick_dda.K2.launches, K3=brick_pallas.K3.launches)


def entry_phase(dev, tree, packed, cam5):
    """[entry]: the entry point's analog (svo_raytracer_torch/entry.py) on
    the card: entry() builds its 64^3 scene, forward renders the
    256x144 mode-2 frame (KE through shade.render_image), timed; its KE
    segments held to traverse.intersect_plain in every field; then the
    same forward at 1920x1080 on the bench world's octree.  Gates: shape
    and dtype, finite colour, KE launched on every segment.  Returns
    (summary, launches, KE checks)."""
    import torch
    from svo_raytracer_torch import entry
    from svo_raytracer_torch.ops import shade, traverse
    t0 = time.time()
    fn, args = entry.entry()
    reset_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_counts()
    if (tuple(out.shape) != (entry.HEIGHT, entry.WIDTH, 3)
            or out.dtype != torch.float32 or out.device.type != dev.type
            or not bool(torch.isfinite(out).all()) or launches["KE"] < 2):
        raise AssertionError(f"entry forward: {tuple(out.shape)} "
                             f"{out.dtype} {out.device}, launches {launches}")
    ms, _ = frame_ms(lambda i: fn(*args), 3, 10)
    with capture(traverse, "trace") as calls:
        fn(*args)
    held = [hold_ke(f"entry {n} segment", *a, **k)
            for n, (a, k) in zip(("primary", "shadow"), calls)]

    def forward_1080(i):
        return shade.render_image(tree, cam5, W, H, render_mode=2,
                                  packed=packed)[0]

    reset_counts()
    big = forward_1080(0)
    torch.cuda.synchronize()
    for k, v in read_counts().items():
        launches[k] += v
    big_ms, _ = frame_ms(forward_1080, 3, 10)
    finite = torch.isfinite(big).all(-1).float().mean().item()
    say(f"[entry] entry(): {args[0].n_nodes}-node 64^3 scene, forward "
        f"{tuple(out.shape)} {out.dtype}: median "
        f"{ms:.3f} ms of 10 (host, synchronized); the forward at {W}x{H} "
        f"on the bench world's {tree.n_nodes}-node octree {big_ms:.3f} ms, "
        f"finite colour {finite:.6f}; launches {launches}")
    if finite < 0.999:
        raise AssertionError(f"finite colour on {finite} of pixels")
    say(f"[entry] phase took {time.time() - t0:.1f} s")
    return (dict(ms=ms, ms_1080=big_ms, finite_1080=finite,
                 ke_ms=[h.ms for h in held]), launches, held)


def staged_phase(dev, tree, packed, cam5):
    """[staged]: shade.render_frame_staged, the JAX package's production
    ESVO frame (the beam prepass on, its coarse rays through the staged
    traversal, then one full-frame pass) at 1920x1080 on the bench
    world's octree: modes 2, 0 gi-1 and 3, and mode 2 with the G = 32
    skip grid (K2).  Each frame once with its per-segment stats and
    launch counts, then ESVO_WARM_FRAMES + ESVO_TIMED_FRAMES timed.
    Gates: each frame equals render_image with the same settings in
    colour, depth and iters on every pixel, but the skip frame's colour
    and depth, which may move by STAGED_SKIP_BEAM_TOL where the skip grid
    restarts a coarse beam ray (its iters and hits equal on every pixel;
    the pixels that moved are printed); finite colour; KE in every
    segment, K2 in the skip frame; KE (the beam in the binned schedule,
    the frame's segments in its 8x4 tile order) and K2 (ray order) ==
    their plain versions on the beam, primary and shadow segments of the
    skip frame.  Returns (summary, launches, KE checks, KE binned checks,
    K2 checks)."""
    import torch
    from svo_raytracer_torch.ops import (brick_dda, brick_scene, shade,
                                         skip_grid, traverse)
    t0 = time.time()
    tab = torch.from_numpy(brick_scene.table_rows(
        skip_grid.build_skip_grid(tree, SKIP_G))).to(dev)
    configs = {"mode-2": dict(render_mode=2),
               "mode-0 gi-1": dict(render_mode=0, gi_bounces=1),
               "mode-3": dict(render_mode=3),
               f"mode-2 skip G={SKIP_G}": dict(render_mode=2, skip_tab=tab,
                                               skip_grid_size=SKIP_G)}
    launches = {k: 0 for k in read_counts()}
    out = {}
    for label, kw in configs.items():
        stats = []
        reset_counts()
        col, depth, iters = shade.render_frame_staged(
            tree, cam5, W, H, packed=packed, stats=stats, **kw)
        torch.cuda.synchronize()
        n = read_counts()
        for k, v in n.items():
            launches[k] += v
        ms, times = frame_ms(lambda i: shade.render_frame_staged(
            tree, cam5, W, H, packed=packed, frame_number=i + 2, **kw),
            ESVO_WARM_FRAMES, ESVO_TIMED_FRAMES)
        ref = shade.render_image(tree, cam5, W, H, packed=packed,
                                 use_beam=True, **kw)
        unequal = {f: int((~same(a, b).reshape(H, W, -1).all(-1)).sum())
                   for f, a, b in zip(("colour", "depth", "iters"),
                                      (col, depth, iters), ref)}
        moved = max((a - b).abs().max().item()
                    for a, b in zip((col, depth), ref[:2]))
        hit = depth > 0 if kw["render_mode"] != 0 else depth != -1.0
        hit_ref = ref[1] > 0 if kw["render_mode"] != 0 else ref[1] != -1.0
        finite = torch.isfinite(col).all(-1).float().mean().item()
        out[label] = dict(ms=ms, times=times, launches=n,
                          segments=len(stats),
                          hitfrac=hit.float().mean().item(),
                          unequal=unequal, max_abs_diff=moved)
        say(f"[staged {label}] {W}x{H}: median {ms:.3f} ms/frame of "
            f"{ESVO_TIMED_FRAMES} (min {min(times):.3f}, max "
            f"{max(times):.3f}); segments {len(stats)}, KE launches "
            f"{n['KE'] + n['KE_binned']} ({n['KE_binned']} binned), K2 "
            f"{n['K2']} per frame; hit fraction "
            f"{out[label]['hitfrac']:.4f}; finite colour {finite:.6f}; vs "
            f"render_image: unequal pixels {unequal}, max |diff| in "
            f"colour and depth {moved:.3e}")
        loose = "skip_tab" in kw
        if ((unequal["iters"] or not torch.equal(hit, hit_ref))
                or (any(unequal.values()) and not loose)
                or moved > STAGED_SKIP_BEAM_TOL or finite < 0.999
                or any(s["launches"] < 1 for s in stats)
                or (loose and n["K2"] < 1)):
            raise AssertionError(f"staged {label}: {out[label]}")
    # ---- KE and K2 vs their plain versions on the skip frame's beam,
    # primary and shadow segments
    kw = configs[f"mode-2 skip G={SKIP_G}"]
    with capture(traverse, "trace") as ke_calls, \
            capture(brick_dda, "coarse_dda") as k2_calls:
        shade.render_frame_staged(tree, cam5, W, H, packed=packed, **kw)
    if not (ke_calls[0][1].get("order") is None
            and all(k["order"] is not None for _, k in ke_calls[1:])
            and all("order" not in k for _, k in k2_calls)):
        raise AssertionError("the staged frame's segments did not take "
                             "the tile order, or K2 did")
    names = ("beam", "primary", "shadow")
    ke = [hold_ke(f"staged {n}", *a, **k)
          for n, (a, k) in zip(names, ke_calls[:3])]
    k2 = [hold_k2(f"staged {n}", occ, k["grid_size"], o, d, k["active"])
          for n, ((occ, o, d), k) in zip(names, k2_calls[:3])]
    say(f"[staged] phase took {time.time() - t0:.1f} s")
    return out, launches, ke[1:], ke[:1], k2


def progressive_phase(dev, tree, cam5):
    """[progressive]: shade.render_progressive, spp 4 gi-1 at 1920x1080 on
    the bench world's octree (threefry mode-0 samples, KE), timed per
    sample.  Gates: threefry bits on the card equal the CPU's for the
    same key on every pixel; finite colour; an spp-4 image is closer to
    another key's spp-4 image than an spp-1 image is.  Returns (summary,
    launches)."""
    import torch
    from svo_raytracer_torch.ops import rng, shade
    t0 = time.time()
    key, other = rng.prng_key(7), rng.prng_key(8)
    n = W * H
    gpu = rng.threefry_uniform(key, torch.arange(n, device=dev), 1, 0, 1)
    cpu = rng.threefry_uniform(key, torch.arange(n), 1, 0, 1)
    bits_equal = bool(torch.equal(gpu.cpu().view(torch.int32),
                                  cpu.view(torch.int32)))
    reset_counts()
    four, depth = shade.render_progressive(tree, cam5, W, H, spp=4,
                                           gi_bounces=1, rng_key=key)
    torch.cuda.synchronize()
    launches = read_counts()
    ms, times = frame_ms(lambda i: shade.render_progressive(
        tree, cam5, W, H, spp=4, gi_bounces=1, rng_key=key), 1, 5)
    one, _ = shade.render_progressive(tree, cam5, W, H, spp=1, rng_key=key)
    four_b, _ = shade.render_progressive(tree, cam5, W, H, spp=4,
                                         rng_key=other)
    d1 = (one - four_b).abs().mean().item()
    d4 = (four - four_b).abs().mean().item()
    finite = torch.isfinite(four).all(-1).float().mean().item()
    say(f"[progressive] spp 4 gi-1 {W}x{H}: median {ms:.3f} ms per call "
        f"of 5, {ms / 4:.3f} ms per sample; launches {launches}; threefry "
        f"bits on the card equal the CPU's on {n} pixels: {bits_equal}; "
        f"finite colour {finite:.6f}; mean |spp1 - spp4'| {d1:.5f}, "
        f"|spp4 - spp4'| {d4:.5f}")
    if not bits_equal or finite < 0.999 or not d4 < d1 or \
            launches["KE"] < 4 or launches["KE_binned"] < 4:
        raise AssertionError("progressive: bits, finite colour, variance "
                             "or launches")
    say(f"[progressive] phase took {time.time() - t0:.1f} s")
    return (dict(ms=ms, times=times, ms_per_sample=ms / 4,
                 bits_equal=bits_equal, d1=d1, d4=d4), launches)


def brick_witness(o, d, hit, t, world_size, solid):
    """An exact-as-float64 witness for brick engines' answers: each ray
    (voxel-unit origin ``o``, direction ``d`` with the engines' 1e-4
    clamp, both (n, 3) float64 arrays) walks the voxel grid in float64 to
    the world's edge, and ``solid`` (a
    callable on an (m, 3) int64 array of voxels) reads the world.  An
    engine's answer (``hit``, ``t`` in voxels) is right when it passes no
    solid voxel that the ray crosses for BRICK_DT_VOX or more (a chord no
    float DDA steps over) before ``t`` - BRICK_DT_VOX, and a hit lies
    within BRICK_DT_VOX of a solid voxel.  Returns per ray: ``ok``, the
    exact first solid voxel's entry t and chord (nan on a miss), and
    ``passed`` (the answer lies beyond a crossed solid voxel with a
    shorter chord: a clip the engine stepped over) and ``tie`` (a hit
    on a solid voxel that the ray passes within BRICK_DT_VOX of without
    crossing it)."""
    d = np.where(np.abs(d) < 1e-4, np.where(d >= 0, 1e-4, -1e-4), d)
    n = len(o)
    walks = []
    for i in range(n):
        p, dd = o[i], d[i]
        idx = np.floor(p).astype(np.int64)
        idx -= (p == idx) & (dd < 0)
        step = np.where(dd > 0, 1, -1)
        tt, cells = 0.0, []
        while (idx >= 0).all() and (idx < world_size).all():
            nxt = (idx + (step > 0) - p) / dd
            a = int(np.argmin(nxt))
            cells.append((tuple(idx), tt, float(nxt[a])))
            tt = float(nxt[a])
            idx[a] += step[a]
        walks.append(cells)
    near = [np.floor(o[i] + t[i] * d[i]).astype(np.int64)
            + np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                       -1).reshape(-1, 3) if hit[i] else np.zeros((0, 3),
                                                                  np.int64)
            for i in range(n)]
    allv = np.concatenate([np.array([c[0] for c in w], np.int64).reshape(-1, 3)
                           for w in walks] + near)
    allv = np.unique(np.clip(allv, 0, world_size - 1), axis=0)
    sol = dict(zip(map(tuple, allv.tolist()),
                   np.asarray(solid(allv)).astype(bool).tolist()))
    out = dict(ok=np.zeros(n, bool), passed=np.zeros(n, bool),
               tie=np.zeros(n, bool), t_first=np.full(n, np.nan),
               chord=np.full(n, np.nan))
    for i, w in enumerate(walks):
        crossed = [(v, a, b) for v, a, b in w if sol[v]]
        if crossed:
            out["t_first"][i] = crossed[0][1]
            out["chord"][i] = crossed[0][2] - crossed[0][1]
        limit = t[i] - BRICK_DT_VOX if hit[i] else np.inf
        real = [a for v, a, b in crossed if b - a >= BRICK_DT_VOX]
        skipped = bool(real) and real[0] < limit
        out["passed"][i] = any(a < limit for v, a, b in crossed)
        if not hit[i]:
            out["ok"][i] = not skipped
            continue
        p = o[i] + t[i] * d[i]
        box = np.maximum(np.maximum(near[i] - p, p - (near[i] + 1)), 0.0)
        close = [v for v, dist in zip(map(tuple, near[i].tolist()),
                                      box.max(-1))
                 if dist <= BRICK_DT_VOX and sol.get(v, False)]
        out["ok"][i] = bool(close) and not skipped
        out["tie"][i] = bool(close) and not any(
            a - BRICK_DT_VOX <= t[i] <= b + BRICK_DT_VOX
            for v, a, b in crossed)
    return out


def bricks_phase(dev, ws, tree, cam5):
    """[bricks]: the XLA brick reference engine (brick_trace.intersect_bricks,
    plain PyTorch, sharing no code with K1) on the bench world's
    BrickScene on the card, over BRICK_ORACLE_RAYS rays: half sampled
    1080p primaries, half sampled rays of the gi-1 bounce segment (the
    glsl random of frame 1), held against K1 (wavefront.intersect_wavefront
    on the same rays).  Gates: hit agreement >= BENCH_HIT_AGREEMENT;
    value equal where both hit; where both hit, |dt| <= BRICK_DT_VOX
    voxels and voxel_pos equal (NaN equal to NaN), but for the t = 0 hits
    of rays that start on a voxel face inside solid, which either voxel
    beside the face answers (K1 takes the one the ray enters, the oracle
    the one the origin floors to).  Every other ray where the two part
    (at most 1 - BENCH_HIT_AGREEMENT of them) goes to brick_witness,
    which reads the world from its generator (the perlin noise at each
    voxel, on the card) and not from either engine's tables: K1's answer
    must be right on each; the oracle's too, but for misses of rays that
    lie in a brick-face plane with a direction component under the 1e-4
    clamp along its normal, where the oracle's 1/1024-voxel brick-exit
    nudge along that component moves the origin by less than a float32
    ulp, so it re-enters the brick it left until its 64 rounds run out.
    The rays that part and both answers are written to
    svo_raytracer_torch/_build/bricks_disputed.npz
    (tests/data/bench_world_bricks_disputed.npz keeps one run's, which
    tests/test_torch_bricks_witness.py decides again in exact
    arithmetic).  Returns (summary, K1 launches)."""
    import torch
    from svo_raytracer_torch.ops import (brick_scene, brick_trace,
                                         kernel_build, noise, render_wave,
                                         rng, shade)
    from svo_raytracer_torch.ops import wavefront as wf
    t0 = time.time()
    scene = brick_scene.brickify(tree.to_numpy()).to_device(dev)
    setup_s = time.time() - t0
    gen = np.random.default_rng(SEED)
    origins, dirs, px, py = render_wave._frame_rays(cam5, W, H)
    B = dirs.shape[0]
    prim = wf.intersect_wavefront(ws, origins, dirs)
    accum = torch.zeros((B, 3), device=dev)
    mask = torch.ones((B, 3), device=dev)
    depth = torch.full((B,), -1.0, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    _, _, _, _, active, bo, bd = shade.gi_update(
        True, (), accum, mask, depth, iters,
        torch.ones(B, dtype=torch.bool, device=dev), origins, dirs,
        rng.pixel_rand(px, py, 1), prim)
    half = BRICK_ORACLE_RAYS // 2
    pick = torch.from_numpy(gen.choice(B, half, replace=False)).to(dev)
    live = torch.nonzero(active).flatten()
    bpick = live[torch.from_numpy(gen.choice(live.numel(), half,
                                             replace=False)).to(dev)]
    o = torch.cat([origins[pick], bo[bpick]]).contiguous()
    d = torch.cat([dirs[pick], bd[bpick]]).contiguous()
    reset_counts()
    k1 = wf.intersect_wavefront(ws, o, d)
    torch.cuda.synchronize()
    launches = read_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = brick_trace.intersect_bricks(scene, o, d)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    size = ws.world_size
    both = k1.hit & ref.hit
    agree = (k1.hit == ref.hit).float().mean().item()
    voxel_ne = ~same(k1.voxel_pos, ref.voxel_pos).all(-1)
    dt = (k1.t - ref.t).abs() * float(size)
    # bounce rays leave from a hit voxel's corner plus a normal offset, so
    # many start on a voxel face; those inside solid hit at t = 0
    ov = (o - 1.0) * float(size)
    face = (ov == ov.floor()).any(-1)
    tie0 = both & face & (k1.t == 0) & (ref.t == 0)
    part = (k1.hit != ref.hit) | (both & ~tie0 & (voxel_ne
                                                  | (dt > BRICK_DT_VOX)))
    held = both & ~part

    # the witness, on the rays that part: the world from its generator
    # (bench.build_scene's chunks at world offset (0, -size / 2, 0))
    def solid(v):
        x = torch.from_numpy(v).to(dev)
        return noise.sample_perlin_terrain(
            x[:, 0], x[:, 1] - size // 2, x[:, 2]).cpu().numpy()

    t2 = time.time()
    sel = torch.nonzero(part).flatten()
    po = ov[sel].double().cpu().numpy()
    pd = d[sel].double().cpu().numpy()
    answers = {n: (r.hit[sel].cpu().numpy(),
                   r.t[sel].double().cpu().numpy() * size)
               for n, r in (("k1", k1), ("ref", ref))}
    wit = {n: brick_witness(po, pd, h, t, size, solid)
           for n, (h, t) in answers.items()}
    # the oracle's stuck rays: in a brick-face plane, that component
    # under the clamp
    plane = ((po % 32 == 0) & (np.abs(pd) < 1e-4)).any(-1)
    stuck = ~answers["ref"][0] & plane
    witness_s = time.time() - t2
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(kernel_build.BUILD_DIR / "bricks_disputed.npz",
             index=sel.cpu().numpy(), o=o[sel].cpu().numpy(),
             d=d[sel].cpu().numpy(),
             **{f"{n}_{f}": v for n, (h, t) in answers.items()
                for f, v in (("hit", h), ("t_vox", t))})
    out = dict(rays=o.shape[0], hits=int(ref.hit.sum()), ms=ms,
               setup_s=setup_s, hit_agreement=agree,
               primary_agreement=(k1.hit == ref.hit)[:half].float().mean()
               .item(),
               bounce_agreement=(k1.hit == ref.hit)[half:].float().mean()
               .item(),
               both_hit=int(both.sum()),
               value_unequal=int((k1.value != ref.value)[both].sum()),
               face_t0_hits=int(tie0.sum()),
               face_t0_voxel_unequal=int(voxel_ne[tie0].sum()),
               held=int(held.sum()),
               held_max_abs_dt_vox=dt[held].max().item(),
               parted=int(part.sum()),
               parted_hit=int((k1.hit != ref.hit).sum()),
               k1_right=int(wit["k1"]["ok"].sum()),
               k1_passed_clips=int(wit["k1"]["passed"].sum()),
               k1_passed_max_chord=float(np.nanmax(
                   wit["k1"]["chord"][wit["k1"]["passed"]], initial=0.0)),
               k1_ties=int(wit["k1"]["tie"].sum()),
               ref_right=int(wit["ref"]["ok"].sum()),
               ref_ties=int(wit["ref"]["tie"].sum()),
               ref_stuck_misses=int((stuck & ~wit["ref"]["ok"]).sum()),
               witness_s=witness_s)
    say(f"[bricks] brick_trace.intersect_bricks on the bench world's "
        f"BrickScene (brickify + to_device {setup_s:.1f} s), {o.shape[0]} "
        f"rays ({half} sampled primaries, {half} of the gi-1 bounce): "
        f"{ms:.1f} ms (host, synchronized); hits {out['hits']}; vs K1: hit "
        f"agreement {agree:.6f} (primaries {out['primary_agreement']:.6f}, "
        f"bounce {out['bounce_agreement']:.6f}); where both hit "
        f"({out['both_hit']} rays): value unequal {out['value_unequal']}; "
        f"t = 0 hits of rays from a voxel face {out['face_t0_hits']} "
        f"(voxel_pos unequal on {out['face_t0_voxel_unequal']}); the same "
        f"voxel within {BRICK_DT_VOX} voxels on {out['held']} (max |dt| "
        f"{out['held_max_abs_dt_vox']:.3e} voxels)")
    say(f"[bricks] the engines part on {out['parted']} rays "
        f"({out['parted_hit']} in hit); the witness ({witness_s:.1f} s) "
        f"finds K1 right on {out['k1_right']} (clips under "
        f"{BRICK_DT_VOX} voxels stepped over {out['k1_passed_clips']}, "
        f"longest {out['k1_passed_max_chord']:.3e}; edge ties "
        f"{out['k1_ties']}), the oracle right on {out['ref_right']} (edge "
        f"ties {out['ref_ties']}; misses stuck in a brick-face plane "
        f"{out['ref_stuck_misses']}); K1 launches {launches}")
    for j in range(min(len(po), 12)):
        say(f"    ray {int(sel[j])}: K1 {answers['k1'][0][j]} t "
            f"{answers['k1'][1][j]:.5f}, oracle {answers['ref'][0][j]} t "
            f"{answers['ref'][1][j]:.5f} voxels; first solid voxel crossed "
            f"at {wit['k1']['t_first'][j]:.5f} for "
            f"{wit['k1']['chord'][j]:.3e}; right: K1 "
            f"{wit['k1']['ok'][j]}, oracle {wit['ref']['ok'][j]}")
    if (agree < BENCH_HIT_AGREEMENT or out["value_unequal"]
            or out["parted"] > (1 - BENCH_HIT_AGREEMENT) * o.shape[0]
            or not wit["k1"]["ok"].all()
            or not (wit["ref"]["ok"] | stuck).all()):
        raise AssertionError(f"intersect_bricks vs K1: {out}")
    del scene
    torch.cuda.empty_cache()
    say(f"[bricks] phase took {time.time() - t0:.1f} s")
    return out, launches


def api_phases(dev, ws, tree, packed, cam5):
    """The rest of the single-card API on the bench world, each path
    driven with the launch counts set to 0 just before it and read just
    after: [entry], [staged], [progressive], [bricks].  Returns (summary,
    new kernels lines (KE on the bench world's octree, plain and binned
    schedules; K2 at G = 32 on it), the K1 launches to add to the bench
    world's K1 (a) line, and the K1 key launches)."""
    summary = {}
    summary["entry"], e_n, e_ke = entry_phase(dev, tree, packed, cam5)
    summary["staged"], s_n, s_ke, s_binned, s_k2 = staged_phase(
        dev, tree, packed, cam5)
    summary["progressive"], p_n = progressive_phase(dev, tree, cam5)
    summary["bricks"], b_n = bricks_phase(dev, ws, tree, cam5)
    n = {k: e_n[k] + s_n[k] + p_n[k] + b_n[k] for k in e_n}
    summary["launches"] = dict(entry=e_n, staged=s_n, progressive=p_n,
                               bricks=b_n)
    tpu_kernel = ("none: an XLA while_loop (traverse.py:415-423), no "
                  "Pallas counterpart")
    kernels = [
        dict(kernel_entry(
            "KE per-ray ESVO traversal, bench world 1024^3 octree: staged "
            "frames, progressive samples, the entry and the multi-rank "
            "paths (plain schedule)",
            "svo_raytracer_torch/csrc/esvo.cu",
            "svo_raytracer_tpu/ops/traverse.py:382", n["KE"], s_ke,
            s_ke + e_ke), tpu_kernel=tpu_kernel),
        dict(kernel_entry(
            "KE per-ray ESVO traversal, bench world 1024^3 octree: beams and "
            "cone-traced bounces, the multi-rank brick bounces too (binned "
            "schedule)",
            "svo_raytracer_torch/csrc/esvo.cu",
            "svo_raytracer_tpu/ops/traverse.py:382", n["KE_binned"],
            s_binned, s_binned), tpu_kernel=tpu_kernel),
        kernel_entry(f"K2 skip-grid coarse DDA, G={SKIP_G} staged frames, "
                     f"bench world", "svo_raytracer_torch/csrc/brick_dda.cu",
                     "svo_raytracer_tpu/ops/brick_dda.py:85", n["K2"], s_k2,
                     s_k2)]
    say(f"[api] launches of the four paths: {n}")
    for k in ("KE", "KE_binned", "K2", "K1_explicit", "K1_keys"):
        if n[k] < 1:
            raise AssertionError(f"the API paths missed {k}: {n}")
    return summary, kernels, n["K1_explicit"], n["K1_keys"]


# ------------------------------------------------ the multi-device layer
def _multi_world(d, dev):
    """The bench world as the parent handed it to the ranks (multi_phase)."""
    import torch
    return torch.load(os.path.join(d, "world.pt"), map_location=dev,
                      weights_only=False)


def _multi_digest(t):
    """Two int64 sums over a float32 tensor's bit patterns, plain and
    position-weighted: equal digests on every rank stand for equal
    tensors."""
    import torch
    bits = t.detach().reshape(-1).view(torch.int32)
    plain = int(bits.sum(dtype=torch.int64))
    weighted = 0
    for i, c in enumerate(bits.split(1 << 24)):
        w = torch.arange(c.numel(), device=c.device) % 65521 + 1 + i
        weighted += int((c.long() * w).sum())
    return [plain, weighted]


def _frame_share(a, b, tol):
    """(share of pixels within ``tol`` in every channel, share exactly
    equal, max |a - b|) of two images."""
    diff = (a - b).abs().amax(-1)
    return (float((diff <= tol).float().mean()),
            float((a == b).all(-1).float().mean()),
            float(diff.max()))


def _multi_kernel_checks(ws, tree, packed, bricks, wave_segments,
                         esvo_rays):
    """On MULTI_SAMPLE sampled rays of each of this rank's segments: K1
    (in key order) == trace_plain and its keys == ray_keys_plain on the
    wavefront mode-0 frame's primary and bounce segments; KE ==
    intersect_plain on the ESVO band's primaries and on the brick rays
    of this rank's first brick.  Returns {kernel: max |err|} and raises
    where a field differs."""
    import torch
    from svo_raytracer_torch.ops import traverse
    from svo_raytracer_torch.ops import wavefront as wf
    from svo_raytracer_torch.utils.constants import MAX_DEPTH
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    errs = {"K1": 0.0, "K1 keys": 0.0, "KE": 0.0}

    def pick(n):
        return torch.randperm(n, generator=gen)[:MULTI_SAMPLE]

    for seg, s in enumerate(wave_segments):
        live = torch.nonzero(s["active"] if s["active"] is not None
                             else torch.ones_like(s["dirs"][:, 0],
                                                  dtype=torch.bool))
        idx = live.flatten()[pick(live.numel()).to(live.device)]
        o, d, alive = wf._rays(ws, s["origins"][idx], s["dirs"][idx])
        k = dict(zip(("status", "t", "cell", "widx", "iters"),
                     wf.trace_kernel(ws, o, d, alive,
                                     wf.ray_order(ws, o, d, alive))))
        p = dict(zip(k, wf.trace_plain(ws, o, d, alive)))
        keys = unequal(dict(key=wf.ray_keys_kernel(ws, o, d, alive)),
                       dict(key=wf.ray_keys_plain(ws, o, d, alive)))
        for name, (diff, err) in (("K1", unequal(k, p)), ("K1 keys", keys)):
            if any(diff.values()):
                raise AssertionError(f"{name} segment {seg}: {diff}")
            errs[name] = max(errs[name], err)
    o_band, d_band = esvo_rays
    corner = bricks.corners[0]
    for name, pk, o, d in (
            ("band", packed, o_band, d_band),
            (f"brick {bricks.ids[0]}", bricks.packed[0],
             (o_band - corner[None]) * 2.0 + 1.0, d_band)):
        idx = pick(o.shape[0]).to(o.device)
        oo, dd = o[idx].contiguous(), d[idx].contiguous()
        alive = torch.ones(oo.shape[0], dtype=torch.bool, device=oo.device)
        kw = dict(max_depth=MAX_DEPTH - (0 if name == "band" else 1))
        diff, err = unequal(traverse.intersect_kernel(pk, oo, dd, alive, **kw),
                            traverse.intersect_plain(pk, oo, dd, alive, **kw))
        if any(diff.values()):
            raise AssertionError(f"KE {name}: {diff}")
        errs["KE"] = max(errs["KE"], err)
    return errs


def _local_brick_step(bs, dev, tree, cam5, target):
    """The brick train step on one card: every brick of ``bs`` traced
    there (intersect_bricks_local), make_brick_train_step's loss and
    update, from untrained parameters.  Returns (params, loss)."""
    import torch
    from svo_raytracer_torch.diff import render_diff as rd
    from svo_raytracer_torch.ops import traverse
    from svo_raytracer_torch.parallel import bricks as B
    from svo_raytracer_torch.parallel import render_sharded as rs
    local = bs.to_device(dev)
    origins, dirs = rs.band_rays(cam5, W, H, 0, H, rd.d_unit)
    res = B.intersect_bricks_local(local, origins, dirs,
                                   order=traverse.tile_order(W, H, dev))
    del local

    def loss_sum(p):
        col = rd.shade_hits(p, res, dirs).reshape(H, W, 3)
        return torch.sum((col - target) ** 2)

    p = rd.init_params(tree)
    loss, grads = rd.loss_and_grads(loss_sum, p)
    return (rs.sgd_sum(p, grads, TRAIN_LR["esvo"], H * W * 3),
            loss / float(H * W * 3))


def multi_rank(d, device_type):
    """One of MULTI_RANKS ranks sharing the card over gloo ([multi]): on
    the bench world that multi_phase wrote to ``d``, build_world_sharded
    over tile_mesh(4); then, with the launch counts set to 0 just before
    and read just after, the sharded paths: wavefront tile renders (mode
    0 gi-1 and mode 2, interleaved rows), ESVO tile renders (modes 1-3),
    brick renders on grid_mesh(2, 2) (mode 2, mode 0 gi-1), each
    MULTI_WARM + MULTI_TIMED frames, and MULTI_STEPS sharded train steps
    of each kind (ESVO, wavefront K = 2, bricks).  After the window: the
    kernels against their plain versions on this rank's segments, and
    on rank 0 every image and each kind's first step against the
    single-card one.  Writes rank<r>.json (and rank 0 its images, for
    the nccl run) to ``d``."""
    import torch
    import torch.distributed as dist
    from svo_raytracer_torch.diff import render_diff as rd
    from svo_raytracer_torch.diff import wave_diff as wd
    from svo_raytracer_torch.models import procgen
    from svo_raytracer_torch.models import world as world_mod
    from svo_raytracer_torch.ops import shade
    from svo_raytracer_torch.parallel import bricks as B
    from svo_raytracer_torch.parallel import distributed
    from svo_raytracer_torch.parallel import mesh as mesh_mod
    from svo_raytracer_torch.parallel import render_sharded as rs
    from svo_raytracer_torch.parallel import render_wave_sharded as rws
    rank = dist.get_rank()
    dev = distributed.rank_device(dist.get_backend(), device_type)
    blob = _multi_world(d, dev)
    ws, tree, cam5, bs = (blob["ws"], blob["tree"], blob["cam5"],
                          blob["bricks"])
    packed = tree.packed_table()
    m = mesh_mod.tile_mesh(MULTI_RANKS, device_type)
    grid = mesh_mod.grid_mesh(*MULTI_GRID, device_type)
    out = dict(rank=rank, device=str(dev))

    # ---- build_world_sharded: the bench world's chunks over the ranks
    t0 = time.perf_counter()
    size = ws.world_size
    w = world_mod.build_world_sharded(
        size, size // 2, lambda o: procgen.generate_chunk(o, size // 2,
                                                          device=dev),
        m, world_offset=(0, -size // 2, 0))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["build_equal"] = (w.n_nodes == tree.n_nodes and all(
        torch.equal(a, b) for a, b in zip(w.arrays(), tree.arrays())))
    out["build_nodes"] = w.n_nodes
    del w
    torch.cuda.empty_cache()

    dbs = bs.to_device(dev, grid)
    # targets of the train steps, 0.8 x the untrained images (before the
    # counts are set to 0)
    p_esvo = rd.init_params(tree)
    t_esvo = 0.8 * rd.render_diff(p_esvo, tree, cam5, W, H, packed=packed)
    dirs = rd.d_unit(shade.pixel_dirs_device(cam5, W, H))
    t_wave = 0.8 * wd.render_wave_diff(wd.init_params(ws), ws,
                                       cam5[0].expand_as(dirs), dirs,
                                       2).reshape(H, W, 3)
    del dirs
    dist.barrier()

    # ---- the main path, the counts set to 0 just before
    reset_counts()
    images, ms, stats = {}, {}, []
    wave = {mode: rws.make_wave_sharded_render(m, ws, W, H, render_mode=mode,
                                               gi_bounces=1)
            for mode in (0, 2)}
    for mode, render in wave.items():
        def frame(i, render=render, mode=mode):
            images[f"wave mode {mode}"], n_left = render(
                ws, cam5, 1, stats=stats if (mode == 0 and i == 0) else None)
            out.setdefault("n_left", {})[f"wave mode {mode}"] = n_left
        ms[f"wave mode {mode}"] = frame_ms(frame, MULTI_WARM, MULTI_TIMED)
    for mode in (1, 2, 3):
        render = rs.make_sharded_render(m, W, H, render_mode=mode)

        def frame(i, render=render, mode=mode):
            images[f"esvo mode {mode}"] = render(tree, cam5, packed)
        ms[f"esvo mode {mode}"] = frame_ms(frame, MULTI_WARM, MULTI_TIMED)
    for mode in (2, 0):
        render = B.make_brick_render(grid, bs, W, H, render_mode=mode,
                                     frame_number=1, gi_bounces=1)

        def frame(i, render=render, mode=mode):
            images[f"bricks mode {mode}"] = render(dbs, cam5)
        ms[f"bricks mode {mode}"] = frame_ms(frame, MULTI_WARM, MULTI_TIMED)
    steps = dict(
        esvo=(rs.make_sharded_train_step(m, W, H, lr=TRAIN_LR["esvo"]),
              lambda p: steps["esvo"][0](p, tree, cam5, t_esvo, packed),
              p_esvo),
        wave=(wd.make_wave_sharded_train_step(m, ws, W, H, K=2,
                                              lr=TRAIN_LR["wave"]),
              lambda p: steps["wave"][0](p, cam5, t_wave),
              wd.init_params(ws)),
        bricks=(B.make_brick_train_step(grid, bs, W, H,
                                        lr=TRAIN_LR["esvo"]),
                lambda p: steps["bricks"][0](p, dbs, cam5, t_esvo),
                rd.init_params(tree)))
    first, trained = {}, {}
    for kind, (_, step, p) in steps.items():
        losses, times = [], []
        for i in range(MULTI_STEPS):
            t1 = time.perf_counter()
            p, loss = step(p)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss))
            if i == 0 and rank == 0:
                first[kind] = p
        ms[f"train {kind}"] = (float(np.median(times[1:])), times)
        out.setdefault("losses", {})[kind] = losses
        trained[kind] = [_multi_digest(t) for t in p]
        del p
    torch.cuda.synchronize()
    out["launches"] = read_counts()
    out["ms"] = {k: v[0] for k, v in ms.items()}
    out["times"] = {k: v[1] for k, v in ms.items()}
    out["image_digest"] = {k: _multi_digest(v) for k, v in images.items()}
    out["param_digest"] = trained

    # ---- where a rank's time goes: the collectives alone, host clock
    # around each (synchronized), on tensors of the paths' shapes
    def coll_ms(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(times))

    band = torch.zeros((H // MULTI_RANKS, W, 3), device=dev)
    out["collective_ms"] = {
        "image all_gather": coll_ms(lambda: m.all_gather(band, "tiles"),
                                    MULTI_TIMED)}
    del band
    for kind, (alb, den) in (("esvo", rd.init_params(tree)),
                             ("wave", wd.init_params(ws))):
        out["collective_ms"][f"{kind} gradient psum"] = coll_ms(
            lambda alb=alb, den=den: (m.psum(alb, "tiles", inplace=True),
                                      m.psum(den, "tiles", inplace=True)), 1)
    del alb, den

    # ---- the kernels against their plain versions on this rank's rays
    row0, rows = rs.row_band(m, H)
    esvo_rays = rs.band_rays(cam5, W, H, row0, rows, shade._normalize)
    out["kernel_err"] = _multi_kernel_checks(
        ws, tree, packed, dbs, [dict(s) for s in stats[:2]], esvo_rays)
    del stats

    # ---- rank 0: images and first steps against the single card
    if rank == 0:
        refs = blob["refs"]
        cmp = {}
        for k in ("wave mode 0", "wave mode 2"):
            cmp[k] = _frame_share(images[k], refs[k], MULTI_FRAME_TOL)
        for k in ("esvo mode 1", "esvo mode 2", "esvo mode 3"):
            cmp[k] = _frame_share(images[k], refs[k], ESVO_TOL)
        a, b = images["bricks mode 2"], refs["esvo mode 2"]
        close = torch.isclose(a, b, rtol=1e-4, atol=2e-4).all(-1)
        cmp["bricks mode 2"] = (float(close.float().mean()),
                                float((a == b).all(-1).float().mean()),
                                float((a - b).abs().max()))
        a, b = images["bricks mode 0"], refs["esvo mode 0"]
        close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).all(-1)
        cmp["bricks mode 0"] = (float(close.float().mean()),
                                float((a == b).all(-1).float().mean()),
                                float((a - b).abs().max()))
        out["vs_single"] = cmp
        torch.save({k: images[k].cpu() for k in images
                    if not k.startswith("bricks")},
                   os.path.join(d, "gloo_images.pt"))
        del images
        refs_step = dict(
            esvo=lambda: rd.train_step(rd.init_params(tree), tree, cam5,
                                       t_esvo, W, H, lr=TRAIN_LR["esvo"],
                                       packed=packed),
            wave=lambda: wd.make_wave_train_step(
                ws, W, H, K=2, lr=TRAIN_LR["wave"])(wd.init_params(ws), cam5,
                                                     t_wave),
            bricks=lambda: _local_brick_step(bs, dev, tree, cam5, t_esvo),
            monolith=lambda: rd.train_step(rd.init_params(tree), tree, cam5,
                                           t_esvo, W, H, lr=TRAIN_LR["esvo"],
                                           packed=packed))
        first["monolith"] = first["bricks"]
        out["losses"]["monolith"] = out["losses"]["bricks"]
        out["step_vs_single"] = {}
        for kind, ref in refs_step.items():
            q, loss = ref()
            rec = dict(loss=float(loss), sharded_loss=out["losses"][kind][0])
            for f, a, b in zip(q._fields, first[kind], q):
                diff = (a - b).abs()
                at = int(diff.argmax())
                rec[f] = dict(max_abs_diff=float(diff.max()),
                              over_atol=int((diff > STEP_ATOL).sum()),
                              worst=[at, float(a.reshape(-1)[at]),
                                     float(b.reshape(-1)[at])])
            out["step_vs_single"][kind] = rec
            del q
        del out["losses"]["monolith"], first
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()


def multi_nccl(d, device_type):
    """The [multi] renders once more at world size 1 over nccl (the
    backend of one card per rank): wavefront modes 0 gi-1 and 2, ESVO
    modes 1-3, each against the single-card image and the 4-rank gloo
    image, counts set to 0 before and read after.  Writes nccl.json."""
    import torch
    import torch.distributed as dist
    from svo_raytracer_torch.parallel import distributed
    from svo_raytracer_torch.parallel import mesh as mesh_mod
    from svo_raytracer_torch.parallel import render_sharded as rs
    from svo_raytracer_torch.parallel import render_wave_sharded as rws
    dev = distributed.rank_device(dist.get_backend(), device_type)
    blob = _multi_world(d, dev)
    ws, tree, cam5, refs = (blob["ws"], blob["tree"], blob["cam5"],
                            blob["refs"])
    packed = tree.packed_table()
    gloo = torch.load(os.path.join(d, "gloo_images.pt"), map_location=dev)
    m = mesh_mod.tile_mesh(1, device_type)
    out = dict(backend=dist.get_backend(), world_size=dist.get_world_size())
    reset_counts()
    images = {}
    for mode in (0, 2):
        images[f"wave mode {mode}"], n_left = rws.make_wave_sharded_render(
            m, ws, W, H, render_mode=mode, gi_bounces=1)(ws, cam5, 1)
        out.setdefault("n_left", {})[f"wave mode {mode}"] = n_left
    for mode in (1, 2, 3):
        images[f"esvo mode {mode}"] = rs.make_sharded_render(
            m, W, H, render_mode=mode)(tree, cam5, packed)
    torch.cuda.synchronize()
    out["launches"] = read_counts()
    out["vs_single"] = {k: _frame_share(v, refs[k], MULTI_FRAME_TOL
                                        if k.startswith("wave") else ESVO_TOL)
                        for k, v in images.items()}
    out["equal_gloo"] = {k: bool(torch.equal(v, gloo[k]))
                         for k, v in images.items()}
    with open(os.path.join(d, "nccl.json"), "w") as f:
        json.dump(out, f)


def multi_phase(dev, ws, tree, packed, cam5):
    """[multi]: the multi-device layer (svo_raytracer_torch/parallel,
    models/world.build_world_sharded, wave_diff.make_wave_sharded_train_
    step) on the bench world at 1920x1080, as MULTI_RANKS ranks sharing
    the card over gloo (torch.multiprocessing spawn, a FileStore), then
    one rank over nccl.  The parent renders the single-card references
    (render_frame_wavefront modes 0 gi-1 and 2, render_image modes 0
    gi-1 and 1-3), splits the octree into 8 bricks (split_bricks level
    1) and hands the world to the ranks in one file under
    svo_raytracer_torch/_build/multi/, so no rank rebuilds it
    (multi_rank, multi_nccl).  Gates: the sharded build equal to the
    serial world in every array on every rank; n_left 0; wavefront
    frames within MULTI_FRAME_TOL of the single card's on >=
    MULTI_FRAME_SHARE of pixels; ESVO frames within ESVO_TOL everywhere;
    brick frames at the JAX package's bars against the monolith (mode 2
    close at rtol 1e-4 / atol 2e-4 on > 0.99 and within 0.35; mode 0
    close at 1e-3 on > 0.98); every rank the same images and parameters;
    falling losses; each kind's first step against the single card's
    (loss rtol 1e-5, parameters atol 1e-5; the brick step's traces every
    brick on one card, and the monolith's step is reported beside it);
    K1, its keys and KE equal to
    their plain versions on every rank; every path's kernels launched;
    the nccl frames equal to the gloo ones (and the single card's ESVO
    frames).  Returns (summary, launches summed over the ranks and the
    nccl run, the largest kernel errors)."""
    import torch
    from svo_raytracer_torch.ops import kernel_build, render_wave, shade
    from svo_raytracer_torch.parallel import bricks as B
    from svo_raytracer_torch.parallel import distributed
    t0 = time.time()
    d = kernel_build.BUILD_DIR / "multi"
    d.mkdir(parents=True, exist_ok=True)
    refs = {}
    for mode in (0, 2):
        refs[f"wave mode {mode}"] = render_wave.render_frame_wavefront(
            ws, cam5, W, H, render_mode=mode, frame_number=1,
            gi_bounces=1)[0]
    for mode in (0, 1, 2, 3):
        refs[f"esvo mode {mode}"] = shade.render_image(
            tree, cam5, W, H, render_mode=mode, frame_number=1,
            gi_bounces=1, packed=packed)[0]
    t1 = time.time()
    bs = B.split_bricks(tree, level=1)
    split_s = time.time() - t1
    t1 = time.time()
    torch.save(dict(ws=ws, tree=tree, cam5=cam5, bricks=bs, refs=refs),
               d / "world.pt")
    write_s = time.time() - t1
    say(f"[multi] single-card references rendered; split_bricks(level=1) "
        f"{split_s:.1f} s on the host (8 bricks of {bs.capacity} slots, "
        f"{int(bs.n_nodes.sum())} nodes); world file "
        f"{(d / 'world.pt').stat().st_size / 2**20:.0f} MiB in "
        f"{write_s:.1f} s")
    del refs, bs
    torch.cuda.empty_cache()
    t1 = time.time()
    distributed.spawn(multi_rank, MULTI_RANKS, "gloo", dev.type,
                      (str(d), dev.type))
    gloo_s = time.time() - t1
    ranks = []
    for r in range(MULTI_RANKS):
        with open(d / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    t1 = time.time()
    distributed.spawn(multi_nccl, 1, "nccl", dev.type, (str(d), dev.type))
    nccl_s = time.time() - t1
    with open(d / "nccl.json") as f:
        nccl = json.load(f)
    (d / "world.pt").unlink()

    r0 = ranks[0]
    say(f"[multi] {MULTI_RANKS} ranks share one card over gloo "
        f"({gloo_s:.1f} s with spawning), then 1 rank over nccl "
        f"({nccl_s:.1f} s); build_world_sharded over tile_mesh(4): "
        f"{r0['build_nodes']} nodes, equal to the serial world on ranks "
        f"{[r['rank'] for r in ranks if r['build_equal']]}, "
        f"{[round(r['build_s'], 3) for r in ranks]} s per rank")
    for r in ranks:
        say(f"[multi rank {r['rank']}] host-clock medians, ms (ranks "
            f"sharing one card: not a scaling figure): "
            f"{json.dumps({k: round(v, 3) for k, v in r['ms'].items()})}; "
            f"the collectives alone {json.dumps(r['collective_ms'])}; "
            f"launches {r['launches']}; kernels vs plain max err "
            f"{r['kernel_err']}")
    say(f"[multi] n_left {r0['n_left']}; losses {r0['losses']}")
    say(f"[multi] vs the single card (share within tolerance, share "
        f"exactly equal, max |diff|): {json.dumps(r0['vs_single'])}")
    say(f"[multi] first train step vs the single card's: "
        f"{json.dumps(r0['step_vs_single'])}")
    say(f"[multi nccl] world size {nccl['world_size']} over "
        f"{nccl['backend']}: n_left {nccl['n_left']}; equal to the gloo "
        f"frames {nccl['equal_gloo']}; vs the single card "
        f"{json.dumps(nccl['vs_single'])}; launches {nccl['launches']}")
    fails = []
    for r in ranks:
        if not r["build_equal"]:
            fails.append(f"rank {r['rank']}: sharded build differs")
        for k in ("image_digest", "param_digest"):
            if r[k] != r0[k]:
                fails.append(f"rank {r['rank']}: {k} differs from rank 0")
        for k, n in r["launches"].items():
            if k in ("K1_explicit", "K1_keys", "KE", "KE_binned") and n < 1:
                fails.append(f"rank {r['rank']}: {k} never launched")
    for k, v in list(r0["n_left"].items()) + list(nccl["n_left"].items()):
        if v:
            fails.append(f"n_left {k} = {v}")
    for k, (share, _, dmax) in r0["vs_single"].items():
        bar = {"bricks mode 2": 0.99, "bricks mode 0": 0.98}.get(
            k, MULTI_FRAME_SHARE if k.startswith("wave") else 1.0)
        if share < bar or (k == "bricks mode 2" and dmax >= 0.35):
            fails.append(f"{k} vs the single card: {share} < {bar}")
    for kind, losses in r0["losses"].items():
        if not all(b < a for a, b in zip(losses, losses[1:])):
            fails.append(f"train {kind}: losses {losses}")
    for kind, s in r0["step_vs_single"].items():
        if kind != "monolith" and (
                abs(s["sharded_loss"] - s["loss"]) > 1e-5 * abs(s["loss"])
                or s["albedo"]["over_atol"] or s["density"]["over_atol"]):
            fails.append(f"train {kind} vs the single card: {s}")
    for k, eq in nccl["equal_gloo"].items():
        if not eq:
            fails.append(f"nccl {k} differs from the gloo frame")
    for k, (share, _, _) in nccl["vs_single"].items():
        if share < (MULTI_FRAME_SHARE if k.startswith("wave") else 1.0):
            fails.append(f"nccl {k} vs the single card: {share}")
    if fails:
        raise AssertionError(f"[multi]: {fails}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                + nccl["launches"][k] for k in r0["launches"]}
    errs = {k: max(r["kernel_err"][k] for r in ranks)
            for k in r0["kernel_err"]}
    say(f"[multi] launches over the ranks and the nccl run {launches}")
    say(f"[multi] phase took {time.time() - t0:.1f} s")
    summary = dict(ranks=ranks, nccl=nccl, gloo_s=gloo_s, nccl_s=nccl_s,
                   split_s=split_s, launches=launches, kernel_err=errs)
    return summary, launches, errs


def sampled_rays(ws, cam5):
    """16,384 rays of the world: 8,192 sampled primaries and 8,192 bounce
    rays from their hits (directions on the hemisphere of the normal)."""
    import torch
    from svo_raytracer_torch.ops import render_wave
    from svo_raytracer_torch.ops import wavefront as wf
    dev = cam5.device
    gen = np.random.default_rng(SEED)
    origins, dirs, _, _ = render_wave._frame_rays(cam5, W, H)
    pick = torch.from_numpy(gen.choice(dirs.shape[0], 8192,
                                       replace=False)).to(dev)
    prim = wf.intersect_wavefront(ws, origins[pick], dirs[pick])
    hits = torch.nonzero(prim.hit).flatten()
    src = hits[torch.from_numpy(gen.integers(0, hits.numel(), 8192)).to(dev)]
    rd = torch.from_numpy(gen.normal(size=(8192, 3)).astype(np.float32)
                          ).to(dev)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    nrm = torch.nan_to_num(prim.normal[src])
    rd = torch.where((rd * nrm).sum(-1, keepdim=True) < 0, -rd, rd)
    return (torch.cat([origins[pick], prim.voxel_pos[src]]).contiguous(),
            torch.cat([dirs[pick], rd]).contiguous())


def compare_segments(ws, cam5, bounces):
    """K1 vs trace_plain on every segment of a gi-``bounces`` frame, as
    explicit rays in key order; bounce segment 1 in frame order too."""
    import torch
    from svo_raytracer_torch.ops import render_wave, rng, shade
    say(f"[segments {ws.world_size}] K1 vs trace_plain per segment of a "
        f"gi-{bounces} frame")
    dev = cam5.device
    origins, dirs, px, py = render_wave._frame_rays(cam5, W, H)
    rand = rng.pixel_rand(px, py, 2)
    B = dirs.shape[0]
    accum = torch.zeros((B, 3), device=dev)
    mask = torch.ones((B, 3), device=dev)
    depth = torch.full((B,), -1.0, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    o, d = origins, dirs
    out = []
    for seg in range(bounces + 1):
        a = Agreement(ws, f"segment {seg}", o.contiguous(), d.contiguous(),
                      None if seg == 0 else active, frame_order=seg == 1)
        out.append(a)
        accum, mask, depth, iters, active, o, d = shade.gi_update(
            seg == 0, (), accum, mask, depth, iters, active, o, d, rand,
            a.res_k)
    return out


def profile_window(tag, render, kernels, unprof_ms):
    """Device time of PROFILED_FRAMES frames ``render(i)`` from a
    torch.profiler trace (written to svo_raytracer_torch/_build/profile/):
    device kernels per frame, device busy (the union of kernel, memcpy and
    memset intervals), the time of each kernel of ``kernels`` (label ->
    kernel-name substring), the largest kernels, and the idle share of
    the host-timed profiled span; and the share of the host's kernel
    launches whose device records the trace holds (below 1, the numbers
    miss work: see the note above device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PROFILED_FRAMES):
            render(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FRAMES
    ev = trace_events(prof, tag)
    launches = sum(is_launch(e) for e in ev)
    ev = [e for e in ev if not is_launch(e)]
    if not ev:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in ev):
        if b > end:
            busy += b - max(a, end)
            end = b
    per = {}
    for e in ev:
        if e["cat"] == "kernel":
            per[e["name"]] = per.get(e["name"], 0.0) + e["dur"]
    n = PROFILED_FRAMES
    busy_ms = busy / 1e3 / n
    nk = sum(e["cat"] == "kernel" for e in ev) / n
    kms = {k: sum(v for name, v in per.items() if sub in name) / 1e3 / n
           for k, sub in kernels.items()}
    held = sum(e["cat"] == "kernel" for e in ev) / max(launches, 1)
    out = dict(profiled_wall_ms=wall, device_busy_ms=busy_ms,
               kernels_per_frame=nk, idle_share=1.0 - busy_ms / wall,
               kernel_records_held=held,
               **{f"{k.lower().replace(' ', '_')}_ms": v
                  for k, v in kms.items()})
    shares = "; ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%} of busy)"
                       for k, v in kms.items())
    say(f"[profile {tag}] {n} frames: {nk:.0f} device kernels/frame; device "
        f"busy {busy_ms:.3f} ms/frame; {shares}; profiled span {wall:.3f} "
        f"ms/frame, idle share {1.0 - busy_ms / wall:.3f}; busy / "
        f"unprofiled median frame {busy_ms / unprof_ms:.3f}; kernel "
        f"records held {held:.4f} of the {launches} launches")
    for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
        say(f"    {v / 1e3 / n:8.3f} ms/frame  {k[:100]}")
    return out


def profile_frames(ws, cam5, configs, frames):
    """profile_window over the world's wavefront frames (K1's share)."""
    from svo_raytracer_torch.ops import render_wave
    return {label: profile_window(
        f"{ws.world_size} {label}",
        lambda i, kw=kw: render_wave.render_frame_wavefront(
            ws, cam5, W, H, frame_number=i + 2, **kw),
        {"K1": "wf_trace_kernel", "K1 keys": "ray_key", "sort": "RadixSort"},
        frames[label]["ms"])
        for label, (kw, _, _) in configs.items()}


def check_attr16(dev, scene, ws, rays):
    """prepare(attr16=True) of the same world, traced on the same rays:
    hit, value, depth and the finite normals equal the int32 scene's."""
    import torch
    from svo_raytracer_torch.ops import wavefront as wf
    ws16 = prepare_world(dev, scene, attr16=True)
    a = wf.intersect_wavefront(ws, *rays)
    b = wf.intersect_wavefront(ws16, *rays)
    h = a.hit
    fin = torch.isfinite(a.normal) & torch.isfinite(b.normal)
    ok = dict(
        hit=bool(torch.equal(a.hit, b.hit)),
        value=bool(torch.equal(a.value[h], b.value[h])),
        depth=bool(torch.equal(a.depth[h], b.depth[h])),
        normal=bool(torch.equal(torch.isfinite(a.normal),
                                torch.isfinite(b.normal))
                    and torch.allclose(a.normal[fin], b.normal[fin])))
    say(f"[attr16 {scene.world_size}] {int(h.sum())} hits of "
        f"{h.numel()} rays; equal to int32: {ok}; attr_comb "
        f"{ws16.attr_comb.numel() * 2} B vs {ws.attr_comb.numel() * 4} B")
    if not all(ok.values()):
        raise AssertionError(f"attr16 differs from int32: {ok}")


def kernel_entry(name, source, replaces, launches, timed_checks,
                 all_checks):
    """A kernel's line of the kernels table: times are the means over
    ``timed_checks`` (``ms`` the kernel's device time, device_ms;
    ``call_ms`` per call by CUDA events), the bound that of their mean
    bytes and operations, max_abs_err the largest over ``all_checks``.
    No PyTorch call computes what the port's kernels compute, so
    library_ms is null."""
    bound_ms, bound_by = bound(np.mean([c.nbytes for c in timed_checks]),
                               np.mean([c.ops for c in timed_checks]))
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(c.err for c in all_checks),
        ms=float(np.mean([c.ms for c in timed_checks])),
        call_ms=float(np.mean([c.call_ms for c in timed_checks])),
        plain_ms=float(np.mean([c.plain_ms for c in timed_checks])),
        bound_ms=float(bound_ms), bound_by=bound_by, library_ms=None)


def build_kernels():
    """Build K1, KE, K2 and K3 from csrc/, one nvcc each, all started
    together; prints each kernel's build-and-load seconds and ptxas's
    registers, shared memory and spills."""
    import concurrent.futures as cf
    from svo_raytracer_torch.ops import brick_dda, brick_pallas, traverse
    from svo_raytracer_torch.ops import wavefront as wf

    def load(k):
        t0 = time.time()
        k.load()
        return time.time() - t0

    t0 = time.time()
    ks = (wf.K1, traverse.KE, brick_dda.K2, brick_pallas.K3)
    with cf.ThreadPoolExecutor(len(ks)) as ex:
        secs = list(ex.map(load, ks))
    for k, sec in zip(ks, secs):
        say(f"[build] {k.name} built and loaded in {sec:.1f} s")
        for line in k.build_log().splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                say(f"  ptxas {k.name}: {line.strip()}")
    say(f"[build] all four in {time.time() - t0:.1f} s")


def add_viewer_launches(kernels, launches, checks):
    """The viewer sessions' launches into the kernels lines of the bench
    world they ran on: the wavefront session's K1 explicit and camera
    launches into the bench world's K1 (a) and (b) lines, the ESVO
    session's KE launches into the 1024^3 KE lines (the plain schedule's
    and the binned bounces'), with the edit checks' largest error."""
    wl, el = launches["wavefront"], launches["esvo"]
    add_launches(kernels, "viewer", (
        ("K1 wavefront traversal (a) flat L0, bench world",
         wl["K1_explicit"], checks["K1"]),
        ("K1 wavefront traversal (b) camera-mode primaries on (a) flat "
         "L0, bench world", wl["K1_camera"], []),
        ("KE per-ray ESVO traversal, 1024^3 octree, mode-2",
         el["KE"] - el["KE_binned"], checks["KE"]),
        ("KE per-ray ESVO traversal, 1024^3 octree, cone-traced",
         el["KE_binned"], [])))


class Err:
    """A check known by its largest error alone (the [multi] ranks'),
    for add_launches and kernel_entry."""

    def __init__(self, err):
        self.err = err


def add_launches(kernels, tag, adds):
    """For each (name prefix, launches, checks) of ``adds``: the launches
    into the one kernels line of that prefix, kept there as
    ``<tag>_launches``, and the checks' largest error into its
    max_abs_err."""
    for prefix, n, held in adds:
        line = [k for k in kernels if k["name"].startswith(prefix)]
        if len(line) != 1:
            raise AssertionError(f"no single kernels line {prefix!r}")
        line[0]["launches"] += n
        line[0][f"{tag}_launches"] = n
        line[0]["max_abs_err"] = max([line[0]["max_abs_err"]]
                                     + [c.err for c in held])


def print_ranking(kernels, order_ms):
    """Each kernels line's launches x (ms - bound_ms), ms the kernel's
    device time, and K1's total with its ray ordering: its traversal
    lines plus ``order_ms``, the main path's explicit segments times the
    device time of their keys + sort (profiled together, so the key
    kernel's own line is not added again)."""
    rank = {k["name"]: k["launches"] * (k["ms"] - k["bound_ms"])
            for k in kernels}
    k1 = sum(v for n, v in rank.items() if n.startswith("K1 wavefront"))
    ke = sum(v for n, v in rank.items() if n.startswith("KE per-ray"))
    say(f"[ranking] launches x (device ms - bound_ms): {json.dumps(rank)}")
    say(f"[ranking] K1 {k1:.1f} ms; ordering (keys + torch.sort on every "
        f"explicit segment) {order_ms:.1f} ms; K1 with its ordering "
        f"{k1 + order_ms:.1f} ms")
    say(f"[ranking] KE {ke:.1f} ms; ordering (keys + sort per segment) 0.0 "
        f"ms: every segment takes the cached tile permutation; KE with its "
        f"ordering {ke:.1f} ms; K3 takes the same permutation, K2 ray "
        f"order")
    by_call = {k["name"]: k["launches"] * (k["call_ms"] - k["bound_ms"])
               for k in kernels}
    say(f"[ranking] by CUDA events per call, launches x (call ms - "
        f"bound_ms): {json.dumps(by_call)}")


def print_grids(ws):
    """K1's persistent launch (resident blocks per SM, SMs, threads,
    grid) for the world's layout, explicit and camera mode."""
    from svo_raytracer_torch.ops import wavefront as wf
    out = {m: wf.launch_info(ws, camera=m == "camera")
           for m in ("explicit", "camera")}
    say(f"[grid {ws.world_size}] K1 persistent launch: {out}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_scene, render_wave
    from svo_raytracer_torch.ops import wavefront as wf

    t_start = time.time()
    dev = torch.device("cuda")
    # ---- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say(f"[device] {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    build_kernels()

    # ---- bench.py's world first: its main path and its checks
    summary, kernels = {}, []
    (summary["bench_world"], bench_kernels, bench_key_launches,
     bench_keys, bench_order_ms, world) = bench_world_phase(dev)
    kernels += bench_kernels
    # ---- the differentiable renderers' train steps on the same world
    summary["train"], train_kernels, train_key_launches, train_keys = \
        train_phase(dev, *world)
    kernels += train_kernels
    # ---- the viewer and its edit path on the same world
    summary["viewer"], viewer_launches, viewer_checks = viewer_phase(
        dev, world[0])
    # ---- the rest of the single-card API on the same world
    summary["api"], api_kernels, api_k1, api_keys = api_phases(dev, *world)
    kernels += api_kernels
    add_launches(kernels, "api", (
        ("K1 wavefront traversal (a) flat L0, bench world", api_k1, []),))
    # ---- the multi-device layer on the same world: ranks sharing the card
    summary["multi"], multi_n, multi_err = multi_phase(dev, *world)
    add_launches(kernels, "multi", (
        ("K1 wavefront traversal (a) flat L0, bench world",
         multi_n["K1_explicit"], [Err(multi_err["K1"])]),
        ("KE per-ray ESVO traversal, bench world 1024^3 octree: staged",
         multi_n["KE"], [Err(multi_err["KE"])]),
        ("KE per-ray ESVO traversal, bench world 1024^3 octree: beams",
         multi_n["KE_binned"], [])))
    del world

    # ---- kernel vs plain on the test scenes (flat G = 2, G = 64, paged)
    say("[compare] K1 vs trace_plain on the card")
    small = [(n, brick_scene.brickify(build_np.build_octree_np(v)),
              random_rays(4096, seed))
             for n, v, seed in (("sphere-64", sphere_voxels(64, 24), 11),
                                ("terrain-64", terrain_voxels(64, 7), 12))]
    for n, scene in (("g64", g64_scene()),
                     ("paged-4096", sparse_paged_scene())):
        o, d = random_rays(4096, 13)
        ao, ad = aimed_rays(scene, 4096, 13)
        small.append((n, scene, (np.concatenate([o, ao]),
                                 np.concatenate([d, ad]))))
    checks = {}
    for sname, scene, (o, d) in small:
        ws = wf.prepare(scene, dev)
        checks[sname] = Agreement(ws, sname, torch.from_numpy(o).to(dev),
                                  torch.from_numpy(d).to(dev))
    say("[compare] K3 vs brick_pallas.trace_plain on the card")
    k3_small = k3_small_checks(dev, small[:2])

    # ---- the main path on each world (WORLDS), through its part of K1
    key_launches = (bench_key_launches + train_key_launches
                    + viewer_launches["wavefront"]["K1_keys"] + api_keys
                    + multi_n["K1_keys"])
    key_timed = bench_keys[1:2]
    key_all = (bench_keys + train_keys + [c.keys for c in checks.values()]
               + [c.keys for c in viewer_checks["K1"]]
               + [Err(multi_err["K1 keys"])])
    order_ms = bench_order_ms
    for (size, n_range, bounces, n_timed, profiled, part, line,
         small_names, first) in WORLDS:
        scene, ws = build_world(dev, size, n_range)
        grids = print_grids(ws)
        configs = frame_configs(bounces, n_timed, mode2=first)
        cam5, frames, launches, peak = main_path(ws, configs)
        say(f"[compare {size}] K1 vs trace_plain on 16384 sampled rays")
        rays = sampled_rays(ws, cam5)
        sampled = Agreement(ws, "world-16384", *rays)
        # the paged world's plain versions take ~20 s a bounce segment,
        # twice each: its check stops at bounce 1, so that [multi] fits
        seg = compare_segments(ws, cam5, PAGED_COMPARE_BOUNCES if ws.pages
                               else max(bounces))
        # K1 (b): camera mode on the primary segment, against its plain
        # version and against explicit rays (segment 0 above)
        say(f"[camera {size}] K1 camera mode vs trace_camera_plain")
        cam = hold_camera(ws, cam5)
        origins, dirs, _, _ = render_wave._frame_rays(cam5, W, H)
        contract = camera_contract(ws, cam, seg[0], origins, dirs)
        del origins, dirs
        summary[size] = dict(
            frame_ms_median={k: f["ms"] for k, f in frames.items()},
            mrays={k: f["mrays"] for k, f in frames.items()},
            frame_ms={k: f["times"] for k, f in frames.items()},
            segment_ms=[a.ms for a in seg],
            segment_plain_ms=[a.plain_ms for a in seg],
            segment_key_sort_ms=[a.key_sort_ms for a in seg],
            segment_key_sort_device_ms=[a.key_sort_device_ms for a in seg],
            segment_call_ms=[a.call_ms for a in seg],
            segment_key_kernel_ms=[a.keys.ms for a in seg],
            segment_active=[a.active for a in seg],
            segment_g_steps_per_s=[a.rate / a.ms for a in seg],
            bounce1_frame_order_ms=seg[1].frame_ms,
            camera_ms=cam.ms, grids=grids,
            launches=launches, max_memory_allocated=peak,
            camera_vs_explicit=contract)
        key_launches += launches["K1_keys"]
        order_ms += launches["K1_keys"] * float(
            np.mean([a.key_sort_device_ms for a in seg[1:]]))
        key_timed += [a.keys for a in seg[1:]]
        key_all += [a.keys for a in seg + [sampled]]
        if profiled:
            summary[size]["profile"] = profile_frames(ws, cam5, configs,
                                                      frames)
        if ws.pages:
            check_attr16(dev, scene, ws, rays)
        k1_checks = seg + [sampled] + [checks[n] for n in small_names]
        kernels.append(kernel_entry(
            f"K1 wavefront traversal {part}, {size}^3",
            "svo_raytracer_torch/csrc/wavefront.cu",
            f"svo_raytracer_tpu/ops/wavefront.py:{line}",
            launches["K1_explicit"], k1_checks, k1_checks))
        kernels.append(kernel_entry(
            f"K1 wavefront traversal (b) camera-mode primaries on {part}, "
            f"{size}^3", "svo_raytracer_torch/csrc/wavefront.cu",
            "svo_raytracer_tpu/ops/wavefront.py:987",
            launches["K1_camera"], [cam], [cam]))
        if first:
            # the K3 path on the same world, from the same camera
            summary["k3"], k3_entry = k3_phase(
                dev, scene, cam5, frames["mode2"]["depth"], k3_small)
            kernels.append(k3_entry)
            # the ESVO path on the same heightmap, from the same camera
            summary["esvo"], esvo_kernels = esvo_phase(dev, size, cam5, ws)
            kernels += esvo_kernels
        del scene, ws
    kernels.append(dict(kernel_entry(
        "K1 ray keys (direction octant over the origin brick's Morton "
        "code), explicit segments of every world",
        "svo_raytracer_torch/csrc/wavefront.cu",
        "svo_raytracer_tpu/ops/wavefront.py:1920", key_launches, key_timed,
        key_all), tpu_kernel="none: _sort_stage's brick key (XLA glue), "
                             "with OCT_SORT's octant (wavefront.py:1032)"))
    add_viewer_launches(kernels, viewer_launches, viewer_checks)
    print_ranking(kernels, order_ms)
    say(f"[summary] {json.dumps(summary)}")
    say(f"[run] {time.time() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
