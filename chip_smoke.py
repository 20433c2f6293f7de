#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svo_raytracer_torch) on one GPU.

Drives the port's main path at full size on three seeded heightmap worlds
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
trace_plain, on the card, as are those of the small test scenes (G = 2,
G = 64 and a sparse paged 4096^3 scene) first.  K1 traces explicit rays
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
intersect_fn of shade.shade_direct; K3 is held equal to its plain version
(brick_pallas.trace_plain) on the small scenes (also cut at a few rounds)
and on both segments of a frame, and its primary hit mask against the
wavefront mode-2 frame's.

Then the ESVO path runs on the same heightmap and camera: the octree is
built on the card (models/heightmap.generate_chunk_heightmap,
core/build_device), with its packed node table and skip grids at G = 32
and 64, and render_image draws 1920x1080 frames in mode 2 without a skip
grid and with each, and in mode 0 (gi-1) with the G = 32 grid, through
kernels KE (the per-ray ESVO traversal) and K2 (the skip grid's coarse
DDA).  Both are held equal to their plain versions
(traverse.intersect_plain, brick_dda.coarse_dda_plain) on small scenes (KE
also cut at a depth below the trees' and cone-traced), on sampled rays of
the world and on every segment of each skip-grid frame, KE in the order
the render traces it (the image's 8x4 pixel tiles; the mode-0 bounce in
the binned schedule, and again in ray order).  KE's two kernels-line
entries split its launches: mode-2 segments, and cone-traced bounces.

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
        if a.is_floating_point():
            same = (a == b) | (a.isnan() & b.isnan())
            if a.numel():
                err = max(err, (a - b).abs().nan_to_num().max().item())
        else:
            same = a == b
        diff[f] = int((~same).sum())
    return diff, err


class Held:
    """A kernel against its plain version on one input set: every field of
    the (dict) records equal on every ray, NaN equal to NaN.  Times the
    kernel by CUDA events (ms per launch) and its plain version once.
    ``bound_ms`` is the least time for the set's own work: ``ray_bytes``
    (ray inputs and records, once) plus the distinct words of ``tables``
    that the plain version gathers (counted on a second, untimed run), and
    the steps times OPS_PER_STEP."""

    def __init__(self, kname, name, kernel, plain, ray_bytes, tables, steps,
                 reps=3):
        rec_k, self.ms = timed(kernel, reps)
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
            f"{self.ms:.3f} ms plain {self.plain_ms:.1f} ms bound "
            f"{self.bound_ms:.4f} ms ({self.bound_by})")
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
    and times the keys and their sort (``key_sort_ms``) apart from K1.
    With ``frame_order``, K1 also runs over the rays in frame order, held
    to the same records and timed (``frame_ms``).  Keeps the kernel's
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
            f"+ sort {self.key_sort_ms:.4f} ms")
        self.frame_ms = None
        if frame_order:
            rec_f, self.frame_ms = timed(record(wf.trace_kernel, None), reps)
            diff, _ = unequal(rec_f, self.rec_p)
            say(f"    K1 in frame order {self.frame_ms:.4f} ms, "
                f"{rate / self.frame_ms:.3f} G steps/s; unequal fields "
                f"{ {f: n for f, n in diff.items() if n} or 0}; key order "
                f"{self.frame_ms / self.ms:.3f}x faster, "
                f"{self.frame_ms / (self.ms + self.key_sort_ms):.3f}x with "
                f"its keys and sort")
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


def hold_k2(name, tab, G, o, d, alive):
    """K2 vs brick_dda.coarse_dda_plain; steps are the cells visited (the
    crossings plus the cell each live ray starts or stops in)."""
    from svo_raytracer_torch.ops import brick_dda
    o, d, alive = o.contiguous(), d.contiguous(), alive.contiguous()
    return Held("K2", name,
                lambda: brick_dda.coarse_dda_kernel(tab, o, d, G, 3 * G,
                                                    alive),
                lambda: brick_dda.coarse_dda_plain(tab, o, d, G, 3 * G,
                                                   alive),
                o.shape[0] * (12 + 12 + 1 + 4 * 6), [tab],
                lambda r: int(r["steps"].sum()) + int(alive.sum()))


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


def hold_k3(name, scene, o, d, alive, max_rounds=24):
    """K3 vs brick_pallas.trace_plain; steps are the DDA steps over all
    rounds (both phases)."""
    from svo_raytracer_torch.ops import brick_pallas as bp
    o, d, alive = o.contiguous(), d.contiguous(), alive.contiguous()
    return Held("K3", name,
                lambda: bp.trace_kernel(scene, o, d, alive, max_rounds),
                lambda: bp.trace_plain(scene, o, d, alive, max_rounds),
                o.shape[0] * (12 + 12 + 1 + 4 * len(bp.FIELDS)),
                [getattr(scene, f) for f in scene.ARRAYS],
                lambda r: int(r["iters"].sum()))


def k3_small_checks(dev, small):
    """K3 vs its plain version on the small scenes' 4,096 random rays
    (every 50th inactive), then on terrain-64 cut at K3_CUT_ROUNDS rounds.
    Gate: the cut leaves some rays pending that finish with all rounds."""
    import torch
    out, full = [], {}
    for sname, scene, (o, d) in small:
        dscene = scene.to_device(dev)
        ov = ((torch.from_numpy(o) - 1.0) * float(scene.world_size)).to(dev)
        dv = torch.from_numpy(d).to(dev)
        alive = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
        alive[::50] = False
        full[sname] = hold_k3(sname, dscene, ov, dv, alive)
        out.append(full[sname])
        if sname == "terrain-64":
            cut = hold_k3(f"{sname} max_rounds {K3_CUT_ROUNDS}", dscene, ov,
                          dv, alive, K3_CUT_ROUNDS)
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
        times = []
        for i in range(ESVO_WARM_FRAMES + ESVO_TIMED_FRAMES):
            t0 = time.perf_counter()
            render(i + 2)
            torch.cuda.synchronize()
            if i >= ESVO_WARM_FRAMES:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
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
    the binned schedule).  The mode-0 bounce segment is also traced in
    ray order and held to the same records.  Returns ({label: (KE checks,
    K2 checks)}, the bounce's ray-order check).  Gates that K2 marches
    (takes steps) on the G = 64 frame."""
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
        k2 = []
        for n, ((occ, o, d), k) in zip(segs, k2_calls):
            alive = k["active"]
            if alive is None:
                alive = torch.ones(o.shape[0], dtype=torch.bool,
                                   device=o.device)
            k2.append(hold_k2(f"{label} {n} segment", occ, k["grid_size"], o,
                              d, alive))
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
    brick_pallas.intersect_bricks_tpu over the scene on the card (two K3
    launches per frame: primary and shadow).  One frame with per-segment
    stats, then ESVO_WARM_FRAMES and ESVO_TIMED_FRAMES timed alone each,
    with K3's launch count set to 0 just before and read just after; then
    K3 vs its plain version on both segments of a frame, and a profile of
    the frame.  Gates: finite colour on >= 99.9% of pixels and the primary
    hit mask equal to that of the wavefront mode-2 frame (``wave_depth``)
    on >= 99.9% of pixels.  Returns (summary, kernel entry)."""
    import functools
    import torch
    from svo_raytracer_torch.ops import brick_pallas as bp
    from svo_raytracer_torch.ops import shade
    size = scene.world_size
    t0 = time.time()
    dscene = scene.to_device(dev)
    torch.cuda.synchronize()
    nbytes = sum(getattr(dscene, f).numel() * 4 for f in dscene.ARRAYS)
    say(f"[k3 {size}] BrickScene -> {dev} in {time.time() - t0:.1f} s: "
        f"n_mixed {dscene.n_mixed}, table bytes {nbytes}")
    dirs = shade._normalize(shade.pixel_dirs_device(cam5, W, H))
    origins = cam5[0].expand_as(dirs)
    isect = functools.partial(bp.intersect_bricks_tpu, dscene)
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
    more = isect(origins[off], dirs[off], max_rounds=4 * K3_ROUNDS)
    changed = int((more.hit != hit.reshape(-1)[off]).sum())
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
    segs = [hold_k3(f"mode-2 {n} segment", *a, **k)
            for n, (a, k) in zip(("primary", "shadow"), calls)]
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
    nbytes = sum(getattr(ws, f).numel() * getattr(ws, f).element_size()
                 for f in wf.WaveScene.ARRAYS)
    layout = (f"{'paged' if ws.pages else 'flat'} L0, attr_comb "
              f"{'2-D' if ws.attr_comb.dim() == 2 else 'flat'} "
              f"{tuple(ws.attr_comb.shape)} {ws.attr_comb.dtype}")
    say(f"[world {scene.world_size}] prepare{prepare_kw or ''} -> {dev} in "
        f"{time.time() - t0:.1f} s: capacity {ws.capacity}, {layout}, "
        f"table bytes {nbytes}")
    return ws


def place_camera(ws, dev):
    """bench.py's rule: probe 25 columns straight down, take the deepest
    free fall, sit 0.05 above its surface, pitch -0.35, yaw 0.4."""
    import torch
    from svo_raytracer_torch.ops import wavefront as wf
    from svo_raytracer_torch.utils.camera import Camera
    gx = np.linspace(1.2, 1.8, 5, dtype=np.float32)
    pxz = np.stack(np.meshgrid(gx, gx, indexing="ij"), -1).reshape(-1, 2)
    probe_o = np.concatenate([pxz[:, :1], np.full((25, 1), 1.999, np.float32),
                              pxz[:, 1:]], axis=1)
    probe_d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (25, 1))
    probe = wf.intersect_wavefront(ws, torch.from_numpy(probe_o).to(dev),
                                   torch.from_numpy(probe_d).to(dev))
    ts = probe.t.cpu().numpy()
    best = int(np.argmax(ts))
    surf_y = 1.999 - float(ts[best])
    cam = Camera(pos=np.array([probe_o[best, 0], min(surf_y + 0.05, 1.99),
                               probe_o[best, 2]]))
    cam.rotate(-0.35, 0.4)
    say(f"[camera] at y={cam.pos[1]:.4f} (surface {surf_y:.4f})")
    return torch.tensor(cam.uniform(), dtype=torch.float32, device=dev)


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


def main_path(dev, ws, configs):
    """The main path on one world: camera probe and frames, with K1's
    launch counts (and its key kernel's) set to 0 just before and read
    just after.  K1.launches counts both entry points of the library, so
    the explicit-ray entry's launches are K1's less K1_CAMERA's."""
    import torch
    from svo_raytracer_torch.ops import wavefront as wf
    torch.cuda.reset_peak_memory_stats()
    wf.K1.launches = wf.K1_CAMERA.launches = wf.K1_KEYS.launches = 0
    cam5 = place_camera(ws, dev)
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
    the host-timed profiled span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from svo_raytracer_torch.ops import kernel_build
    outdir = kernel_build.BUILD_DIR / "profile"
    outdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PROFILED_FRAMES):
            render(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FRAMES
    path = str(outdir / f"trace_{tag.replace(' ', '_')}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
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
    out = dict(profiled_wall_ms=wall, device_busy_ms=busy_ms,
               kernels_per_frame=nk, idle_share=1.0 - busy_ms / wall,
               **{f"{k.lower().replace(' ', '_')}_ms": v
                  for k, v in kms.items()})
    shares = "; ".join(f"{k} {v:.3f} ms ({v / busy_ms:.1%} of busy)"
                       for k, v in kms.items())
    say(f"[profile {tag}] {n} frames: {nk:.0f} device kernels/frame; device "
        f"busy {busy_ms:.3f} ms/frame; {shares}; profiled span {wall:.3f} "
        f"ms/frame, idle share {1.0 - busy_ms / wall:.3f}; busy / "
        f"unprofiled median frame {busy_ms / unprof_ms:.3f}")
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
    ``timed_checks``, the bound that of their mean bytes and operations,
    max_abs_err the largest over ``all_checks``.  No PyTorch call computes
    what the port's kernels compute, so library_ms is null."""
    bound_ms, bound_by = bound(np.mean([c.nbytes for c in timed_checks]),
                               np.mean([c.ops for c in timed_checks]))
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max(c.err for c in all_checks),
        ms=float(np.mean([c.ms for c in timed_checks])),
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


def print_ranking(kernels, order_ms):
    """Each kernels line's launches x (ms - bound_ms), and K1's total with
    its ray ordering: its traversal lines plus ``order_ms``, the main
    path's explicit segments times their keys + sort ms (timed together,
    so the key kernel's own line is not added again)."""
    rank = {k["name"]: k["launches"] * (k["ms"] - k["bound_ms"])
            for k in kernels}
    k1 = sum(v for n, v in rank.items() if n.startswith("K1 wavefront"))
    ke = sum(v for n, v in rank.items() if n.startswith("KE per-ray"))
    say(f"[ranking] launches x (ms - bound_ms): {json.dumps(rank)}")
    say(f"[ranking] K1 {k1:.1f} ms; ordering (keys + torch.sort on every "
        f"explicit segment) {order_ms:.1f} ms; K1 with its ordering "
        f"{k1 + order_ms:.1f} ms")
    say(f"[ranking] KE {ke:.1f} ms; ordering (keys + sort per segment) 0.0 "
        f"ms: every segment takes the cached tile permutation; KE with its "
        f"ordering {ke:.1f} ms")


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
    summary, kernels = {}, []
    key_launches, key_timed, key_all = 0, [], [c.keys
                                                for c in checks.values()]
    order_ms = 0.0
    for (size, n_range, bounces, n_timed, profiled, part, line,
         small_names, first) in WORLDS:
        scene, ws = build_world(dev, size, n_range)
        grids = print_grids(ws)
        configs = frame_configs(bounces, n_timed, mode2=first)
        cam5, frames, launches, peak = main_path(dev, ws, configs)
        say(f"[compare {size}] K1 vs trace_plain on 16384 sampled rays")
        rays = sampled_rays(ws, cam5)
        sampled = Agreement(ws, "world-16384", *rays)
        seg = compare_segments(ws, cam5, max(bounces))
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
            segment_key_kernel_ms=[a.keys.ms for a in seg],
            segment_active=[a.active for a in seg],
            segment_g_steps_per_s=[a.rate / a.ms for a in seg],
            bounce1_frame_order_ms=seg[1].frame_ms,
            camera_ms=cam.ms, grids=grids,
            launches=launches, max_memory_allocated=peak,
            camera_vs_explicit=contract)
        key_launches += launches["K1_keys"]
        order_ms += launches["K1_keys"] * float(
            np.mean([a.key_sort_ms for a in seg[1:]]))
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
