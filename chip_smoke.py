#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svo_raytracer_torch) on one GPU.

Drives the port's main path at full size on three seeded heightmap worlds
(value noise, built directly as BrickScenes), each through its own part of
kernel K1, with the camera placed by bench.py's downward-probe rule and
render mode 0 at 1920x1080:

  * 1024^3, flat L0 (G = 32): gi-1 and gi-3 frames;
  * 2048^3, flat L0 with two-word mixed columns (G = 64): gi-1 frames;
  * 4096^3, paged L0 (G = 128, 2^3 pages): gi-1 and gi-3 frames, and the
    same world prepared with half-word (attr16) attributes.

Every world's K1 records are held equal to its plain PyTorch version,
trace_plain, on the card, as are those of the small test scenes (G = 2,
G = 64 and a sparse paged 4096^3 scene) first.

    python3 chip_smoke.py            # needs one CUDA GPU; builds K1 with nvcc

The 1024^3 and 4096^3 frames are also profiled with torch.profiler (device
kernels, device busy, K1's share, idle share per frame); the chrome traces
are left in svo_raytracer_torch/_build/profile/.

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


class Agreement:
    """Kernel vs plain records on one ray set.  The kernel is built to be
    bit-equal to trace_plain (-fmad=false, same float order), so every
    record field (status, t, cell, widx, iters) must be equal on every ray;
    hit agreement and the strict fields of tests/test_wavefront.py::_compare
    on the decoded HitResults are printed as readings."""

    FIELDS = ("status", "t", "cell", "widx", "iters")

    def __init__(self, ws, name, origins, dirs, active=None, reps=3):
        from svo_raytracer_torch.ops import wavefront as wf
        o, d, alive = wf._rays(ws, origins, dirs, active)
        rec_k, self.ms = timed(lambda: wf.trace_kernel(ws, o, d, alive),
                               reps)
        rec_p, self.plain_ms = timed(lambda: wf.trace_plain(ws, o, d, alive),
                                     warm=False)
        k = wf._finish(ws, rec_k, origins, dirs)
        p = wf._finish(ws, rec_p, origins, dirs)
        self.res_k = k
        both = k.hit & p.hit
        self.hit_agree = (k.hit == p.hit).float().mean().item()
        # raw-555 normals are NaN by design in both; NaN == NaN here
        normal_ok = (((k.normal - p.normal).abs() <= 1e-5)
                     | (k.normal.isnan() & p.normal.isnan())).all(-1)
        ok = ((k.value == p.value) & (k.depth == p.depth)
              & ((k.t - p.t).abs() <= 2e-4) & normal_ok)
        nb = int(both.sum())
        self.strict = (ok & both).sum().item() / max(nb, 1)
        diff = {f: int((~((a == b) | (a.isnan() & b.isnan())
                           if a.is_floating_point() else a == b)).sum())
                for f, a, b in zip(self.FIELDS, rec_k, rec_p)}
        self.err = (rec_k[1] - rec_p[1]).abs().nan_to_num().max().item()
        steps = rec_k[4][alive].double()
        say(f"  {name}: rays {o.shape[0]} active {int(alive.sum())} "
            f"hits {nb} unequal {diff} hit_agree {self.hit_agree:.6f} "
            f"strict {self.strict:.6f} max|dt| {self.err:.3e} kernel "
            f"{self.ms:.3f} ms plain {self.plain_ms:.1f} ms; coarse steps "
            f"per ray mean {steps.mean().item():.1f} max "
            f"{int(steps.max().item()) if steps.numel() else 0}, "
            f"{steps.sum().item() / self.ms / 1e6:.3f} G steps/s")
        if any(diff.values()):
            raise AssertionError(f"{name}: kernel record differs from "
                                 f"trace_plain on {diff}")


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


def render_frames(ws, cam5, bounces_list, timed_frames):
    """Mode-0 frames at W x H: one with per-segment stats, then WARM_FRAMES
    and ``timed_frames`` timed alone each (host clock, synchronized).
    Checks the primary hit fraction, finite colour and a K1 launch in
    every segment."""
    import torch
    from svo_raytracer_torch.ops import render_wave
    size = ws.world_size
    frames = {}
    for bounces in bounces_list:
        stats, times = [], []
        col, depth, _ = render_wave.render_frame_wavefront(
            ws, cam5, W, H, render_mode=0, frame_number=1,
            gi_bounces=bounces, stats=stats)
        torch.cuda.synchronize()
        for i in range(WARM_FRAMES + timed_frames):
            t0 = time.perf_counter()
            col, depth, _ = render_wave.render_frame_wavefront(
                ws, cam5, W, H, render_mode=0, frame_number=i + 2,
                gi_bounces=bounces)
            torch.cuda.synchronize()
            if i >= WARM_FRAMES:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        mrays = (bounces + 1) * W * H / (ms * 1e-3) / 1e6
        finite = torch.isfinite(col).all(-1).float().mean().item()
        hitfrac = stats[0]["hits"] / stats[0]["rays"]
        frames[bounces] = dict(ms=ms, mrays=mrays, times=times)
        say(f"[frame {size} gi-{bounces}] {W}x{H}: median {ms:.3f} ms/frame "
            f"of {timed_frames} (min {min(times):.3f}, max {max(times):.3f}; "
            f"{mrays:.2f} Mrays/s, {bounces + 1} segments x W*H rays), "
            f"primary hit fraction {hitfrac:.4f}, finite colour "
            f"{finite:.6f}")
        for i, s in enumerate(stats):
            say(f"  segment {i}: rays {s['rays']} hits {s['hits']} "
                f"ITER_CAP-retired {s['capped']} K1 launches "
                f"{s['launches']}")
        if not 0.05 < hitfrac < 0.95:
            raise AssertionError(f"hit fraction {hitfrac} out of range")
        if finite < 0.999:
            raise AssertionError(f"finite colour on {finite} of pixels")
        if any(s["launches"] < 1 for s in stats):
            raise AssertionError("a segment did not launch K1")
    return frames


def main_path(dev, ws, bounces_list, timed_frames):
    """The main path on one world: camera probe and frames, with K1's
    launch count set to 0 just before and read just after."""
    import torch
    from svo_raytracer_torch.ops import wavefront as wf
    torch.cuda.reset_peak_memory_stats()
    wf.K1.launches = 0
    cam5 = place_camera(ws, dev)
    frames = render_frames(ws, cam5, bounces_list, timed_frames)
    launches = wf.K1.launches
    peak = torch.cuda.max_memory_allocated()
    say(f"[main path {ws.world_size}] K1 launches {launches}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB ({peak} B)")
    if launches < 1:
        raise AssertionError("the main path never launched K1")
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
    """K1 vs trace_plain on every segment of a gi-``bounces`` frame."""
    import torch
    from svo_raytracer_torch.ops import render_wave, rng
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
                      None if seg == 0 else active)
        out.append(a)
        accum, mask, depth, iters, active, o, d = render_wave._gi_update(
            seg == 0, (), accum, mask, depth, iters, active, o, d, rand,
            a.res_k)
    return out


def profile_frames(ws, cam5, frames):
    """Device time of gi-1 and gi-3 frames from a torch.profiler trace
    (written to svo_raytracer_torch/_build/profile/): device kernels per
    frame, device busy (the union of kernel, memcpy and memset intervals),
    K1's time, the largest kernels, and the idle share of the host-timed
    profiled span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from svo_raytracer_torch.ops import kernel_build, render_wave
    outdir = kernel_build.BUILD_DIR / "profile"
    outdir.mkdir(parents=True, exist_ok=True)
    size = ws.world_size
    out = {}
    for bounces in frames:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(PROFILED_FRAMES):
                render_wave.render_frame_wavefront(
                    ws, cam5, W, H, render_mode=0, frame_number=i + 2,
                    gi_bounces=bounces)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED_FRAMES
        path = str(outdir / f"trace_{size}_gi{bounces}.json")
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
        k1_ms = sum(v for k, v in per.items() if "wf_trace_kernel" in k) \
            / 1e3 / n
        nk = sum(e["cat"] == "kernel" for e in ev) / n
        out[f"gi{bounces}"] = dict(
            profiled_wall_ms=wall, device_busy_ms=busy_ms, k1_ms=k1_ms,
            kernels_per_frame=nk, idle_share=1.0 - busy_ms / wall)
        unprof = frames[bounces]["ms"]
        say(f"[profile {size} gi-{bounces}] {n} frames: {nk:.0f} device "
            f"kernels/frame; device busy {busy_ms:.3f} ms/frame; K1 "
            f"{k1_ms:.3f} ms ({k1_ms / busy_ms:.1%} of busy); profiled span "
            f"{wall:.3f} ms/frame, idle share {1.0 - busy_ms / wall:.3f}; "
            f"busy / unprofiled median frame {busy_ms / unprof:.3f}")
        for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
            say(f"    {v / 1e3 / n:8.3f} ms/frame  {k[:100]}")
    return out


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


def kernel_entry(name, replaces, launches, agreements):
    return dict(
        name=name, route="cuda",
        source="svo_raytracer_torch/csrc/wavefront.cu",
        replaces=replaces, launches=launches,
        max_abs_err=max(a.err for a in agreements),
        ms=float(np.mean([a.ms for a in agreements])),
        plain_ms=float(np.mean([a.plain_ms for a in agreements])))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_scene
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

    # ---- build K1 from csrc/
    t0 = time.time()
    wf.K1.load()
    say(f"[build] K1 built and loaded in {time.time() - t0:.1f} s")

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

    # ---- the main path on each world, through its part of K1:
    # (size, n_mixed class, GI bounces, timed frames, profiled, K1 part,
    #  its TPU source line, the small scenes that exercised it above)
    worlds = (
        (1024, (2000, 6000), (1, 3), TIMED_FRAMES, True,    # bench: 4,589
         "(a) flat L0", 891, ("sphere-64", "terrain-64")),
        (2048, (8000, 30000), (1,), BIG_TIMED_FRAMES, False,
         "(c) G=64 two-word mixed columns", 1358, ("g64",)),
        (4096, (30000, 120000), (1, 3), BIG_TIMED_FRAMES, True,
         "(d) paged L0", 1077, ("paged-4096",)))
    summary, kernels = {}, []
    for (size, n_range, bounces, n_timed, profiled, part, line,
         small_names) in worlds:
        scene, ws = build_world(dev, size, n_range)
        cam5, frames, launches, peak = main_path(dev, ws, bounces, n_timed)
        say(f"[compare {size}] K1 vs trace_plain on 16384 sampled rays")
        rays = sampled_rays(ws, cam5)
        sampled = Agreement(ws, "world-16384", *rays)
        seg = compare_segments(ws, cam5, max(bounces))
        summary[size] = dict(
            frame_ms_median={f"gi{b}": frames[b]["ms"] for b in frames},
            mrays={f"gi{b}": frames[b]["mrays"] for b in frames},
            frame_ms={f"gi{b}": frames[b]["times"] for b in frames},
            segment_ms=[a.ms for a in seg],
            segment_plain_ms=[a.plain_ms for a in seg],
            max_memory_allocated=peak)
        if profiled:
            summary[size]["profile"] = profile_frames(ws, cam5, frames)
        if ws.pages:
            check_attr16(dev, scene, ws, rays)
        kernels.append(kernel_entry(
            f"K1 wavefront traversal {part}, {size}^3",
            f"svo_raytracer_tpu/ops/wavefront.py:{line}", launches,
            seg + [sampled] + [checks[n] for n in small_names]))
        del scene, ws
    say(f"[summary] {json.dumps(summary)}")
    say(f"[run] {time.time() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
