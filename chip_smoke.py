#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svo_raytracer_torch) on one GPU.

Drives the port's main path once at full size — a 1024^3 heightmap world
(seeded value noise, built directly as a BrickScene), camera placed by
bench.py's downward-probe rule, render mode 0 at 1920x1080 with 1 and then
3 GI bounces — and checks every kernel of that path against its plain
PyTorch version on the card.

    python3 chip_smoke.py            # needs one CUDA GPU; builds K1 with nvcc

A last phase profiles gi-1 and gi-3 frames with torch.profiler (device
kernels, device busy, K1's share, idle share per frame); its chrome traces
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
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 1          # heightmap seed: bench.py's camera rule then sees sky
WORLD = 1024
W, H = 1920, 1080
WARM_FRAMES, TIMED_FRAMES = 2, 20
PROFILED_FRAMES = 5
N_MIXED = (2000, 6000)               # the bench scene class (4,589)


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

    worst_err = 0.0
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
        Agreement.worst_err = max(Agreement.worst_err, self.err)
        say(f"  {name}: rays {o.shape[0]} active {int(alive.sum())} "
            f"hits {nb} unequal {diff} hit_agree {self.hit_agree:.6f} "
            f"strict {self.strict:.6f} max|dt| {self.err:.3e} kernel "
            f"{self.ms:.3f} ms plain {self.plain_ms:.1f} ms")
        if any(diff.values()):
            raise AssertionError(f"{name}: kernel record differs from "
                                 f"trace_plain on {diff}")


def build_world(dev):
    """The smoke scene: a seeded 1024^3 heightmap world, prepared on dev."""
    import torch
    from svo_raytracer_torch.models import bigworld
    from svo_raytracer_torch.ops import wavefront as wf
    t0 = time.time()
    hm, mm = bigworld.fractal_heightmap(WORLD, seed=SEED)
    scene = bigworld.heightmap_brick_scene(hm, mm, WORLD)
    say(f"[world] {WORLD}^3 heightmap scene: n_mixed {scene.n_mixed}, "
        f"built in {time.time() - t0:.1f} s")
    if not N_MIXED[0] <= scene.n_mixed <= N_MIXED[1]:
        raise AssertionError(f"n_mixed {scene.n_mixed} off the bench class")
    t0 = time.time()
    ws = wf.prepare(scene, dev)
    torch.cuda.synchronize()
    say(f"[world] prepare -> {dev} in {time.time() - t0:.1f} s (capacity "
        f"{ws.capacity}, attr_comb {ws.attr_comb.numel()} words)")
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


def profile_frames(ws, cam5, frames):
    """Device time of gi-1 and gi-3 frames from a torch.profiler trace
    (written to svo_raytracer_torch/_build/profile/): device kernels per frame, device busy (the union
    of kernel, memcpy and memset intervals), K1's time, the largest kernels,
    and the idle share of the host-timed profiled span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from svo_raytracer_torch.ops import kernel_build, render_wave
    outdir = kernel_build.BUILD_DIR / "profile"
    outdir.mkdir(parents=True, exist_ok=True)
    out = {}
    for bounces in (1, 3):
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
        path = str(outdir / f"trace_gi{bounces}.json")
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
        say(f"[profile gi-{bounces}] {n} frames: {nk:.0f} device kernels/"
            f"frame; device busy {busy_ms:.3f} ms/frame; K1 {k1_ms:.3f} ms "
            f"({k1_ms / busy_ms:.1%} of busy); profiled span "
            f"{wall:.3f} ms/frame, idle share {1.0 - busy_ms / wall:.3f}; "
            f"busy / unprofiled median frame {busy_ms / unprof:.3f}")
        for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
            say(f"    {v / 1e3 / n:8.3f} ms/frame  {k[:100]}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from svo_raytracer_torch.core import build_np
    from svo_raytracer_torch.ops import brick_scene, render_wave, rng
    from svo_raytracer_torch.ops import wavefront as wf

    dev = torch.device("cuda")
    # ---- phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say(f"[device] {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 2: build K1 from csrc/
    t0 = time.time()
    wf.K1.load()
    say(f"[build] K1 built and loaded in {time.time() - t0:.1f} s")

    # ---- phase 3: kernel vs plain on the test scenes
    say("[compare] K1 vs trace_plain on the card")
    for sname, vox, seed in (("sphere-64", sphere_voxels(64, 24), 11),
                             ("terrain-64", terrain_voxels(64, 7), 12)):
        ws = wf.prepare(brick_scene.brickify(build_np.build_octree_np(vox)),
                        dev)
        o, d = random_rays(4096, seed)
        Agreement(ws, sname, torch.from_numpy(o).to(dev),
                  torch.from_numpy(d).to(dev))

    # ---- phase 4: the main path
    ws = build_world(dev)
    torch.cuda.reset_peak_memory_stats()
    wf.K1.launches = 0
    cam5 = place_camera(ws, dev)

    frames = {}
    for bounces in (1, 3):
        stats, times = [], []
        col, depth, _ = render_wave.render_frame_wavefront(
            ws, cam5, W, H, render_mode=0, frame_number=1,
            gi_bounces=bounces, stats=stats)
        torch.cuda.synchronize()
        for i in range(WARM_FRAMES + TIMED_FRAMES):
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
        say(f"[frame gi-{bounces}] {W}x{H}: median {ms:.3f} ms/frame of "
            f"{TIMED_FRAMES} (min {min(times):.3f}, max {max(times):.3f}; "
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
    main_launches = wf.K1.launches
    peak = torch.cuda.max_memory_allocated()
    say(f"[main path] K1 launches {main_launches}; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    if main_launches < 1:
        raise AssertionError("the main path never launched K1")

    # ---- phase 5: kernel vs plain at the main path's shapes
    say("[compare] K1 vs trace_plain on 16384 sampled rays of the world")
    gen = np.random.default_rng(SEED)
    origins, dirs, px, py = render_wave._frame_rays(cam5, W, H)
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
    so = torch.cat([origins[pick], prim.voxel_pos[src]])
    sd = torch.cat([dirs[pick], rd])
    Agreement(ws, "world-16384", so.contiguous(), sd.contiguous())

    say("[segments] K1 vs trace_plain per segment of a gi-3 frame")
    rand = rng.pixel_rand(px, py, 2)
    B = dirs.shape[0]
    accum = torch.zeros((B, 3), device=dev)
    mask = torch.ones((B, 3), device=dev)
    depth = torch.full((B,), -1.0, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    o, d = origins, dirs
    seg_ms, seg_plain = [], []
    for seg in range(4):
        a = Agreement(ws, f"segment {seg}", o.contiguous(), d.contiguous(),
                      None if seg == 0 else active)
        seg_ms.append(a.ms)
        seg_plain.append(a.plain_ms)
        accum, mask, depth, iters, active, o, d = render_wave._gi_update(
            seg == 0, (), accum, mask, depth, iters, active, o, d, rand,
            a.res_k)

    kernels = [dict(
        name="K1 wavefront traversal", route="cuda",
        source="svo_raytracer_torch/csrc/wavefront.cu",
        replaces="svo_raytracer_tpu/ops/wavefront.py:891",
        launches=main_launches, max_abs_err=Agreement.worst_err,
        ms=float(np.mean(seg_ms)), plain_ms=float(np.mean(seg_plain)))]
    summary = dict(
        gi1_frame_ms=frames[1]["ms"], gi1_mrays=frames[1]["mrays"],
        gi3_frame_ms=frames[3]["ms"], gi3_mrays=frames[3]["mrays"],
        segment_ms=seg_ms, segment_plain_ms=seg_plain,
        max_memory_allocated=peak,
        frame_ms={f"gi{b}": frames[b]["times"] for b in frames})
    # ---- phase 6: where the device time goes
    summary["profile"] = profile_frames(ws, cam5, frames)
    say(f"[summary] {json.dumps(summary)}")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
