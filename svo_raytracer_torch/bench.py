"""Benchmark of the port on bench.py's workload: traversal throughput of
pathtraced GI frames through the wavefront engine (kernel K1).

Workload, as bench.py's: the 1024^3 procedural-terrain octree (perlin
chunkgen, eight 512^3 chunks spliced by models/world.build_world, the
terrain band centred at y = 0), brickified and prepared for the wavefront
engine, the camera placed by bench.py's downward-probe rule, render mode
0 at 1920x1080 with 1 and then 3 GI bounces.  Each frame count follows
bench.py: 5 warm frames, then 5 frames back to back ended by one
synchronize; the frame time is their mean and Mrays/s counts
(bounces + 1) * W * H rays per frame.

Prints bench.py's row as one JSON line on stdout, the gi-1 row first,
then the same row again with the gi-3 fields added (``frame_ms_gi3``,
``gi3_mrays``, and ``n_left`` of the gi-3 frame).  ``n_left`` maps each
traversal segment (``prim``, ``gi1``, ...) to the rays K1 retired at its
ITER_CAP, read on one untimed frame.  ``device`` is the card's name and
power limit from nvidia-smi.  Set-up lines go to stderr.

    python -m svo_raytracer_torch.bench             # on the card
    python -m svo_raytracer_torch.bench --small     # 64^3, 320x180
    python -m svo_raytracer_torch.bench --device cpu   # plain versions

On the card every traversal runs K1; ``--device cpu`` runs the kernels'
plain PyTorch versions (the tests' path) and is no measurement.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: (world size, chunk size, width, height)
FULL = (1024, 512, 1920, 1080)
SMALL = (64, 64, 320, 180)
WARM_FRAMES = TIMED_FRAMES = 5
GI_BOUNCES = (1, 3)


def log(*a):
    print("#", *a, file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_scene(world_size: int, chunk_size: int, device="cuda"):
    """The bench world on ``device``: perlin terrain chunks spliced into
    one octree (bench.py:33-71, without its cache).  Returns (DeviceOctree,
    timings): seconds of noise, chunk builds and splices (each stage ended
    by a synchronize) and ``build_s``, all of them."""
    from .models import procgen, world

    dev = torch.device(device)
    timings = {}
    t0 = time.perf_counter()
    tree = world.build_world(
        world_size, chunk_size,
        lambda o: procgen.generate_chunk(o, chunk_size, device=dev),
        world_offset=(0, -world_size // 2, 0), timings=timings)
    sync(dev)
    timings["build_s"] = time.perf_counter() - t0
    return tree, timings


def build_brick_scene(tree, device="cuda"):
    """Brickify the octree on the host (the node table goes there once)
    and prepare the wavefront tables on ``device``.  Returns (WaveScene,
    timings: ``to_host``, ``brickify`` and ``prepare`` seconds)."""
    from .ops import brick_scene, wavefront

    times = {}
    t0 = time.perf_counter()
    host = tree.to_numpy()
    times["to_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = brick_scene.brickify(host)
    times["brickify"] = time.perf_counter() - t0
    del host
    t0 = time.perf_counter()
    ws = wavefront.prepare(scene, device)
    sync(device)
    times["prepare"] = time.perf_counter() - t0
    return ws, times


def probe_camera(ws):
    """bench.py's rule (bench.py:156-174): probe 25 columns straight down,
    take the deepest free fall, sit 0.05 above its surface, pitch -0.35,
    yaw 0.4.  Returns (Camera, surface y)."""
    from .ops import wavefront
    from .utils.camera import Camera

    gx = np.linspace(1.2, 1.8, 5, dtype=np.float32)
    pxz = np.stack(np.meshgrid(gx, gx, indexing="ij"), -1).reshape(-1, 2)
    probe_o = np.concatenate([pxz[:, :1], np.full((25, 1), 1.999, np.float32),
                              pxz[:, 1:]], axis=1)
    probe_d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (25, 1))
    dev = ws.device
    probe = wavefront.intersect_wavefront(
        ws, torch.from_numpy(probe_o).to(dev),
        torch.from_numpy(probe_d).to(dev))
    ts = probe.t.cpu().numpy()
    best = int(np.argmax(ts))  # clearest column: deepest free fall
    surf_y = 1.999 - float(ts[best])
    cam = Camera(pos=np.array([probe_o[best, 0], min(surf_y + 0.05, 1.99),
                               probe_o[best, 2]]))
    cam.rotate(-0.35, 0.4)
    return cam, surf_y


def place_camera(ws):
    """:func:`probe_camera`'s camera as (cam5 on the scene's device,
    surface y)."""
    cam, surf_y = probe_camera(ws)
    return (torch.tensor(cam.uniform(), dtype=torch.float32,
                         device=ws.device), surf_y)


def frame_stats(ws, cam5, width, height, bounces):
    """One untimed gi-``bounces`` frame (frame number 1); returns the
    intersect_wavefront profile of each segment and the colour."""
    from .ops import render_wave

    stats = []
    col, _, _ = render_wave.render_frame_wavefront(
        ws, cam5, width, height, render_mode=0, frame_number=1,
        gi_bounces=bounces, stats=stats)
    return stats, col


def n_left(stats):
    """Rays retired at ITER_CAP per segment, keyed as the JAX package's
    render_wave.last_residue: ``prim``, ``gi1``, ..."""
    return {("prim" if i == 0 else f"gi{i}"): s["capped"]
            for i, s in enumerate(stats)}


def time_frames(ws, cam5, width, height, bounces, warm, timed):
    """bench.py's timing: ``warm`` frames, then ``timed`` frames back to
    back ended by one synchronize; returns their mean in ms."""
    from .ops import render_wave

    def frame(n):
        return render_wave.render_frame_wavefront(
            ws, cam5, width, height, render_mode=0, frame_number=n,
            gi_bounces=bounces)

    for i in range(warm):
        frame(i + 2)
    sync(ws.device)
    t0 = time.perf_counter()
    for i in range(timed):
        frame(i + 2)
    sync(ws.device)
    return (time.perf_counter() - t0) / timed * 1e3


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device type off the card."""
    if torch.device(device).type != "cuda":
        return torch.device(device).type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def setup(world_size, chunk_size, device="cuda"):
    """The bench world, its wavefront scene and the probe camera on
    ``device``: (DeviceOctree, WaveScene, cam5, set-up dict of the build
    and brick timings, ``surface_y``, ``n_nodes`` and ``n_mixed``)."""
    dev = torch.device(device)
    tree, built = build_scene(world_size, chunk_size, dev)
    log(f"scene: {world_size}^3 in {chunk_size}^3 chunks, {tree.n_nodes} "
        f"nodes, built in {built['build_s']:.3f} s ({built})")
    ws, prep = build_brick_scene(tree, dev)
    log(f"brick scene ready: n_mixed {ws.n_mixed} ({prep})")
    cam5, surf_y = place_camera(ws)
    log(f"camera at y={float(cam5[0, 1]):.4f} (surface {surf_y:.4f})")
    return tree, ws, cam5, dict(built, **prep, surface_y=surf_y,
                                n_nodes=tree.n_nodes, n_mixed=ws.n_mixed)


def rows(ws, cam5, width, height, metric, base):
    """bench.py's rows: for each of GI_BOUNCES, one untimed frame for its
    segments' stats, then the timed frames; yields (row, stats), the gi-1
    row first, then the row with the gi-3 fields.  ``base`` holds the
    fields every row carries (build seconds, device)."""
    row = {}
    for bounces in GI_BOUNCES:
        stats, _ = frame_stats(ws, cam5, width, height, bounces)
        ms = time_frames(ws, cam5, width, height, bounces, WARM_FRAMES,
                         TIMED_FRAMES)
        mrays = (bounces + 1) * width * height / (ms * 1e-3) / 1e6
        log(f"gi-{bounces} frame: {ms:.4f} ms ({mrays:.2f} Mrays/s)")
        if bounces == 1:
            row = dict(metric=metric, value=mrays, unit="Mrays/s",
                       frame_ms=ms, n_left=n_left(stats))
        else:
            row = dict(row, **{f"frame_ms_gi{bounces}": ms,
                               f"gi{bounces}_mrays": mrays,
                               "n_left": n_left(stats)})
        peak = (torch.cuda.max_memory_allocated()
                if ws.device.type == "cuda" else None)
        row.update(base, max_memory_allocated=peak)
        yield dict(row), stats


def run(world_size, chunk_size, width, height, device="cuda",
        metric="Mrays/s/chip (1024^3 pathtraced GI)", emit=print):
    """The whole bench; calls ``emit(row)`` with the gi-1 row and then the
    row with the gi-3 fields, and returns the last row."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card: CUDA is not "
                           "available (pass --device cpu for the plain "
                           "versions)")
    name = card(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tree, ws, cam5, info = setup(world_size, chunk_size, dev)
    del tree
    for row, _ in rows(ws, cam5, width, height, metric,
                       dict(build_s=info["build_s"], device=name)):
        emit(row)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="64^3 world in one chunk, 320x180")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    world_size, chunk_size, width, height = SMALL if args.small else FULL
    run(world_size, chunk_size, width, height, args.device,
        metric=("Mrays/s/chip (small smoke)" if args.small
                else "Mrays/s/chip (1024^3 pathtraced GI)"),
        emit=lambda row: print(json.dumps(row), flush=True))


if __name__ == "__main__":
    main()
