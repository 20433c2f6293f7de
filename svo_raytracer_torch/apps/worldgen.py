"""Offline world generator CLI — the WorldGenerator.test analog (port of
svo_raytracer_tpu/apps/worldgen.py).

The reference runs world generation as a JUnit entry point
(``src/tests/WorldGenerator.java:12-40``): load heightmap + matmap
textures, dispatch the chunkgen shaders over every chunk, build the
octree, print node counts, write ``debug.svo``.  Here the chunks are
generated and built on the device (models/world.build_world), the node
table comes to the host once, and the native codec writes it.  The
defaults (1024^3 perlin terrain in 512^3 chunks, offset -512) are
bench.py's world.  The JAX package's ``--capacity`` has no counterpart:
the device build sizes each chunk's table from its branch counts.

  python -m svo_raytracer_torch.apps.worldgen --out assets/debug.svo
  python -m svo_raytracer_torch.apps.worldgen --kind heightmap \\
      --heightmap assets/heightmaps/nzbig.png \\
      --matmap assets/matmaps/nz/materials.png --size 8192
  ... --cpu      # on the CPU; default: the CUDA device
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    """Build and write the world; returns (host Octree, timings: seconds
    of the whole build (``build_s``) and of its ``noise``, ``build`` and
    ``splice`` stages, of ``to_host`` and ``export``, and the file's
    ``bytes``)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--kind", default="perlin",
                    choices=["perlin", "sphere", "box", "heightmap"])
    ap.add_argument("--heightmap", default="./assets/heightmaps/nzbig.png")
    ap.add_argument("--matmap", default="./assets/matmaps/nz/materials.png")
    ap.add_argument("--height-scale", type=int, default=2048)
    ap.add_argument("--max-lod", type=int, default=None,
                    help="depth cap within each chunk")
    ap.add_argument("--out", default="./assets/debug.svo")
    ap.add_argument("--offset-y", type=int, default=None,
                    help="world y offset (default -size/2 for perlin, 0 else)")
    ap.add_argument("--cpu", action="store_true",
                    help="build on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)

    import os

    from ..core import svo_format
    from ..models import heightmap as hm_mod
    from ..models import procgen, world
    from .viewer import check_device

    dev = check_device("cpu" if args.cpu else "cuda")
    if args.offset_y is None:
        args.offset_y = -args.size // 2 if args.kind == "perlin" else 0

    if args.kind == "heightmap":
        from ..io.image import read_heightmap, read_png

        hm = read_heightmap(args.heightmap)
        mm = read_png(args.matmap).astype("int32")

        def gen(origin):
            return hm_mod.generate_chunk_heightmap(
                hm, mm, origin, chunk_size=args.chunk,
                height_scale=args.height_scale, device=dev)
    else:
        def gen(origin):
            return procgen.generate_chunk(origin, args.chunk, kind=args.kind,
                                          device=dev)

    times = {}
    t0 = time.perf_counter()
    tree = world.build_world(args.size, args.chunk, gen, max_lod=args.max_lod,
                             world_offset=(0, args.offset_y, 0),
                             timings=times)
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()
    times["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = tree.to_numpy()
    times["to_host"] = time.perf_counter() - t0
    print(f"built {host.n_nodes} nodes in {times['build_s']:.1f}s",
          file=sys.stderr)
    for k, v in host.node_counts().items():  # printNodeCounts analog
        print(f"{k}: {v:,}", file=sys.stderr)   # (Octree.java:1018)
    t0 = time.perf_counter()
    svo_format.write_svo_file(host, args.out)
    times["export"] = time.perf_counter() - t0
    times["bytes"] = os.path.getsize(args.out)
    print(f"wrote {args.out}", file=sys.stderr)
    return host, times


if __name__ == "__main__":
    main()
