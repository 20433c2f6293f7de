"""Procedural world generation — the chunkgen pipeline (port of
svo_raytracer_tpu/models/procgen.py).

The reference dispatches chunkgen.comp over 8^3 workgroups and reads the
grid back (``Octree.java:274-315``); here the noise is evaluated over the
chunk's voxel grid on the device, where the octree build
(core/build_device) takes it without a trip to the host.
"""

from __future__ import annotations

import torch

from ..ops import noise

#: y rows per snoise slab: at a 512^3 chunk each float32 temporary of the
#: slab is 64 MiB, so the ~30 alive at once stay near 2 GiB
SLAB = 64


def generate_chunk(origin, chunk_size: int = 1024, kind: str = "perlin",
                   device=None) -> torch.Tensor:
    """(chunk_size,)*3 uint8 material grid, indexed [x, y, z], of the chunk
    at ``origin`` (three ints), on ``device`` (default the card; pass
    "cpu" to generate on the CPU) — the analog of dispatching
    chunkgen.comp (chunkgen.comp:228-233) with the chunk-origin uniforms
    (:4-6)."""
    if kind not in ("perlin", "sphere", "box"):
        raise ValueError(f"unknown generator kind {kind!r}")
    dev = torch.device("cuda" if device is None else device)
    o = [int(v) for v in origin]
    ax = torch.arange(chunk_size, dtype=torch.int32, device=dev)
    x = ax[:, None, None] + o[0]
    y = ax[None, :, None] + o[1]
    z = ax[None, None, :] + o[2]
    if kind == "perlin":
        return noise.sample_perlin_terrain(x, y, z, slab=SLAB)
    if kind == "sphere":
        return noise.sample_sphere(x, y, z)
    return noise.sample_box(x, y, z)
