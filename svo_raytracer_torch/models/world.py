"""Chunked world builds — the constructCompleteOctree analog (port of
svo_raytracer_tpu/models/world.py).

The reference builds big worlds as a fixed top tree of interior nodes
down to chunk level (``fillEmptyChildren``, ``Octree.java:481-502``), then
per chunk: GPU noise, a readback, host threads building sub-octrees and a
byte-buffer splice (``Octree.java:250-343``).  Here each chunk's voxels
are generated and reduced to a node table on the device
(core/build_device), and splicing is an index-remapped append on the
world's device, so the node table never leaves it.

The node table equals the JAX package's ``build_world`` slot for slot,
with its graph delta against the reference (a homogeneous half-chunk
collapses to a leaf) and the reference's chunk-border clipping (each
chunk sees only its own grid).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..core.build_device import build_octree_device
from ..core.octree import ROOT, DeviceOctree
from ..utils import constants as C


def chunk_layout(world_size: int, chunk_size: int, device="cpu"):
    """Top-of-tree layout: (top tree, [(origin, chunk_slot), ...]).

    Replicates fillEmptyChildren (Octree.java:481-502): a full branch tree
    of interior (value 1) nodes down to chunk level, chunks enumerated in
    DFS octant order.  The top tree is a DeviceOctree on ``device``.
    """
    levels = int(np.log2(world_size // chunk_size))
    cap = 8 + sum(8 ** d for d in range(1, levels + 1))
    child = np.zeros(cap, np.int32)
    mask = np.zeros(cap, np.int32)
    value = np.zeros(cap, np.int32)
    n = [8]
    value[ROOT] = 1
    chunks: list[tuple[tuple[int, int, int], int]] = []

    def fill(parent: int, lvl: int, pos):
        if lvl == 0:
            chunks.append((tuple(int(p) for p in pos), parent))
            return
        csize = chunk_size << (lvl - 1)
        base = n[0]
        n[0] += 8
        child[parent] = base
        mask[parent] = 0  # all children are branches (tag 0)
        value[base:base + 8] = 1
        for k, off in enumerate(C.CHILD_OFFSETS):
            cpos = (pos[0] + off[0] * csize, pos[1] + off[1] * csize,
                    pos[2] + off[2] * csize)
            fill(base + k, lvl - 1, cpos)

    fill(ROOT, levels, (0, 0, 0))

    def put(a):
        return torch.from_numpy(a[:n[0]].copy()).to(device)

    top = DeviceOctree(put(child), put(mask), put(value),
                       put(np.zeros(cap, np.int32)), n_nodes=n[0],
                       world_size=world_size)
    return top, chunks


def splice_chunk(world: DeviceOctree, chunk_slot: int,
                 chunk: DeviceOctree) -> DeviceOctree:
    """Graft a chunk tree under ``chunk_slot`` — the byte-buffer splice
    at Octree.java:317-343 as an append and a pointer remap, on the
    world's device.  Indices stay int32 (a 1024^3 world holds ~16 M
    nodes)."""
    offset = world.n_nodes
    m = chunk.n_nodes - 8  # drop the chunk's root block (slots 0..7)
    ch = chunk.child[8:]
    ch = torch.where(ch > 0, ch + (offset - 8), 0).to(torch.int32)
    new = DeviceOctree(
        torch.cat([world.child, ch]),
        torch.cat([world.mask, chunk.mask[8:]]),
        torch.cat([world.value, chunk.value[8:]]),
        torch.cat([world.normal, chunk.normal[8:]]),
        n_nodes=world.n_nodes + m, world_size=world.world_size)
    # the chunk slot adopts the chunk root's child, mask and value; its
    # normal stays the top tree's
    root_child = int(chunk.child[ROOT])
    new.child[chunk_slot] = (offset + root_child - 8) if root_child else 0
    new.mask[chunk_slot] = chunk.mask[ROOT]
    new.value[chunk_slot] = chunk.value[ROOT]
    return new


def build_world(world_size: int, chunk_size: int,
                gen_fn: Callable[[tuple[int, int, int]], torch.Tensor],
                max_lod: int | None = None, world_offset=(0, 0, 0),
                timings: dict | None = None) -> DeviceOctree:
    """Build a chunked world octree on the device of the grids that
    ``gen_fn(origin) -> (chunk_size^3) voxel tensor`` returns.

    ``max_lod`` is depth *within a chunk* (None: full voxel resolution).
    ``world_offset`` shifts generation coordinates (Constants.WORLD_OFFSET
    / the rootPos arg of Octree.java:358).  The device build sizes each
    chunk's table from its branch counts, so the JAX package's
    ``chunk_capacity`` has no counterpart here.

    ``timings`` (a dict) receives the seconds spent generating
    (``noise``), building (``build``) and splicing (``splice``) chunks,
    each stage ended by a device synchronize."""
    def stage(name, fn, *args):
        if timings is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
        return out

    if world_size == chunk_size:
        v = stage("noise", gen_fn, tuple(world_offset))
        return stage("build", build_octree_device, v, max_lod, world_size)

    world = None
    _, chunks = chunk_layout(world_size, chunk_size)   # the chunk order
    for origin, slot in chunks:
        gpos = (origin[0] + world_offset[0], origin[1] + world_offset[1],
                origin[2] + world_offset[2])
        v = stage("noise", gen_fn, gpos)
        chunk = stage("build", build_octree_device, v, max_lod, chunk_size)
        del v
        if world is None:   # the top tree, on the grids' device
            world, _ = chunk_layout(world_size, chunk_size, chunk.device)
        world = stage("splice", splice_chunk, world, slot, chunk)
        del chunk
    return world


def build_world_sharded(world_size: int, chunk_size: int, gen_fn: Callable,
                        mesh, max_lod: int | None = None,
                        world_offset=(0, 0, 0)) -> DeviceOctree:
    """:func:`build_world` with chunk generation and builds spread over the
    mesh's ``tiles`` axis, the same world on every rank.

    Chunks go in groups of one per rank, in DFS chunk order: rank j
    generates and builds chunk g0 + j of each group on its device (the
    last group's spare ranks repeat its last chunk, and the result is
    dropped).  The ranks gather each group's node counts, then its node
    tables padded to the largest count, and every rank splices the group
    in chunk order, so the node table equals the serial build's in every
    array."""
    if world_size == chunk_size:
        return build_world(world_size, chunk_size, gen_fn, max_lod=max_lod,
                           world_offset=world_offset)
    n_dev, me = mesh.size("tiles"), mesh.rank("tiles")
    dev = mesh.device
    world, chunks = chunk_layout(world_size, chunk_size, dev)
    origins = [(o[0] + world_offset[0], o[1] + world_offset[1],
                o[2] + world_offset[2]) for o, _ in chunks]
    for g0 in range(0, len(chunks), n_dev):
        v = gen_fn(origins[min(g0 + me, len(chunks) - 1)])
        chunk = build_octree_device(v, max_lod, chunk_size)
        del v
        mine = torch.tensor([chunk.n_nodes], dtype=torch.int32, device=dev)
        counts = mesh.all_gather(mine, "tiles").flatten().tolist()
        table = torch.zeros((4, max(counts)), dtype=torch.int32, device=dev)
        table[:, :chunk.n_nodes] = torch.stack(
            [a[:chunk.n_nodes] for a in chunk.arrays()])
        del chunk
        tables = mesh.all_gather(table, "tiles")
        for j in range(min(n_dev, len(chunks) - g0)):
            n = counts[j]
            part = DeviceOctree(*(a[:n] for a in tables[j]), n_nodes=n,
                                world_size=chunk_size)
            world = splice_chunk(world, chunks[g0 + j][1], part)
    return world
