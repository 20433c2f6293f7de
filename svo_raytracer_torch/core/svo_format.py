"""Reference-compatible ``.svo`` serialization (port of
svo_raytracer_tpu/core/svo_format.py).

The reference checkpoint format (``src/engine/Octree.java:974-1012``) is a
4-byte big-endian length header followed by the raw octree arena:

* branch (tag 0), 7 B: value(1) | child-pointer int32 BE *relative to the
  node's own address* (Octree.java:162-168) | leaf mask int16 BE (:170-176)
* surface leaf (tag 1), 3 B: value | packed normal, **little-endian**
  (createSurfaceLeafNode:146-153 writes low byte first; the GPU reads
  ``getByte(p+1) | getByte(p+2) << 8``, svotrace.comp:105)
* subdividable leaf (tag 2), 7 B: value + 6 padding bytes
* non-surface leaf (tag 3), 1 B: value

A child's tag lives in its *parent's* leaf mask (2 bits each,
Octree.java:589-599); children are stored contiguously in child order.

Export emits nodes in BFS order (each branch's 8 children contiguous);
import allocates each branch's 8 children in DFS order.  Stale subtrees
hanging off promoted subdividable leaves are unreachable and are not
round-tripped.

:func:`export_svo` and :func:`import_svo` are the codec in Python, the
plain version: a dict-based BFS far too slow for a 16 M-node world.
:func:`write_svo_file` and :func:`read_svo_file` go through the native
codec (runtime/native.py, ``csrc/svo_codec.cc``), which equals them byte
for byte and array for array.
"""

from __future__ import annotations

import struct
from collections import deque

import numpy as np

from ..utils import constants as C
from .octree import Octree, ROOT

NODE_SIZE = 7
LEAF_SIZE = 3
NON_SURFACE_LEAF_SIZE = 1

_TAG_SIZE = {
    C.TAG_BRANCH: NODE_SIZE,
    C.TAG_SURFACE_LEAF: LEAF_SIZE,
    C.TAG_SUBDIV_LEAF: NODE_SIZE,
    C.TAG_NON_SURFACE_LEAF: NON_SURFACE_LEAF_SIZE,
}


def export_svo(tree: Octree) -> bytes:
    """Serialize the node table to the reference byte format (no header)."""
    t = tree.to_numpy()
    child, mask, value, normal = (np.asarray(a) for a in t.arrays())

    # Pass 1 (BFS): assign byte addresses.  The root is a branch at 0.
    addr = {ROOT: 0}
    tag_of = {ROOT: C.TAG_BRANCH}
    offset = NODE_SIZE
    order = [ROOT]
    queue = deque([ROOT])
    while queue:
        p = queue.popleft()
        base = int(child[p])
        if tag_of[p] != C.TAG_BRANCH or base == 0:
            continue
        m = int(mask[p])
        for k in range(8):
            ci = base + k
            tag = (m >> (2 * k)) & 3
            addr[ci] = offset
            tag_of[ci] = tag
            offset += _TAG_SIZE[tag]
            order.append(ci)
            queue.append(ci)

    # Pass 2: emit bytes.
    out = bytearray(offset)
    for ci in order:
        a = addr[ci]
        tag = tag_of[ci]
        out[a] = int(value[ci]) & 0xFF
        if tag == C.TAG_SURFACE_LEAF:
            raw = int(normal[ci])
            out[a + 1] = raw & 0xFF          # little-endian normal
            out[a + 2] = (raw >> 8) & 0xFF
        elif tag in (C.TAG_BRANCH, C.TAG_SUBDIV_LEAF):
            base = int(child[ci])
            cp_rel = (addr[base] - a) if (tag == C.TAG_BRANCH and base != 0) else 0
            struct.pack_into(">i", out, a + 1, cp_rel)
            struct.pack_into(">H", out, a + 5, int(mask[ci]) & 0xFFFF)
    return bytes(out)


def import_svo(data: bytes, world_size: int = C.WORLD_SIZE) -> Octree:
    """Parse a reference-format octree buffer (no header) into a node table."""
    n_cap = max(16, len(data))  # upper bound: >=1 byte per node
    child = np.zeros(n_cap, np.int32)
    mask = np.zeros(n_cap, np.int32)
    value = np.zeros(n_cap, np.int32)
    normal = np.zeros(n_cap, np.int32)

    def read_u8(a):
        return data[a]

    def read_i32be(a):
        return struct.unpack_from(">i", data, a)[0]

    def read_u16be(a):
        return struct.unpack_from(">H", data, a)[0]

    def read_u16le(a):
        return data[a] | (data[a + 1] << 8)

    n = [8]  # slot 0 = root; keep stride-8 allocation like the builders

    def alloc8():
        base = n[0]
        n[0] += 8
        return base

    # Iterative DFS: (byte_addr, node_slot, tag)
    value[ROOT] = read_u8(0)
    stack = [(0, ROOT, C.TAG_BRANCH)]
    while stack:
        a, slot, tag = stack.pop()
        if tag == C.TAG_SURFACE_LEAF:
            normal[slot] = read_u16le(a + 1)
            continue
        if tag == C.TAG_NON_SURFACE_LEAF:
            continue
        # branch or subdividable leaf: 7-byte record
        cp_rel = read_i32be(a + 1)
        m = read_u16be(a + 5)
        mask[slot] = m
        if tag == C.TAG_SUBDIV_LEAF or cp_rel == 0:
            continue  # no live children (stale subtrees are unreachable)
        base = alloc8()
        child[slot] = base
        ca = a + cp_rel
        for k in range(8):
            ctag = (m >> (2 * k)) & 3
            cslot = base + k
            value[cslot] = read_u8(ca)
            stack.append((ca, cslot, ctag))
            ca += _TAG_SIZE[ctag]

    cnt = n[0]
    return Octree(child=child[:cnt].copy(), mask=mask[:cnt].copy(),
                  value=value[:cnt].copy(), normal=normal[:cnt].copy(),
                  n_nodes=cnt, world_size=world_size)


def write_svo_file(tree: Octree, path: str) -> None:
    """Write header + buffer (Octree.writeBufferToFile:974-993) through the
    native codec."""
    from ..runtime import native

    payload = native.export_svo(tree)
    with open(path, "wb") as f:
        f.write(struct.pack(">i", len(payload)))
        f.write(payload)


def read_svo_file(path: str, world_size: int = C.WORLD_SIZE) -> Octree:
    """Read header + buffer (Octree.readBufferFromFile:995-1012) through the
    native codec."""
    from ..runtime import native

    with open(path, "rb") as f:
        (length,) = struct.unpack(">i", f.read(4))
        data = f.read(length)
    if len(data) != length:
        raise ValueError(f"{path}: header says {length} bytes, file holds "
                         f"{len(data)}")
    return native.import_svo(data, world_size=world_size)
