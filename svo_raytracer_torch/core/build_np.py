"""Host-side (NumPy) octree builder (port of
svo_raytracer_tpu/core/build_np.py; the node tables are equal,
tests/test_torch_core.py).

Re-implements the reference's recursive bottom-up chunk build
(``src/engine/Octree.java:511-670``: ``constructInnerOctree`` +
``genSurfaceNormal`` + ``checkBigNodeExposed``) with its quirks:

* Homogeneity scan (Octree.java:533-555): a cell is a leaf iff every voxel
  equals the cell's min-corner voxel.  Inhomogeneous cells take the corner
  value if nonzero, else the first nonzero voxel in (z, y, x)-major scan
  order (x fastest).
* LOD shortcut (Octree.java:533): when the *next* level is max_lod (here
  always the voxel level) the cell becomes a leaf carrying its corner
  voxel value.
* Big-node exposure (Octree.java:651-670): the probe set is the <=27 points
  with all three coords in {c-1, c+size, c+size+1} — corners only.
* Surface normals (Octree.java:620-649): sum of offsets to air voxels in the
  3x3x3 neighborhood, per-axis truncating division by 2, +5, packed as
  decimal digits.  Out-of-grid neighbors are skipped.
"""

from __future__ import annotations

import numpy as np

from ..utils import constants as C
from .octree import ROOT, Octree

_OFFS = np.array(C.CHILD_OFFSETS, dtype=np.int64)


def _first_nonzero_scan_order(cell: np.ndarray) -> int:
    """First nonzero voxel of a [x,y,z]-indexed cell in the reference's scan
    order: z outer, y middle, x inner (Octree.java:534-536)."""
    flat = cell.transpose(2, 1, 0).ravel()
    nz = np.nonzero(flat)[0]
    return int(flat[nz[0]]) if nz.size else 0


def gen_surface_normal(voxels: np.ndarray, pos) -> tuple[bool, int]:
    """Exposure + digit-packed normal of a single voxel (Octree.java:620-649)."""
    S = voxels.shape
    x, y, z = int(pos[0]), int(pos[1]), int(pos[2])
    exposed = False
    nx = ny = nz = 0
    for i in range(max(x - 1, 0), min(x + 2, S[0])):
        for j in range(max(y - 1, 0), min(y + 2, S[1])):
            for k in range(max(z - 1, 0), min(z + 2, S[2])):
                if voxels[i, j, k] == 0:
                    exposed = True
                    nx += i - x
                    ny += j - y
                    nz += k - z
    # Java int division truncates toward zero.
    dx = int(nx / 2) + 5
    dy = int(ny / 2) + 5
    dz = int(nz / 2) + 5
    return exposed, dx + dy * 10 + dz * 100


def check_big_node_exposed(voxels: np.ndarray, pos, size: int) -> bool:
    """Corner-probe exposure test for size>1 nodes (Octree.java:651-670)."""
    S = voxels.shape
    probes = []
    for axis, c in enumerate((int(pos[0]), int(pos[1]), int(pos[2]))):
        pts = [p for p in (c - 1, c + size, c + size + 1) if 0 <= p < S[axis]]
        if not pts:
            return False
        probes.append(pts)
    for i in probes[0]:
        for j in probes[1]:
            for k in probes[2]:
                if voxels[i, j, k] == 0:
                    return True
    return False


class _Builder:
    def __init__(self, voxels: np.ndarray, max_lod: int):
        self.v = voxels
        self.max_lod = max_lod
        self.child = np.zeros(4096, np.int32)
        self.mask = np.zeros(4096, np.int32)
        self.value = np.zeros(4096, np.int32)
        self.normal = np.zeros(4096, np.int32)
        self.n = 0

    def alloc8(self) -> int:
        base = self.n
        self.n += 8
        if self.n > self.child.shape[0]:
            for name in ("child", "mask", "value", "normal"):
                arr = getattr(self, name)
                setattr(self, name, np.concatenate([arr, np.zeros_like(arr)]))
        return base

    def build(self, parent: int, pos, size: int, lod: int) -> None:
        csize = size // 2
        if csize == 0 or lod == self.max_lod:
            return
        base = self.alloc8()
        self.child[parent] = base
        mask = 0
        recurse = []
        for n in range(8):
            cpos = np.asarray(pos) + _OFFS[n] * csize
            node = base + n
            cx, cy, cz = (int(c) for c in cpos)
            corner = int(self.v[cx, cy, cz])
            if lod + 1 == self.max_lod:
                leaf, value = True, corner
            else:
                cell = self.v[cx:cx + csize, cy:cy + csize, cz:cz + csize]
                if np.all(cell == corner):
                    leaf, value = True, corner
                else:
                    leaf = False
                    value = (corner if corner != 0
                             else _first_nonzero_scan_order(cell))
            tag = C.TAG_BRANCH
            if leaf and value != 0:
                if csize == 1:
                    exposed, packed = gen_surface_normal(self.v, cpos)
                    if exposed:
                        tag = C.TAG_SURFACE_LEAF
                        self.normal[node] = packed
                    else:
                        tag = C.TAG_NON_SURFACE_LEAF
                elif check_big_node_exposed(self.v, cpos, csize):
                    tag = C.TAG_BRANCH
                else:
                    tag = C.TAG_SUBDIV_LEAF
            elif leaf:
                tag = C.TAG_NON_SURFACE_LEAF if csize == 1 else C.TAG_SUBDIV_LEAF
            self.value[node] = value
            mask |= tag << (2 * n)
            if tag == C.TAG_BRANCH and value != 0:
                recurse.append((node, cpos))
        self.mask[parent] = mask
        for node, cpos in recurse:
            self.build(node, cpos, csize, lod + 1)


def build_octree_np(voxels: np.ndarray) -> Octree:
    """Build an SVO node table from a dense [x,y,z]-indexed voxel grid.

    Equivalent to ``createDummyHead(); constructInnerOctree(S, 0, max_lod,
    (0,0,0), 0, voxels)`` (OctreeThread.java:20-23) at full voxel
    resolution.
    """
    voxels = np.ascontiguousarray(voxels)
    S = voxels.shape[0]
    if voxels.shape != (S, S, S):
        raise ValueError(f"voxel grid must be cubic, got {voxels.shape}")
    levels = int(S).bit_length() - 1
    if (1 << levels) != S:
        raise ValueError(f"grid size {S} is not a power of two")
    b = _Builder(voxels, levels)
    # root: interior node, value 1 (Octree.java:97-100,234); slots 1-7 spare
    b.alloc8()
    b.value[ROOT] = 1
    b.build(ROOT, (0, 0, 0), S, 0)
    return Octree(child=b.child[:b.n].copy(), mask=b.mask[:b.n].copy(),
                  value=b.value[:b.n].copy(), normal=b.normal[:b.n].copy(),
                  n_nodes=b.n, world_size=S)
