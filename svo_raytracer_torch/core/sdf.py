"""Signed-distance-field brushes and interactive octree edits (port of
svo_raytracer_tpu/core/sdf.py; the reference's ``src/engine/sdf/`` and
``useSDFBrush``/``subdivideNode``/``ChangeBounds``, Octree.java:676-885).

Edits run on the host over the SoA table (they touch a handful of
nodes); the returned :class:`ChangeBounds` gives the two dirty slot
windows, touched existing nodes and appended nodes, which
runtime/renderer.DeviceTree copies to the device as two ranged updates
(the reference's two ``updateSSBO`` calls, Main.java:349-350).
Reference quirks kept: full containment tombstones the direct children
(Octree.java:794-810), the Box brush is inert inside (Box.java:42-44),
and painting a leaf with its own value is a no-op (Octree.java:833-835).
One difference: the existing-node window also covers the tombstoned
children, which the JAX package's leaves out; so every slot an edit
writes lies in one of the two windows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import constants as C
from ..utils import mathutil
from .octree import Octree


class SignedDistanceField:
    """Abstract integer SDF with an AABB (sdf/SignedDistanceField.java)."""

    origin: np.ndarray
    min: np.ndarray
    max: np.ndarray

    def distance(self, pos) -> int:
        return 0

    def normal(self, pos, face_outwards: bool) -> int:
        """Digit-packed surface normal at ``pos`` (see mathutil.pack_normal)."""
        return 0


class Sphere(SignedDistanceField):
    """sdf/Sphere.java: euclidean distance minus radius; AABB radius+1."""

    def __init__(self, origin, radius: int):
        self.origin = np.asarray(origin, np.int64)
        self.radius = int(radius)
        self.min = self.origin - (radius + 1)
        self.max = self.origin + (radius + 1)

    def distance(self, pos) -> int:
        d = np.asarray(pos, np.float64) - self.origin
        return int(round(float(np.sqrt(np.sum(d * d))))) - self.radius

    def normal(self, pos, face_outwards: bool) -> int:
        diff = (np.asarray(pos, np.int64) - self.origin if face_outwards
                else self.origin - np.asarray(pos, np.int64))
        return mathutil.pack_normal(mathutil.normalize(diff))


class Box(SignedDistanceField):
    """sdf/Box.java: classic box SDF with half-extent AABB."""

    def __init__(self, origin, width: int, height: int, depth: int):
        self.origin = np.asarray(origin, np.int64)
        self.size = np.array([width, height, depth], np.int64)
        half = np.ceil(self.size / 2.0).astype(np.int64)
        self.min = self.origin - half
        self.max = self.origin + half

    def distance(self, pos) -> int:
        q = np.abs(np.asarray(pos, np.int64) - self.origin) - self.size
        qc = np.maximum(q, 0)
        m = min(int(np.max(q)), 0)
        return int(np.sqrt(np.sum((qc + m) ** 2)))

    def normal(self, pos, face_outwards: bool) -> int:
        diff = (np.asarray(pos, np.int64) - self.origin if face_outwards
                else self.origin - np.asarray(pos, np.int64))
        return mathutil.pack_normal(mathutil.normalize(diff))


@dataclasses.dataclass
class ChangeBounds:
    """Dirty node-slot windows (Octree.ChangeBounds, Octree.java:676-698):
    [start0, end0) touched existing nodes, [start1, end1) appended nodes."""

    start0: int
    end0: int
    start1: int
    end1: int

    def touch_existing(self, lo: int, hi: int) -> None:
        if self.start0 > lo:
            self.start0 = lo
        if self.end0 < hi + 1 and hi < self.start1:
            self.end0 = hi + 1


class OctreeEditor:
    """Mutable host-side view of an Octree for CSG edits.

    Arrays grow by doubling when appends exceed capacity (the reference's
    arena is fixed 2 GB and simply overflows; we grow instead).  Deleted
    subtrees are tombstoned with DELETE_VALUE and leak, exactly like the
    reference (Octree.java:954-956) — compaction is a separate pass.
    """

    def __init__(self, tree: Octree):
        t = tree.to_numpy()
        self.child = np.array(t.child[:t.n_nodes], np.int32)
        self.mask = np.array(t.mask[:t.n_nodes], np.int32)
        self.value = np.array(t.value[:t.n_nodes], np.int32)
        self.normal = np.array(t.normal[:t.n_nodes], np.int32)
        self.n = t.n_nodes
        self.world_size = t.world_size

    def _ensure(self, extra: int) -> None:
        cap = self.child.shape[0]
        if self.n + extra <= cap:
            return
        new_cap = max(cap * 2, self.n + extra)
        for name in ("child", "mask", "value", "normal"):
            a = getattr(self, name)
            b = np.zeros(new_cap, np.int32)
            b[:a.shape[0]] = a
            setattr(self, name, b)

    def to_octree(self) -> Octree:
        return Octree(child=self.child[:self.n].copy(),
                      mask=self.mask[:self.n].copy(),
                      value=self.value[:self.n].copy(),
                      normal=self.normal[:self.n].copy(),
                      n_nodes=self.n, world_size=self.world_size)

    # -- the edit ---------------------------------------------------------
    def use_sdf_brush(self, sdf: SignedDistanceField, value: int,
                      max_lod: int = 13) -> ChangeBounds:
        """Apply a CSG brush (value=0 subtracts, else paints/adds) —
        Octree.useSDFBrush (Octree.java:700-708)."""
        cb = ChangeBounds(start0=self.n, end0=0, start1=self.n, end1=self.n)
        self._brush(sdf, 0, 0, 0, self.world_size, np.zeros(3, np.int64),
                    False, int(value), 0, max_lod, cb)
        return cb

    def _march(self, sdf, pos, size):
        """The coarse classification march (Octree.java:726-767): visit the
        node's voxels (clipped to the SDF AABB), skipping ahead by
        |distance|-2, until both volume and air are seen."""
        contains_volume = borders_volume = contains_air = False
        lo = np.maximum(pos, sdf.min)
        hi = pos + size
        i = lo[0]
        while i < hi[0]:
            j = lo[1]
            while j < hi[1]:
                k = lo[2]
                while k < hi[2]:
                    dist = sdf.distance((i, j, k))
                    if dist <= 0:
                        contains_volume = True
                    if dist in (0, 1):
                        borders_volume = True
                    if dist > 0:
                        contains_air = True
                    march = abs(dist) - 2
                    if march < C.MARCH_DISTANCE_MIN_CUTOFF:
                        march = 0
                    k += march + 1
                    if contains_volume and contains_air:
                        break
                j += 1
                if contains_volume and contains_air:
                    break
            i += 1
            if contains_volume and contains_air:
                break
        return contains_volume, borders_volume, contains_air

    def _for_each_child(self, parent: int, pos, size):
        """(slot, cpos, child_number, is_leaf) per child (Octree.java:901-921;
        fixed-stride in the SoA table)."""
        base = int(self.child[parent])
        m = int(self.mask[parent])
        cs = size // 2
        out = []
        for k in range(8):
            tag = (m >> (2 * k)) & 3
            off = np.asarray(C.CHILD_OFFSETS[k], np.int64)
            out.append((base + k, pos + off * cs, k, tag != C.TAG_BRANCH))
        return out

    def _brush(self, sdf, current, parent, child_number, size, pos, is_leaf,
               value, cur_lod, max_lod, cb: ChangeBounds):
        node_max = pos + size
        if not mathutil.intersect_aabb(pos, node_max, sdf.min, sdf.max):
            return

        contains_volume, borders_volume, contains_air = \
            self._march(sdf, pos, size)
        if not contains_volume and not borders_volume:
            return

        cs = size // 2
        if borders_volume and size > 1 and is_leaf and value != 0:
            # additive op on a boundary leaf -> subdivide (Octree.java:777)
            self._subdivide(parent, current, value, child_number, cs, pos,
                            cur_lod, max_lod, sdf, cb)
        elif contains_volume:
            if is_leaf:
                if not contains_air:
                    self.value[current] = value
                    cb.touch_existing(current, current)
                else:
                    self._subdivide(parent, current, value, child_number, cs,
                                    pos, cur_lod, max_lod, sdf, cb)
                return
            else:
                if not contains_air:
                    # node fully inside: set value, promote to subdividable
                    # leaf in the parent mask, tombstone direct children
                    # (Octree.java:794-810)
                    self.value[current] = value
                    pm = int(self.mask[parent])
                    pm &= ~(0x3 << (2 * child_number))
                    pm |= C.TAG_SUBDIV_LEAF << (2 * child_number)
                    self.mask[parent] = pm
                    cb.touch_existing(min(parent, current),
                                      max(parent, current))
                    for slot, cpos, k, leaf in self._for_each_child(
                            current, pos, size):
                        self.value[slot] = C.DELETE_VALUE
                    # the tombstones are writes too: the JAX package's
                    # window misses them, and a ranged upload of it leaves
                    # the old values in those (unreachable) slots
                    base = int(self.child[current])
                    cb.touch_existing(base, base + 7)
                    return
                for slot, cpos, k, leaf in self._for_each_child(
                        current, pos, size):
                    self._brush(sdf, slot, current, k, cs, cpos, leaf, value,
                                cur_lod + 1, max_lod, cb)
        elif borders_volume and size > 1:
            if is_leaf:
                self._subdivide(parent, current, value, child_number, cs, pos,
                                cur_lod, max_lod, sdf, cb)
            else:
                for slot, cpos, k, leaf in self._for_each_child(
                        current, pos, size):
                    self._brush(sdf, slot, current, k, cs, cpos, leaf, value,
                                cur_lod + 1, max_lod, cb)

    def _subdivide(self, parent, current, value, child_number, cs, pos,
                   cur_lod, max_lod, sdf, cb: ChangeBounds):
        """Demote a leaf to a branch: append 8 children at the arena end
        (Octree.java:829-885)."""
        current_value = int(self.value[current])
        if value == current_value:
            return
        if value != 0:
            self.value[current] = value
            cb.touch_existing(current, current)

        pm = int(self.mask[parent])
        pm &= ~(0x3 << (2 * child_number))
        self.mask[parent] = pm
        cb.touch_existing(min(parent, current), max(parent, current))

        self._ensure(8)
        base = self.n
        self.n += 8
        if cur_lod + 1 == max_lod:
            # maximal leaves: surface, all sharing the SDF normal at the
            # parent's position (the reference passes `pos`, not cPos —
            # Octree.java:863)
            packed = sdf.normal(pos, value != 0)
            mask = 0
            for k in range(8):
                mask |= C.TAG_SURFACE_LEAF << (2 * k)
                self.value[base + k] = current_value
                self.normal[base + k] = packed
        else:
            mask = 0
            for k in range(8):
                mask |= C.TAG_SUBDIV_LEAF << (2 * k)
                self.value[base + k] = current_value

        self.mask[current] = mask
        self.child[current] = base
        cb.end1 = self.n

        for k in range(8):
            off = np.asarray(C.CHILD_OFFSETS[k], np.int64)
            self._brush(sdf, base + k, current, k, cs, pos + off * cs, True,
                        value, cur_lod + 1, max_lod, cb)


def use_sdf_brush(tree: Octree, sdf: SignedDistanceField, value: int,
                  max_lod: int = 13) -> tuple[Octree, ChangeBounds]:
    """Functional edit: returns (new tree, dirty ranges)."""
    ed = OctreeEditor(tree)
    cb = ed.use_sdf_brush(sdf, value, max_lod)
    return ed.to_octree(), cb
