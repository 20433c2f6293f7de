"""Sparse-voxel-octree node table (host NumPy; port of
svo_raytracer_tpu/core/octree.py).

  child[i]  : absolute node index of child 0 (0 == no children / leaf payload)
  mask[i]   : 16-bit leaf mask, 2 bits per child (tags in utils/constants)
  value[i]  : material id, 0 = air
  normal[i] : digit-packed surface normal for surface leaves

A branch's 8 children occupy 8 contiguous slots, so child k of node p is
``child[p] + k``; its type is the 2-bit tag ``(mask[p] >> 2k) & 3``.

:class:`DeviceOctree` is the same table as four int32 tensors on one
device (``Octree.to_device``), the form the ESVO traversal reads.  Its
tensors may hold more slots than ``n_nodes`` (``to_device(pad_to=)``):
the padding is zero, which the traversal never reaches, so an edit can
append nodes without reallocating (runtime/renderer.DeviceTree).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import constants as C
from ..utils.profiling import timer

# Node slot 0 is always the root, so 0 doubles as the "no children" sentinel.
ROOT = 0


@dataclasses.dataclass
class Octree:
    """SoA octree node table plus world metadata."""

    child: np.ndarray   # int32[cap] — absolute index of first child, 0 = leaf
    mask: np.ndarray    # int32[cap] — 16-bit leaf mask (2 bits x 8 children)
    value: np.ndarray   # int32[cap] — material id (0 = air)
    normal: np.ndarray  # int32[cap] — digit-packed normal (surface leaves)
    n_nodes: int
    world_size: int     # voxel resolution spanned by the root cube

    @property
    def capacity(self) -> int:
        return int(np.asarray(self.child).shape[0])

    def child_tag(self, parent: int, k: int) -> int:
        """2-bit type tag of child k (Octree.java:589-599)."""
        return (int(self.mask[parent]) >> (2 * k)) & 3

    def child_index(self, parent: int, k: int) -> int:
        return int(self.child[parent]) + k

    def node_counts(self) -> dict:
        """Node-type census (Octree.printNodeCounts, Octree.java:1018-1026):
        each child of a node with children counts under its tag in the
        parent's mask; the root counts as interior."""
        child = np.asarray(self.child[:self.n_nodes])
        mask = np.asarray(self.mask[:self.n_nodes]).astype(np.int64)
        m = mask[np.nonzero(child)[0]]
        tags = ((m[:, None] >> (2 * np.arange(8))) & 3).reshape(-1)
        n = np.bincount(tags, minlength=4)
        return {"interior": 1 + int(n[C.TAG_BRANCH]),
                "surface_leaf": int(n[C.TAG_SURFACE_LEAF]),
                "non_surface_leaf": int(n[C.TAG_NON_SURFACE_LEAF]),
                "subdividable_leaf": int(n[C.TAG_SUBDIV_LEAF])}

    def arrays(self):
        return self.child, self.mask, self.value, self.normal

    def to_numpy(self) -> "Octree":
        return self

    def to_device(self, device, pad_to: int | None = None) -> "DeviceOctree":
        """The table as int32 tensors on ``device``: the first ``n_nodes``
        slots, zero-padded up to ``pad_to`` slots when that is larger (the
        JAX package's ``to_device(pad_to=)``)."""
        cap = self.n_nodes if pad_to is None else max(pad_to, self.n_nodes)

        def put(a):
            out = np.zeros(cap, np.int32)
            out[:self.n_nodes] = np.asarray(a)[:self.n_nodes]
            return torch.from_numpy(out).to(device)

        return DeviceOctree(put(self.child), put(self.mask), put(self.value),
                            put(self.normal), self.n_nodes, self.world_size)


def empty(capacity: int, world_size: int) -> Octree:
    """A one-node octree: interior root with no children (value 1), as the
    reference's dummy head (Octree.java:97-100)."""
    z = [np.zeros(capacity, np.int32) for _ in range(4)]
    z[2][ROOT] = 1
    return Octree(*z, n_nodes=1, world_size=world_size)


def from_reference(child, mask, value, normal, n_nodes: int,
                   world_size: int) -> Octree:
    """An Octree from the JAX package's node arrays (NumPy, any capacity):
    the first ``n_nodes`` slots, as int32."""
    def take(a):
        a = np.asarray(a)
        if a.shape[0] < n_nodes:
            raise ValueError(f"array of {a.shape[0]} slots < n_nodes "
                             f"{n_nodes}")
        return np.ascontiguousarray(a[:n_nodes], np.int32)

    return Octree(take(child), take(mask), take(value), take(normal),
                  int(n_nodes), int(world_size))


@dataclasses.dataclass
class DeviceOctree:
    """The node table as (capacity,) int32 tensors on one device: slots
    past ``n_nodes`` are zero padding."""

    child: torch.Tensor
    mask: torch.Tensor
    value: torch.Tensor
    normal: torch.Tensor
    n_nodes: int
    world_size: int
    _packed: torch.Tensor | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.child.device

    @property
    def capacity(self) -> int:
        return self.child.numel()

    def arrays(self):
        """(child, mask, value, normal), as the JAX package's arrays()."""
        return self.child, self.mask, self.value, self.normal

    def to_numpy(self) -> Octree:
        """The table copied to the host (timed as ``svo.to_numpy``,
        utils/profiling)."""
        with timer("svo.to_numpy"):
            return Octree(*(a.cpu().numpy() for a in self.arrays()),
                          n_nodes=self.n_nodes, world_size=self.world_size)

    def packed_table(self, refresh: bool = False) -> torch.Tensor:
        """The traversal's word table (ops/traverse.make_packed_table),
        built at the first call and cached: pass it to render and
        intersect calls as ``packed=``.  Whoever writes to the tensors in
        place rebuilds the cache with ``refresh=True``
        (runtime/renderer.DeviceTree does after every upload)."""
        if self._packed is None or refresh:
            from ..ops.traverse import make_packed_table

            self._packed = make_packed_table(self)
        return self._packed


def effective_normal_raw(tag, child_base, mask, normal):
    """The raw 16-bit field the shader decodes as a hit node's normal
    (svotrace.comp:88-130): a surface leaf's packed normal, 0 for a
    non-surface leaf, else (branches, subdividable leaves) the node's
    mask, stale for promoted leaves.  Elementwise over NumPy arrays or
    tensors; ``child_base`` is unused, as in the JAX package."""
    if isinstance(tag, torch.Tensor):
        zero = torch.zeros_like(mask)
        return torch.where(tag == C.TAG_SURFACE_LEAF, normal,
                           torch.where(tag == C.TAG_NON_SURFACE_LEAF, zero,
                                       mask))
    tag = np.asarray(tag)
    return np.where(tag == C.TAG_SURFACE_LEAF, normal,
                    np.where(tag == C.TAG_NON_SURFACE_LEAF, 0, mask))
