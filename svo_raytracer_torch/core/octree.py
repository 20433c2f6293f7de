"""Sparse-voxel-octree node table (host NumPy; the fields of
svo_raytracer_tpu/core/octree.py that the brick decomposition reads).

  child[i]  : absolute node index of child 0 (0 == no children / leaf payload)
  mask[i]   : 16-bit leaf mask, 2 bits per child (tags in utils/constants)
  value[i]  : material id, 0 = air
  normal[i] : digit-packed surface normal for surface leaves

A branch's 8 children occupy 8 contiguous slots, so child k of node p is
``child[p] + k``; its type is the 2-bit tag ``(mask[p] >> 2k) & 3``.

:class:`DeviceOctree` is the same table as four int32 tensors on one
device (``Octree.to_device``), the form the ESVO traversal reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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

    def to_device(self, device) -> "DeviceOctree":
        """The first ``n_nodes`` slots as int32 tensors on ``device``
        (svo_raytracer_tpu Octree.to_device + arrays)."""
        def put(a):
            return torch.from_numpy(
                np.array(np.asarray(a)[:self.n_nodes], np.int32)).to(device)

        return DeviceOctree(put(self.child), put(self.mask), put(self.value),
                            put(self.normal), self.n_nodes, self.world_size)


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
    """The node table as (n_nodes,) int32 tensors on one device."""

    child: torch.Tensor
    mask: torch.Tensor
    value: torch.Tensor
    normal: torch.Tensor
    n_nodes: int
    world_size: int

    @property
    def device(self) -> torch.device:
        return self.child.device

    def arrays(self):
        """(child, mask, value, normal), as the JAX package's arrays()."""
        return self.child, self.mask, self.value, self.normal

    def to_numpy(self) -> Octree:
        return Octree(*(a.cpu().numpy() for a in self.arrays()),
                      n_nodes=self.n_nodes, world_size=self.world_size)
