"""Sparse-voxel-octree node table (host NumPy; the fields of
svo_raytracer_tpu/core/octree.py that the brick decomposition reads).

  child[i]  : absolute node index of child 0 (0 == no children / leaf payload)
  mask[i]   : 16-bit leaf mask, 2 bits per child (tags in utils/constants)
  value[i]  : material id, 0 = air
  normal[i] : digit-packed surface normal for surface leaves

A branch's 8 children occupy 8 contiguous slots, so child k of node p is
``child[p] + k``; its type is the 2-bit tag ``(mask[p] >> 2k) & 3``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
