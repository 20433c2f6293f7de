"""Device-resident octree with incremental uploads — the Renderer.java
analog (port of svo_raytracer_tpu/runtime/renderer.py).

The reference's L1 runtime wraps GL buffers: create, full update and
ranged update of the node SSBO (``Renderer.java:43-150``).  Here the
buffer is the DeviceOctree's four int32 tensors, padded to a capacity so
an edit that appends nodes writes into them in place, and a ranged
update copies only the edit's two dirty slot windows.  The ESVO engine
also reads the packed node words (DeviceOctree.packed_table); the cache
is rebuilt on the device after every upload, so a frame never packs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.octree import Octree
from ..core.sdf import ChangeBounds


class DeviceTree:
    """Padded device mirror of a host octree.  ``last_upload`` holds the
    bytes the last upload copied to the device and whether it was a full
    one."""

    def __init__(self, tree: Octree, device, min_capacity: int = 1 << 16,
                 slack: float = 2.0):
        self._slack = slack
        self.device = torch.device(device)
        self.full_upload(tree, capacity=max(
            min_capacity, int(tree.to_numpy().n_nodes * slack)))

    @property
    def capacity(self) -> int:
        return self.dev.capacity

    @property
    def n_nodes(self) -> int:
        return self.dev.n_nodes

    def arrays(self):
        return self.dev.arrays()

    @property
    def packed(self) -> torch.Tensor:
        """The device octree's cached packed words (one cache, so every
        renderer of ``self.dev`` reads the uploaded table)."""
        return self.dev.packed_table()

    def _repack(self):
        self.dev.packed_table(refresh=True)

    def full_upload(self, tree: Octree, capacity: int | None = None) -> None:
        """Whole-buffer upload (addSSBO/updateSSBO full variants,
        Renderer.java:123-134), growing the capacity when the tree has
        outgrown it."""
        self.host = tree.to_numpy()
        cap = self.capacity if capacity is None else capacity
        if self.host.n_nodes > cap:
            cap = max(int(self.host.n_nodes * self._slack), cap * 2)
        self.dev = self.host.to_device(self.device, pad_to=cap)
        self._repack()
        self.last_upload = dict(full=True, bytes=4 * 4 * cap)

    def ranged_update(self, tree: Octree, cb: ChangeBounds) -> None:
        """Copy only the two dirty windows (updateSSBO ranged variant,
        Renderer.java:136-146; called like Main.java:349-350).  A tree
        that outgrew the capacity gets a growing full upload."""
        host = tree.to_numpy()
        if host.n_nodes > self.capacity:
            self.full_upload(tree)
            return
        self.host = host
        nbytes = 0
        for d, h in zip(self.dev.arrays(), host.arrays()):
            for lo, hi in ((cb.start0, cb.end0), (cb.start1, cb.end1)):
                if hi > lo:
                    d[lo:hi].copy_(torch.from_numpy(
                        np.ascontiguousarray(h[lo:hi], np.int32)))
                    nbytes += 4 * (hi - lo)
        self.dev.n_nodes = host.n_nodes
        self._repack()
        self.last_upload = dict(full=False, bytes=nbytes)
