"""The reference world: a dense voxel grid made from the configuration, and
the attributes of a hit voxel worked out from the grid alone.

The terrain is generated chunk by chunk by the frozen noise copy
(``noise.sample_perlin_terrain``) at the configuration's world and chunk
sizes, with the terrain band centred at y = 0 (bench.py's world offset).
What a hit reports besides its distance follows the octree the reference
renderer builds for each chunk (Octree.java:511-670):

* a chunk is split until a cell is homogeneous; a homogeneous solid cell
  above voxel size stays a leaf unless one of its 27 corner probes
  (coordinates c - 1, c + s, c + s + 1 on each axis, inside the chunk)
  is air, in which case it is split further; the chunk's root is always
  split;
* a voxel leaf is a surface leaf when its 3^3 neighbourhood inside the
  chunk holds air; its normal is the digit-packed air gradient
  ``(trunc((air(+x) - air(-x)) / 2) + 5) + 10 * (... y) + 100 * (... z)``
  over the 3x3 sums of the neighbouring planes; every other leaf reports
  the raw normal 0;
* the hit's depth is that of its leaf below the world's root.

So a hit's normal, depth and cube corner come from the grid, not from any
table of the system under test.  The walk (``walk.py``) reads the three
occupancy levels kept here: 32^3 bricks, 2^3 cells and voxels.
"""

from __future__ import annotations

import math

import torch

from . import noise

BRICK = 32


class World:
    """Dense ``(W, W, W)`` uint8 voxels (x, y, z) of the configured world on
    ``device``, with brick and cell occupancy and per-level homogeneity."""

    def __init__(self, world_size: int, chunk_size: int, device,
                 slab: int = 64):
        if world_size % chunk_size or world_size < BRICK:
            raise ValueError(f"world {world_size} in chunks of {chunk_size}")
        self.W, self.C = world_size, chunk_size
        self.device = torch.device(device)
        W, C = world_size, chunk_size
        vox = torch.empty((W, W, W), dtype=torch.uint8, device=self.device)
        ax = torch.arange(C, dtype=torch.int32, device=self.device)
        oy = -W // 2
        for cx in range(0, W, C):
            for cy in range(0, W, C):
                for cz in range(0, W, C):
                    x = ax[:, None, None] + cx
                    y = ax[None, :, None] + cy + oy
                    z = ax[None, None, :] + cz
                    vox[cx:cx + C, cy:cy + C, cz:cz + C] = \
                        noise.sample_perlin_terrain(x, y, z, slab=slab)
        self.vox = vox
        self.solid_cell = _fold_any(vox != 0, 2)
        self.solid_brick = _fold_any(self.solid_cell, BRICK // 2)
        # min and max value of the aligned cells of edge s, s = 2 .. C/2
        self.levels = {}
        mn = mx = vox
        s = 1
        while s < C // 2:
            s *= 2
            mn, mx = _fold(mn, torch.amin), _fold(mx, torch.amax)
            self.levels[s] = (mn, mx)

    @property
    def depth_bits(self) -> int:
        return int(math.log2(self.W))

    def solid(self, v):
        """Voxel values at (n, 3) int64 coordinates inside the world."""
        x, y, z = v.unbind(1)
        return self.vox[x, y, z]

    def _air(self, v, inside):
        """1 where an in-chunk coordinate holds air, else 0."""
        W = self.W
        c = v.clamp(0, W - 1)
        return ((self.vox[c[:, 0], c[:, 1], c[:, 2]] == 0) & inside).to(
            torch.int32)

    def hit_attrs(self, v):
        """(value, raw normal, depth) of the leaves holding the solid voxels
        at (n, 3) int64 world coordinates ``v``."""
        C = self.C
        n = v.shape[0]
        dev = v.device
        lo = (v // C) * C          # the voxel's chunk
        depth = torch.full((n,), self.depth_bits, dtype=torch.int64,
                           device=dev)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        offs = torch.tensor([-1, 0, 1], device=dev)
        for s in sorted(self.levels, reverse=True):
            mn, mx = self.levels[s]
            c = v // s
            homog = (mn[c[:, 0], c[:, 1], c[:, 2]]
                     == mx[c[:, 0], c[:, 1], c[:, 2]])
            base = c * s - lo                   # chunk-local cell corner
            probe = torch.stack([base - 1, base + s, base + s + 1], 2)
            valid = (probe >= 0) & (probe < C)   # (n, 3 axes, 3 probes)
            exposed = torch.zeros(n, dtype=torch.bool, device=dev)
            for a in range(3):
                for b in range(3):
                    for k in range(3):
                        p = torch.stack([probe[:, 0, a], probe[:, 1, b],
                                         probe[:, 2, k]], 1)
                        ok = valid[:, 0, a] & valid[:, 1, b] & valid[:, 2, k]
                        exposed |= self._air(p + lo, ok).bool()
            leaf = ~done & homog & ~exposed
            depth = torch.where(leaf, self.depth_bits - int(math.log2(s)),
                                depth)
            done |= leaf
        # voxel leaves: the air neighbourhood inside the chunk
        air = torch.zeros((n, 3, 3, 3), dtype=torch.int32, device=dev)
        for i, dx in enumerate(offs.tolist()):
            for j, dy in enumerate(offs.tolist()):
                for k, dz in enumerate(offs.tolist()):
                    p = v + torch.tensor([dx, dy, dz], device=dev)
                    loc = p - lo
                    inside = ((loc >= 0) & (loc < C)).all(1)
                    air[:, i, j, k] = self._air(p, inside)
        exposed = air.sum((1, 2, 3)) > 0
        gx = _trunc_half(air[:, 2].sum((1, 2)) - air[:, 0].sum((1, 2))) + 5
        gy = _trunc_half(air[:, :, 2].sum((1, 2)) - air[:, :, 0].sum((1, 2))) + 5
        gz = _trunc_half(air[:, :, :, 2].sum((1, 2))
                         - air[:, :, :, 0].sum((1, 2))) + 5
        packed = gx + 10 * gy + 100 * gz
        raw = torch.where(~done & exposed, packed, torch.zeros_like(packed))
        value = self.solid(v).to(torch.int64)
        return value, raw, depth


def _fold(a, op):
    n = a.shape[0] // 2
    return op(a.view(n, 2, n, 2, n, 2), dim=(1, 3, 5))


def _fold_any(a, f):
    n = a.shape[0] // f
    return a.view(n, f, n, f, n, f).any(5).any(3).any(1)


def _trunc_half(a):
    """Integer division by 2 toward zero (Java's ``/``)."""
    return torch.where(a < 0, -((-a) // 2), a // 2)
