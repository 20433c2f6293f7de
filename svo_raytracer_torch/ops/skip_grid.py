"""Empty-space skip grid: a per-ray coarse DDA that seeds the ESVO
traversal (port of svo_raytracer_tpu/ops/skip_grid.py).

The reference shortens fine rays with a coarse beam prepass that itself
walks the octree (svobeam.comp:618-636).  Here a G^3 occupancy grid (G <=
64, one bit per cell) is marched per ray by kernel K2 (ops/brick_dda.py)
to find a conservative entry distance to the first possibly-solid cell.
Rays whose march leaves the grid without meeting an occupied cell are
definite misses and skip the ESVO traversal entirely.

Grid <-> world mapping: the octree spans the world cube [1,2]^3, so cell
(i,j,k) spans 1 + i/G .. 1 + (i+1)/G per axis, and a distance t_g in grid
units is t_g / G along the same direction vector in world units.
"""

from __future__ import annotations

import numpy as np
import torch

from . import brick_dda
from .brick_scene import pack_occupancy

#: world-unit margin backed off the conservative entry distance before
#: restarting ESVO: the DDA's own entry nudge (1e-4 grid units) and float
#: re-parameterization slop
EPS_WORLD = float(np.float32(1e-4))


def build_skip_grid(tree, grid_size: int = 32) -> np.ndarray:
    """Occupancy of a G^3 cell grid from the SoA node table (host NumPy;
    ``tree`` is an Octree or a DeviceOctree).

    A cell is occupied iff its world cube holds any non-air leaf.  The walk
    descends level by level only to cell size: an air leaf marks nothing, a
    solid leaf marks its whole span, and a branch left at cell size marks
    its cell (the builders collapse homogeneous regions into leaves, so a
    branch holds solid somewhere).  Returns the packed words of
    ``brick_scene.pack_occupancy``; ``brick_scene.table_rows`` lays them
    out for :func:`skip_distances`."""
    n = tree.n_nodes

    def host(a):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a[:n]

    child, value = host(tree.child), host(tree.value)
    G = grid_size
    ws = tree.world_size
    if ws < G:
        G = ws  # worlds smaller than the grid: one cell per voxel
    cell = ws // G
    occ = np.zeros((G, G, G), bool)

    nodes = np.array([0], np.int64)
    xs = ys = zs = np.array([0], np.int64)  # frontier origins, cell units
    size = ws  # voxels spanned by a frontier node
    while True:
        span = size // cell
        is_branch = child[nodes] != 0
        solid_leaf = ~is_branch & (value[nodes] != 0)
        if span <= 1:
            hit = is_branch | solid_leaf
            occ[xs[hit], ys[hit], zs[hit]] = True
            break
        for xi, yi, zi in zip(xs[solid_leaf], ys[solid_leaf],
                              zs[solid_leaf]):
            occ[xi:xi + span, yi:yi + span, zi:zi + span] = True
        if not is_branch.any():
            break
        bn = nodes[is_branch]
        k = np.arange(8, dtype=np.int64)
        nodes = (child[bn][:, None] + k[None, :]).reshape(-1)
        half = span // 2
        xs = (xs[is_branch][:, None] + (k & 1) * half).reshape(-1)
        ys = (ys[is_branch][:, None] + ((k >> 1) & 1) * half).reshape(-1)
        zs = (zs[is_branch][:, None] + ((k >> 2) & 1) * half).reshape(-1)
        size //= 2
    return pack_occupancy(occ)


def skip_distances(occ_table, origins, dirs, grid_size=32, active=None):
    """(skip_t, maybe_hit): the world-unit skip distance along ``dirs`` and
    a conservative may-hit mask of world-space rays."""
    G = grid_size
    o_g = (origins.to(torch.float32) - 1.0) * float(G)
    out = brick_dda.coarse_dda(occ_table, o_g, dirs, grid_size=G,
                               active=active)
    skip = torch.clamp_min(out["t"] / float(G) - EPS_WORLD, 0.0)
    return torch.where(out["hit"], skip, torch.zeros_like(skip)), out["hit"]


def make_skipping_isect(isect, occ_table, grid_size=32):
    """Wrap a traversal ``isect(origins, dirs, ..., active=...)`` with the
    DDA skip: each ray's origin moves forward by its skip distance,
    definite misses leave the batch, and the skip is added back onto
    ``t`` (``hit_pos`` and ``voxel_pos`` come from the moved origin and
    need no fix-up).  The skip is conservative, so hits equal the
    unskipped traversal's up to restarted-ray float variance."""

    def wrapped(origins, dirs, *args, active=None, **kwargs):
        skip, maybe = skip_distances(occ_table, origins, dirs,
                                     grid_size=grid_size, active=active)
        act = maybe if active is None else maybe & active
        o2 = origins + skip[:, None] * dirs
        res = isect(o2, dirs, *args, active=act, **kwargs)
        return res._replace(t=torch.where(res.hit, res.t + skip, res.t))

    return wrapped
