"""Row-sharded ESVO rendering and training over a process mesh (port of
svo_raytracer_tpu/parallel/render_sharded.py).

The image's rows are cut into contiguous bands over the mesh's ``tiles``
axis; the octree (a DeviceOctree, with its packed table) and the voxel
parameters are replicated on every rank.  Each rank traces its band
(kernel KE on the card, in the band's 8x4 pixel tiles) and the bands are
all-gathered, so every rank returns the whole image.  A train step sums
each rank's squared error and parameter gradients over ``tiles``, so
every rank applies the same update to its copy of the parameters.
"""

from __future__ import annotations

import functools

import torch

from ..diff import render_diff as rd
from ..ops import shade, traverse
from ..utils import constants as C

_SHADE = {1: shade.shade_heatmap, 2: shade.shade_direct,
          3: shade.shade_normals}


def row_band(mesh, height: int) -> tuple[int, int]:
    """(first row, rows) of this rank's contiguous band over ``tiles``."""
    n = mesh.size("tiles")
    if height % n:
        raise ValueError(f"height {height} must divide over {n} tiles")
    rows = height // n
    return mesh.rank("tiles") * rows, rows


def band_rays(cam5, width, height, row0, rows, unit):
    """(origins, unit dirs) of image rows [row0, row0 + rows), row-major;
    ``unit`` normalizes the rows (both choices root through ops/fp.py's
    correctly rounded sqrt)."""
    dirs = unit(shade.pixel_dirs_rows(cam5, width, height, row0, rows))
    return cam5[0].expand_as(dirs), dirs


def sgd_sum(params, grads, lr, denom):
    """params - lr * grads / denom, table by table, as the JAX package's
    sharded steps write it (``grads`` of a summed loss); the division is
    a true division on either device."""
    d = torch.tensor(float(denom), dtype=torch.float32,
                     device=params[0].device)
    return type(params)(*(p - (lr * g) / d for p, g in zip(params, grads)))


def make_sharded_render(mesh, width: int, height: int, render_mode=2,
                        max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Full-frame render with rows sharded over the ``tiles`` axis.

    Returns ``render(tree, cam5, packed=None) -> (H, W, 3)``, the whole
    image on every rank; ``packed`` is the tree's cached packed table
    (DeviceOctree.packed_table by default).  Modes 1, 2 and 3; mode 0 is
    refused, as in the JAX package."""
    if render_mode not in _SHADE:
        raise ValueError("sharded render supports modes 1/2/3")
    row0, rows = row_band(mesh, height)
    shade_fn = _SHADE[render_mode]

    def render(tree, cam5, packed=None):
        cam5 = cam5.to(torch.float32)
        origins, dirs = band_rays(cam5, width, height, row0, rows,
                                  shade._normalize)
        isect = functools.partial(
            traverse.intersect_octree, tree,
            packed=tree.packed_table() if packed is None else packed,
            order=traverse.tile_order(width, rows, cam5.device))
        col, _, _ = shade_fn(None, origins, dirs,
                             max_iterations=max_iterations,
                             intersect_fn=isect)
        return mesh.all_gather(col.reshape(rows, width, 3),
                               "tiles").reshape(height, width, 3)

    return render


def make_sharded_train_step(mesh, width: int, height: int, lr: float = 0.5,
                            max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Differentiable-render SGD step with rows sharded over ``tiles``.

    Returns ``step(params, tree, cam5, target, packed=None) -> (params,
    loss)``.  ``target`` is the whole (H, W, 3) image; each rank reads its
    band.  Each rank's summed squared error and its gradients (render_diff's
    model: index_select gathers, sun_light) are summed over ``tiles``; the
    loss is that sum over H*W*3 and the update p - lr * g / (H*W*3), the
    same on every rank."""
    row0, rows = row_band(mesh, height)
    denom = height * width * 3

    def step(params, tree, cam5, target, packed=None):
        cam5 = cam5.to(torch.float32)
        origins, dirs = band_rays(cam5, width, height, row0, rows,
                                  rd.d_unit)
        res = traverse.intersect_octree(
            tree, origins, dirs, max_iterations=max_iterations,
            packed=tree.packed_table() if packed is None else packed,
            order=traverse.tile_order(width, rows, cam5.device))
        target_rows = target.to(torch.float32)[row0:row0 + rows]

        def local_sum(p):
            col = rd.shade_hits(p, res, dirs).reshape(rows, width, 3)
            return torch.sum((col - target_rows) ** 2)

        loss, grads = rd.loss_and_grads(local_sum, params)
        grads = type(grads)(*(mesh.psum(g, "tiles", inplace=True)
                              for g in grads))
        loss = mesh.psum(loss, "tiles") / float(denom)
        return sgd_sum(params, grads, lr, denom), loss

    return step
