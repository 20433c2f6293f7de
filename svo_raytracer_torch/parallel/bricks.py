"""Octree brick sharding: the world's octree cut into sub-octrees spread
over ranks (port of svo_raytracer_tpu/parallel/bricks.py).

The octree is cut at octant level L into 8**L *bricks*: standalone
sub-octrees, each re-rooted to span the canonical [1,2]^3 cube.  The
mesh's ``bricks`` axis holds them in contiguous blocks (rank j of the
axis: bricks j*B/n .. (j+1)*B/n - 1, as ``P("bricks")`` lays out axis 0),
and every rank traverses each ray only through its own bricks.  Bricks
tile space disjointly, so the ESVO walk restricted to one brick finds the
first hit in that brick, and the global first hit is the nearest brick
hit: a ``pmin``/``psum`` combine over ``bricks``.

Geometry (exact in float32 up to one rounding at + 1.0): brick b at level
L owns ``corner_b + [0, 2^-L]^3``; a world ray (o, d) becomes the brick
ray ((o - corner_b) * 2^L + 1, d), and brick distances scale back by
2^-L.  Each brick is traced by kernel KE on the card (its DeviceOctree
and packed table built once, when the set goes to the device), with
``max_depth - L``.  The LOD heuristics that key on absolute t (the cone
clamp) fire at brick distances: a deviation the JAX package documents
too.

:func:`split_bricks` is the JAX package's host split with its subtree
copy (a FIFO breadth-first walk) done level by level in NumPy: the FIFO
visits nodes in level order, parent by parent, octant by octant, so a
level-synchronous gather lays out every slot as the walk does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.octree import ROOT, Octree
from ..diff import render_diff as rd
from ..ops import shade, traverse
from ..ops.hit import HitResult
from ..utils import constants as C
from .render_sharded import band_rays, row_band, sgd_sum

_FIELDS = ("child", "mask", "value", "normal", "orig")


@dataclasses.dataclass
class BrickSet:
    """8**level standalone sub-octrees in one stacked host SoA (axis 0 =
    brick).  ``orig`` maps each brick slot to its node index in the
    source tree (pad slots map to 0), so parameter gathers keep
    addressing the source tree's table."""

    child: np.ndarray    # int32[B, cap]
    mask: np.ndarray     # int32[B, cap]
    value: np.ndarray    # int32[B, cap]
    normal: np.ndarray   # int32[B, cap]
    orig: np.ndarray     # int32[B, cap] — brick slot -> source node index
    corners: np.ndarray  # float32[B, 3] — brick cube min corner
    n_nodes: np.ndarray  # int32[B]
    level: int
    world_size: int

    @property
    def n_bricks(self) -> int:
        return int(self.child.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.child.shape[1])

    def arrays(self):
        return self.child, self.mask, self.value, self.normal

    @classmethod
    def from_reference(cls, ref) -> "BrickSet":
        """The JAX package's BrickSet (its arrays through np.asarray, on
        the host or a device) as the port's."""
        arrs = {f: np.ascontiguousarray(np.asarray(getattr(ref, f)),
                                        np.int32) for f in _FIELDS}
        shape = arrs["child"].shape
        corners = np.asarray(ref.corners)
        n_nodes = np.asarray(ref.n_nodes)
        if (len(shape) != 2 or any(a.shape != shape for a in arrs.values())
                or corners.shape != (shape[0], 3)
                or n_nodes.shape != (shape[0],)):
            raise ValueError(f"brick arrays of shapes "
                             f"{[a.shape for a in arrs.values()]}, corners "
                             f"{corners.shape}, n_nodes {n_nodes.shape}")
        return cls(**arrs, corners=corners.astype(np.float32),
                   n_nodes=n_nodes.astype(np.int32), level=int(ref.level),
                   world_size=int(ref.world_size))

    def shard(self, mesh) -> range:
        """The bricks of this rank's block along the mesh's ``bricks``
        axis."""
        nb = mesh.size("bricks")
        if self.n_bricks % nb:
            raise ValueError(f"{self.n_bricks} bricks cannot shard over "
                             f"{nb}-way axis")
        per = self.n_bricks // nb
        j = mesh.rank("bricks")
        return range(j * per, (j + 1) * per)

    def to_device(self, device, mesh=None) -> "DeviceBricks":
        """The bricks of this rank's block (``mesh``; None: all of them)
        on ``device``, each as a DeviceOctree with its packed table."""
        ids = range(self.n_bricks) if mesh is None else self.shard(mesh)
        trees, packed, orig = [], [], []
        for b in ids:
            t = Octree(self.child[b], self.mask[b], self.value[b],
                       self.normal[b], n_nodes=int(self.n_nodes[b]),
                       world_size=self.world_size >> self.level)
            trees.append(t.to_device(device, pad_to=self.capacity))
            packed.append(trees[-1].packed_table())
            orig.append(torch.from_numpy(self.orig[b].copy()).to(device))
        return DeviceBricks(
            trees=trees, packed=packed, orig=orig,
            corners=torch.from_numpy(self.corners[list(ids)].copy()).to(
                device),
            ids=tuple(ids), level=self.level, n_bricks=self.n_bricks)


@dataclasses.dataclass
class DeviceBricks:
    """Some bricks of a BrickSet on one device (``ids``: their brick
    indices): each brick's DeviceOctree, packed table and slot -> source
    node map, and the (n, 3) float32 corners."""

    trees: list
    packed: list
    orig: list
    corners: torch.Tensor
    ids: tuple
    level: int
    n_bricks: int


def _extract_subtree(t: Octree, root_old: int):
    """The subtree under branch node ``root_old`` as a fresh table (slot 0
    = the new root, the 8 children of a branch in contiguous slots), slot
    for slot the JAX package's FIFO breadth-first copy: one gather per
    level.  Returns (child, mask, value, normal, orig) int32 arrays."""
    child = np.asarray(t.child)
    mask = np.asarray(t.mask)
    orig = [np.asarray([root_old], np.int64)]
    parents, bases = [], []
    n = 1
    front_old = orig[0] if child[root_old] != 0 else orig[0][:0]
    front_new = np.zeros(front_old.size, np.int64)
    octs = np.arange(8)
    while front_old.size:
        parents.append(front_new)
        bases.append(n + 8 * np.arange(front_old.size))
        kids = (child[front_old][:, None].astype(np.int64)
                + octs).reshape(-1)
        tags = ((mask[front_old][:, None] >> (2 * octs)) & 3).reshape(-1)
        new = n + np.arange(kids.size)
        orig.append(kids)
        n += kids.size
        go = (tags == C.TAG_BRANCH) & (child[kids] != 0)
        front_old, front_new = kids[go], new[go]
    orig = np.concatenate(orig)
    nc = np.zeros(n, np.int32)
    for p, b in zip(parents, bases):
        nc[p] = b
    return (nc, mask[orig].astype(np.int32),
            np.asarray(t.value)[orig].astype(np.int32),
            np.asarray(t.normal)[orig].astype(np.int32),
            orig.astype(np.int32))


def _leaf_brick(t: Octree, node: int, tag: int):
    """A brick for a path that ended on a homogeneous leaf: a made-up root
    branch whose 8 children repeat the leaf's payload (value, packed
    normal, stale mask: the effective_normal_raw quirk).  Hits land one
    level finer than in the unsplit tree (a half-size hit cube), which
    moves only the scale_exp2-derived offsets of hit_pos/voxel_pos."""
    value = int(t.value[node])
    normal = int(t.normal[node])
    mask = int(t.mask[node])
    tag = C.TAG_NON_SURFACE_LEAF if tag == C.TAG_BRANCH else tag
    root_mask = 0
    for k in range(8):
        root_mask |= tag << (2 * k)
    nc = np.array([1] + [0] * 8, np.int32)
    nm = np.array([root_mask] + [mask] * 8, np.int32)
    nv = np.array([value] + [value] * 8, np.int32)
    nn = np.array([0] + [normal] * 8, np.int32)
    norig = np.full(9, node, np.int32)
    return nc, nm, nv, nn, norig


def split_bricks(tree, level: int = 1, pad_multiple: int = 128) -> BrickSet:
    """Cut ``tree`` (an Octree or DeviceOctree) at octant level ``level``
    into 8**level bricks on the host, padded to a common capacity (a
    multiple of ``pad_multiple``).  Brick order follows the child-octant
    bit order bit0 = +x, bit1 = +y, bit2 = +z at each level."""
    t = tree.to_numpy()
    bricks, corners = [], []

    def rec(node, tag, is_leaf, corner, half, lvl):
        if lvl == level:
            bricks.append(_leaf_brick(t, node, tag) if is_leaf
                          else _extract_subtree(t, node))
            corners.append(corner)
            return
        for k in range(8):
            off = C.CHILD_OFFSETS[k]
            sub = (corner[0] + off[0] * half, corner[1] + off[1] * half,
                   corner[2] + off[2] * half)
            if is_leaf:
                rec(node, tag, True, sub, half / 2, lvl + 1)
                continue
            ctag = (int(t.mask[node]) >> (2 * k)) & 3
            c = int(t.child[node]) + k
            rec(c, ctag, ctag != C.TAG_BRANCH or t.child[c] == 0, sub,
                half / 2, lvl + 1)

    rec(ROOT, C.TAG_BRANCH, int(t.child[ROOT]) == 0, (1.0, 1.0, 1.0), 0.5,
        0)
    n_nodes = np.asarray([b[0].shape[0] for b in bricks], np.int32)
    cap = -(-int(n_nodes.max()) // pad_multiple) * pad_multiple

    def stack(i):
        out = np.zeros((len(bricks), cap), np.int32)
        for b, arrs in enumerate(bricks):
            out[b, :arrs[i].shape[0]] = arrs[i]
        return out

    return BrickSet(*(stack(i) for i in range(5)),
                    corners=np.asarray(corners, np.float32), n_nodes=n_nodes,
                    level=level, world_size=t.world_size)


def _combine_local(a: HitResult, b: HitResult) -> HitResult:
    """Nearest-hit merge of two HitResults (the earlier one wins ties)."""
    inf = torch.full_like(a.t, float("inf"))
    take_b = torch.where(b.hit, b.t, inf) < torch.where(a.hit, a.t, inf)

    def sel(x, y):
        m = take_b[:, None] if x.dim() > 1 else take_b
        return torch.where(m, y, x)

    return HitResult(
        hit=a.hit | b.hit, value=sel(a.value, b.value), t=sel(a.t, b.t),
        iters=a.iters + b.iters, scale_exp2=sel(a.scale_exp2, b.scale_exp2),
        depth=sel(a.depth, b.depth), normal=sel(a.normal, b.normal),
        hit_pos=sel(a.hit_pos, b.hit_pos),
        voxel_pos=sel(a.voxel_pos, b.voxel_pos), node=sel(a.node, b.node))


def _combine_ranks(best: HitResult, mesh) -> HitResult:
    """The nearest hit over the mesh's ``bricks`` axis: pmin of t, then
    pmin of the rank among the nearest (the lowest rank, which holds the
    earlier bricks, wins ties), then the winner's fields by a psum of
    fields masked to the winner (floats in one collective, ints in
    another), and the psum of iters.  Misses everywhere keep this rank's
    t and give node -1."""
    inf = torch.full_like(best.t, float("inf"))
    t_or_inf = torch.where(best.hit, best.t, inf)
    t_best = mesh.pmin(t_or_inf, "bricks")
    mine = best.hit & (t_or_inf == t_best)
    rank = torch.where(mine, torch.full_like(best.iters, mesh.rank("bricks")),
                       torch.full_like(best.iters, mesh.size("bricks")))
    win = mine & (rank == mesh.pmin(rank, "bricks"))
    w = win[:, None]
    floats = torch.cat([best.scale_exp2[:, None], best.normal, best.hit_pos,
                        best.voxel_pos], dim=1)
    floats = mesh.psum(torch.where(w, floats, torch.zeros_like(floats)),
                       "bricks", inplace=True)
    node = torch.where(best.node < 0, torch.zeros_like(best.node), best.node)
    ints = torch.stack([best.value, best.depth, node], dim=1)
    ints = torch.cat([torch.where(w, ints, torch.zeros_like(ints)),
                      best.iters[:, None].to(ints.dtype)], dim=1)
    ints = mesh.psum(ints, "bricks", inplace=True)
    hit = torch.isfinite(t_best)
    return HitResult(
        hit=hit, value=ints[:, 0], t=torch.where(hit, t_best, best.t),
        iters=ints[:, 3], scale_exp2=floats[:, 0], depth=ints[:, 1],
        normal=floats[:, 1:4], hit_pos=floats[:, 4:7],
        voxel_pos=floats[:, 7:10],
        node=torch.where(hit, ints[:, 2], torch.full_like(ints[:, 2], -1)))


def make_brick_intersect(bricks: DeviceBricks, mesh=None):
    """An ``intersect_fn`` (traverse.intersect_octree's signature minus
    the tree, plus its ``order``) over the bricks on this rank, combined
    over the mesh's ``bricks`` axis; with ``mesh=None`` the combine is
    over these bricks alone (one device holding every brick).  Each
    brick is one KE launch on the card."""
    level = bricks.level
    scale = float(2.0 ** level)
    inv_scale = float(2.0 ** -level)

    def intersect(origins, dirs, max_depth=C.MAX_DEPTH, cone_trace=False,
                  max_iterations=C.MAX_RAYCAST_ITERATIONS, active=None,
                  stack_depth=C.MAX_DEPTH, order=None):
        best = None
        for i, tree in enumerate(bricks.trees):
            corner = bricks.corners[i]
            o_l = (origins - corner[None, :]) * scale + 1.0
            res = traverse.intersect_octree(
                tree, o_l, dirs, max_depth=max_depth - level,
                cone_trace=cone_trace, max_iterations=max_iterations,
                active=active, stack_depth=stack_depth,
                packed=bricks.packed[i], order=order)
            local = torch.where(res.hit, res.node, torch.zeros_like(res.node))
            node_g = torch.where(res.hit, bricks.orig[i][local.long()],
                                 torch.full_like(res.node, -1))
            t_g = res.t * inv_scale
            se_g = res.scale_exp2 * inv_scale
            hit_pos = (origins + t_g[:, None] * dirs
                       + res.normal * (se_g * 2)[:, None])
            # the brick's voxel_pos holds its normal offset in brick
            # units; rescaling the whole vector rescales the offset too
            voxel_pos = corner[None, :] + (res.voxel_pos - 1.0) * inv_scale
            res_g = HitResult(
                hit=res.hit, value=res.value, t=t_g, iters=res.iters,
                scale_exp2=se_g, depth=res.depth + level, normal=res.normal,
                hit_pos=hit_pos, voxel_pos=voxel_pos, node=node_g)
            best = res_g if best is None else _combine_local(best, res_g)
        return best if mesh is None else _combine_ranks(best, mesh)

    return intersect


def _check_grid(mesh, bricks: BrickSet, height):
    """Rows per ``tiles`` rank (the whole image without that axis);
    raises unless the bricks divide over ``bricks``."""
    if bricks.n_bricks % mesh.size("bricks"):
        raise ValueError(f"{bricks.n_bricks} bricks cannot shard over "
                         f"{mesh.size('bricks')}-way axis")
    if "tiles" in mesh.axis_names:
        return row_band(mesh, height)
    return 0, height


def _check_shard(mesh, bricks: DeviceBricks, n_bricks):
    if bricks.n_bricks != n_bricks:
        raise ValueError(f"bricks of a {bricks.n_bricks}-brick set, the "
                         f"render was made for {n_bricks}")
    nb, j = mesh.size("bricks"), mesh.rank("bricks")
    per = n_bricks // nb
    if bricks.ids != tuple(range(j * per, (j + 1) * per)):
        raise ValueError(f"rank {j} of the bricks axis holds bricks "
                         f"{bricks.ids}, not its block")


def _shade_rows(intersect_fn, cam5, width, height, row0, rows, render_mode,
                frame_number, gi_bounces, max_iterations):
    """Image rows [row0, row0 + rows) shaded in ``render_mode`` through
    ``intersect_fn`` (KE in the rows' 8x4 pixel tiles)."""
    dev = cam5.device
    origins, dirs = band_rays(cam5, width, height, row0, rows,
                              shade._normalize)
    order = traverse.tile_order(width, rows, dev)

    def isect(o, d, **kw):
        return intersect_fn(o, d, order=order, **kw)

    kw = dict(max_iterations=max_iterations, intersect_fn=isect)
    if render_mode == 0:
        px = torch.arange(width, dtype=torch.float32, device=dev).repeat(rows)
        py = (torch.arange(rows, dtype=torch.float32, device=dev)
              + float(row0)).repeat_interleave(width)
        col, _, _ = shade.shade_gi(None, origins, dirs, px, py, frame_number,
                                   gi_bounces=gi_bounces, **kw)
    elif render_mode == 1:
        col, _, _ = shade.shade_heatmap(None, origins, dirs, **kw)
    elif render_mode == 2:
        col, _, _ = shade.shade_direct(None, origins, dirs, **kw)
    elif render_mode == 3:
        col, _, _ = shade.shade_normals(None, origins, dirs, **kw)
    else:
        raise ValueError(f"unknown render mode {render_mode}")
    return col.reshape(rows, width, 3)


def make_brick_render(mesh, bricks: BrickSet, width: int, height: int,
                      render_mode: int = 2, frame_number: int = 1,
                      gi_bounces: int = 1,
                      max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Full-frame render with the octree brick-sharded over the mesh's
    ``bricks`` axis and, when the mesh has one, rows over ``tiles``.

    Returns ``render(device_bricks, cam5) -> (H, W, 3)``, the whole image
    on every rank; ``device_bricks`` is this rank's block,
    ``bricks.to_device(device, mesh)``.  Each rank traces its rows
    through each of its bricks in turn and the nearest hit is combined
    over ``bricks``."""
    row0, rows = _check_grid(mesh, bricks, height)
    n_bricks = bricks.n_bricks

    def render(device_bricks: DeviceBricks, cam5):
        _check_shard(mesh, device_bricks, n_bricks)
        isect = make_brick_intersect(device_bricks, mesh)
        col = _shade_rows(isect, cam5.to(torch.float32), width, height, row0,
                          rows, render_mode, frame_number, gi_bounces,
                          max_iterations)
        if "tiles" not in mesh.axis_names:
            return col
        return mesh.all_gather(col, "tiles").reshape(height, width, 3)

    return render


def make_brick_train_step(mesh, bricks: BrickSet, width: int, height: int,
                          lr: float = 0.5,
                          max_iterations: int = C.MAX_RAYCAST_ITERATIONS):
    """Differentiable-render SGD step with the octree brick-sharded (and
    rows over ``tiles`` when the mesh has that axis).

    Parameters stay replicated and aligned to the *source* tree's nodes:
    the brick intersect returns source node ids (the ``orig`` map), so
    the gather and its backward scatter address the source table.  The
    combine over ``bricks`` gives every rank of that axis the same hits,
    so gradients are summed over ``tiles`` only, and each rank then
    applies those of its ``bricks`` group's first rank.  Returns
    ``step(params, device_bricks, cam5, target) -> (params, loss)``."""
    row0, rows = _check_grid(mesh, bricks, height)
    n_bricks = bricks.n_bricks
    has_tiles = "tiles" in mesh.axis_names
    denom = height * width * 3

    def step(params, device_bricks: DeviceBricks, cam5, target):
        _check_shard(mesh, device_bricks, n_bricks)
        cam5 = cam5.to(torch.float32)
        origins, dirs = band_rays(cam5, width, height, row0, rows, rd.d_unit)
        res = make_brick_intersect(device_bricks, mesh)(
            origins, dirs, max_iterations=max_iterations,
            order=traverse.tile_order(width, rows, cam5.device))
        target_rows = target.to(torch.float32)[row0:row0 + rows]

        def local_sum(p):
            col = rd.shade_hits(p, res, dirs).reshape(rows, width, 3)
            return torch.sum((col - target_rows) ** 2)

        loss, grads = rd.loss_and_grads(local_sum, params)
        if has_tiles:
            grads = type(grads)(*(mesh.psum(g, "tiles", inplace=True)
                                  for g in grads))
            loss = mesh.psum(loss, "tiles")
        # the ranks of a bricks group hold the same hits, but index_add_
        # on the card sums in no fixed order: every rank takes the
        # gradients of the group's first rank (a psum of them and zeros)
        # so that all ranks keep the same parameters
        first = mesh.rank("bricks") == 0
        grads = type(grads)(*(mesh.psum(g if first else torch.zeros_like(g),
                                        "bricks", inplace=True)
                              for g in grads))
        return sgd_sum(params, grads, lr, denom), loss / float(denom)

    return step


def intersect_bricks_local(bricks: DeviceBricks, origins, dirs, **kw):
    """One device, every brick: traverse each and merge.  Equals
    traverse.intersect_octree on the unsplit tree up to the rounding of t
    and the finer hit cube of _leaf_brick: the oracle of the sharded
    path."""
    return make_brick_intersect(bricks)(origins, dirs, **kw)
