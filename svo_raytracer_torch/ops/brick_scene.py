"""Brick decomposition of the octree — the scene format of the wavefront
traversal (port of svo_raytracer_tpu/ops/brick_scene.py).

  * an L0 occupancy grid of (world/32)^3 brick cells;
  * per *mixed* brick (one containing leaves smaller than the brick): a
    32^3 occupancy bitfield (1024 i32 words) and a 32^3 per-voxel
    attribute table (32768 i32 words);
  * *uniform* bricks (fully covered by one leaf — air or solid) carry a
    single attribute word and no payload.

Attribute word per voxel (i32): ``value | raw_normal << 8 | depth << 24``
(``raw_normal`` is the tag-dependent 16-bit field the reference shader
decodes as a normal; ``depth`` the leaf's depth below the root).

Scene preprocessing is host NumPy, one-time per scene; the arrays equal
the JAX package's exactly (tests/test_torch_scene.py).  After an edit,
:func:`brickify_patch` recomputes only the bricks the edit's box touches
(tests/test_torch_patch.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.octree import effective_normal_raw
from ..utils import constants as C
from ..utils.profiling import timer

BRICK = 32  # voxels per brick edge
LANES = 128


def pack_occupancy(vox: np.ndarray) -> np.ndarray:
    """Pack a (G,G,G) boolean/int occupancy grid into z-packed u32 words.

    Returns int32 (G*G*ceil(G/32),) — word ``(x*G + y)*W + (z >> 5)`` holds
    bit ``z & 31`` of column (x, y) (svo_raytracer_tpu
    brick_dda.pack_occupancy).
    """
    vox = np.asarray(vox) != 0
    G = vox.shape[0]
    if vox.shape != (G, G, G):
        raise ValueError(f"occupancy grid must be cubic, got {vox.shape}")
    W = -(-G // 32)
    words = np.zeros((G, G, W), np.uint32)
    for z in range(G):
        words[:, :, z // 32] |= (vox[:, :, z].astype(np.uint32)
                                 << np.uint32(z % 32))
    return words.reshape(-1).view(np.int32)


def table_rows(words) -> np.ndarray:
    """(V,) packed words -> (ceil(V/128), 128) i32 rows, zero-padded
    (svo_raytracer_tpu brick_dda.table_rows, in NumPy)."""
    w = np.asarray(words, np.int32)
    pad = (-w.shape[0]) % LANES
    if pad:
        w = np.pad(w, (0, pad))
    return w.reshape(-1, LANES)


@dataclasses.dataclass
class BrickScene:
    """Brick decomposition of one octree scene: NumPy arrays on the host,
    or int32 tensors on a device after :meth:`to_device`."""

    world_size: int          # voxel resolution of the world cube [1,2]^3
    grid_size: int           # bricks per edge (world_size // 32)
    n_mixed: int
    l0_table: np.ndarray     # (rows,128) i32 — packed brick-occupancy words
    brick_slot: np.ndarray   # (G^3,) i32 — mixed-brick slot, -1 if uniform
    brick_attr: np.ndarray   # (G^3,) i32 — uniform attr (value 0 => air)
    occ_words: np.ndarray    # (n_mixed, 8, 128) i32 — 32^3 occupancy bits
    attrs: np.ndarray        # (n_mixed, 256, 128) i32 — per-voxel attr words

    ARRAYS = ("l0_table", "brick_slot", "brick_attr", "occ_words", "attrs")

    def to_device(self, device) -> BrickScene:
        """The same scene with its arrays as contiguous int32 tensors on
        ``device`` (the JAX package's BrickScene.to_device)."""
        import torch
        return dataclasses.replace(self, **{
            name: torch.as_tensor(np.ascontiguousarray(getattr(self, name),
                                                       np.int32)).to(device)
            for name in self.ARRAYS})


def _attr_word(value, raw_normal, depth):
    return (value.astype(np.int64) & 0xFF) | ((raw_normal.astype(np.int64)
                                               & 0xFFFF) << 8) \
        | (depth.astype(np.int64) << 24)


def _leaf_attr(value, normal, mask, nodes, tags, depth):
    """Attribute word(s) of leaf nodes (module docstring encoding)."""
    raw = effective_normal_raw(tags, None, mask[nodes], normal[nodes])
    return _attr_word(value[nodes], raw,
                      np.asarray(depth, np.int64) * np.ones(len(nodes),
                                                            np.int64)
                      if np.ndim(depth) == 0 else depth)


def _raster_subtrees(child, mask, value, normal, roots, brick_depth,
                     brick: int = BRICK):
    """Rasterize brick-level branch subtrees to (n, brick^3) attr words.

    ``roots``: (n,) node indices of brick-level BRANCH nodes;
    ``brick_depth``: their depth below the root.  Level-synchronous
    vectorized descent."""
    n = len(roots)
    attrs = np.zeros((n, brick * brick * brick), np.int32)
    if n == 0:
        return attrs
    k = np.arange(8, dtype=np.int64)
    nodes = np.asarray(roots, np.int64)
    tags = np.full(n, C.TAG_BRANCH, np.int64)
    slots = np.arange(n, dtype=np.int64)
    lx = np.zeros(n, np.int64)
    ly = np.zeros(n, np.int64)
    lz = np.zeros(n, np.int64)
    span = brick
    depth = brick_depth
    while True:
        is_branch = (tags == C.TAG_BRANCH) & (child[nodes] != 0)
        leaf = ~is_branch
        if leaf.any():
            attr = _leaf_attr(value, normal, mask, nodes[leaf], tags[leaf],
                              depth)
            base = ((lx[leaf] * brick + ly[leaf]) * brick + lz[leaf]
                    + slots[leaf] * brick**3)
            off = np.arange(span, dtype=np.int64)
            o3 = (off[:, None, None] * brick * brick
                  + off[None, :, None] * brick + off[None, None, :]
                  ).reshape(-1)
            attrs.reshape(-1)[(base[:, None] + o3[None, :]).reshape(-1)] \
                = np.repeat(attr, span ** 3).astype(np.int32)
        if span == 1 or not is_branch.any():
            break
        bn = nodes[is_branch]
        bs = slots[is_branch]
        bx, by, bz = lx[is_branch], ly[is_branch], lz[is_branch]
        nodes = (child[bn][:, None] + k[None, :]).reshape(-1)
        tags = ((mask[bn][:, None] >> (2 * k[None, :])) & 3).reshape(-1)
        slots = np.repeat(bs, 8)
        half = span // 2
        lx = (bx[:, None] + (k[None, :] & 1) * half).reshape(-1)
        ly = (by[:, None] + ((k[None, :] >> 1) & 1) * half).reshape(-1)
        lz = (bz[:, None] + ((k[None, :] >> 2) & 1) * half).reshape(-1)
        span //= 2
        depth += 1
    return attrs


def occupancy_words(attrs, brick: int = BRICK):
    """(n, brick^3) attr words -> (n, 8, 128) z-packed occupancy bits
    (word (x*32 + y), bit z — the layout of :func:`pack_occupancy`)."""
    n = attrs.shape[0]
    solid = (attrs & 0xFF) != 0
    vox = solid.reshape(n, brick, brick, brick)
    w = np.zeros((n, brick, brick), np.uint32)
    for z in range(brick):
        w |= vox[:, :, :, z].astype(np.uint32) << np.uint32(z)
    return w.reshape(n, 8, 128).view(np.int32)


def brickify(tree, brick: int = BRICK) -> BrickScene:
    """Decompose an Octree (host SoA) into the brick scene format.

    The descent mirrors the child addressing of the SoA table (child base +
    octant k; tag = 2 bits of the parent's mask).  Worlds smaller than one
    brick are rejected.  Timed as ``svo.brickify`` (utils/profiling).
    """
    with timer("svo.brickify"):
        return _brickify(tree, brick)


def _brickify(tree, brick):
    child = np.asarray(tree.child[:tree.n_nodes]).astype(np.int64)
    mask = np.asarray(tree.mask[:tree.n_nodes]).astype(np.int64)
    value = np.asarray(tree.value[:tree.n_nodes]).astype(np.int64)
    normal = np.asarray(tree.normal[:tree.n_nodes]).astype(np.int64)
    ws = tree.world_size
    if ws % brick or ws < brick:
        raise ValueError(f"world_size {ws} not a multiple of brick {brick}")
    G = ws // brick

    def leaf_attr(nodes, tags, depth):
        return _leaf_attr(value, normal, mask, nodes, tags,
                          np.full(nodes.shape, depth, np.int64))

    # ---- pass 1: descend to brick level --------------------------------
    uni = np.zeros(G * G * G, np.int64)       # uniform attr per brick cell
    mixed_cell: list[np.ndarray] = []         # flat brick cell ids
    mixed_node: list[np.ndarray] = []         # subtree roots (branch nodes)

    nodes = np.array([0], np.int64)
    tags = np.array([C.TAG_BRANCH], np.int64)
    xs = np.zeros(1, np.int64)
    ys = np.zeros(1, np.int64)
    zs = np.zeros(1, np.int64)
    span = ws
    depth = 0
    k = np.arange(8, dtype=np.int64)

    while True:
        is_branch = (tags == C.TAG_BRANCH) & (child[nodes] != 0)
        if span == brick:
            leaf = ~is_branch
            cell = (xs * G + ys) * G + zs
            uni[cell[leaf]] = leaf_attr(nodes[leaf], tags[leaf], depth)
            mixed_cell.append(cell[is_branch])
            mixed_node.append(nodes[is_branch])
            break
        # leaves above brick level cover span/brick whole bricks
        leaf = ~is_branch
        if leaf.any():
            sb = span // brick
            attr = leaf_attr(nodes[leaf], tags[leaf], depth)
            off = np.arange(sb, dtype=np.int64)
            cx = xs[leaf][:, None] + off[None, :]            # (L, sb)
            cy = ys[leaf][:, None] + off[None, :]
            cz = zs[leaf][:, None] + off[None, :]
            cells = ((cx[:, :, None, None] * G + cy[:, None, :, None]) * G
                     + cz[:, None, None, :]).reshape(len(attr), -1)
            uni[cells.reshape(-1)] = np.repeat(attr, sb * sb * sb)
        if not is_branch.any():
            break
        bn = nodes[is_branch]
        bx, by, bz = xs[is_branch], ys[is_branch], zs[is_branch]
        nodes = (child[bn][:, None] + k[None, :]).reshape(-1)
        tags = ((mask[bn][:, None] >> (2 * k[None, :])) & 3).reshape(-1)
        half = (span // brick) // 2
        xs = (bx[:, None] + (k[None, :] & 1) * half).reshape(-1)
        ys = (by[:, None] + ((k[None, :] >> 1) & 1) * half).reshape(-1)
        zs = (bz[:, None] + ((k[None, :] >> 2) & 1) * half).reshape(-1)
        span //= 2
        depth += 1

    mixed_cell = (np.concatenate(mixed_cell) if mixed_cell
                  else np.zeros(0, np.int64))
    mixed_node = (np.concatenate(mixed_node) if mixed_node
                  else np.zeros(0, np.int64))
    n_mixed = len(mixed_cell)

    slot_map = np.full(G * G * G, -1, np.int32)
    slot_map[mixed_cell] = np.arange(n_mixed, dtype=np.int32)

    # ---- pass 2: rasterize mixed subtrees to 32^3 voxels ----------------
    nm = max(n_mixed, 1)
    attrs = np.zeros((nm, brick * brick * brick), np.int32)
    if n_mixed:
        attrs[:n_mixed] = _raster_subtrees(child, mask, value, normal,
                                           mixed_node, depth, brick)
    occ_words = occupancy_words(attrs, brick)

    l0_occ = ((uni & 0xFF) != 0) | (slot_map >= 0)
    l0_table = table_rows(pack_occupancy(l0_occ.reshape(G, G, G)))

    return BrickScene(
        world_size=ws, grid_size=G, n_mixed=n_mixed,
        l0_table=l0_table,
        brick_slot=slot_map,
        brick_attr=uni.astype(np.int32),
        occ_words=occ_words,
        attrs=attrs.reshape(nm, 256, 128),
    )


@dataclasses.dataclass
class ScenePatch:
    """What an edit changed in a BrickScene (:func:`brickify_patch`)."""

    cells: np.ndarray      # (m,) flat brick cells touched
    cell_slot: np.ndarray  # (m,) new slot per cell (-1 = uniform)
    cell_attr: np.ndarray  # (m,) new uniform attr per cell (0 if mixed)
    upd_slots: np.ndarray  # (p,) slots whose payload rows changed
    occ_rows: np.ndarray   # (p, 8, 128)
    attr_rows: np.ndarray  # (p, 256, 128)
    n_mixed: int           # mixed count after the patch


def brickify_patch(tree, scene: BrickScene, vmin, vmax,
                   brick: int = BRICK) -> ScenePatch:
    """Recompute the bricks overlapping the voxel box [vmin, vmax] after an
    edit, update the host ``scene`` in place and return what changed
    (svo_raytracer_tpu brick_scene.brickify_patch; the incremental analog
    of the reference's ranged SSBO update, Octree.java:676-698 +
    Main.java:349-350).

    A brick that turns mixed takes a new slot at the end of the arena; a
    mixed brick that turns uniform orphans its slot (the arena only grows,
    like the reference's tombstoned subtrees, Octree.java:954-956); a full
    :func:`brickify` reclaims them."""
    child = np.asarray(tree.child[:tree.n_nodes]).astype(np.int64)
    mask = np.asarray(tree.mask[:tree.n_nodes]).astype(np.int64)
    value = np.asarray(tree.value[:tree.n_nodes]).astype(np.int64)
    normal = np.asarray(tree.normal[:tree.n_nodes]).astype(np.int64)
    G = scene.grid_size
    lo = np.clip(np.asarray(vmin) // brick, 0, G - 1)
    hi = np.clip(np.asarray(vmax) // brick, 0, G - 1)
    cx, cy, cz = (a.reshape(-1) for a in np.meshgrid(
        *(np.arange(lo[i], hi[i] + 1) for i in range(3)), indexing="ij"))
    m = len(cx)

    # per-cell walk root -> brick level (octant addressing as in brickify)
    node = np.zeros(m, np.int64)
    tag = np.full(m, C.TAG_BRANCH, np.int64)
    ox = np.zeros(m, np.int64)
    oy = np.zeros(m, np.int64)
    oz = np.zeros(m, np.int64)
    fdepth = np.zeros(m, np.int64)
    leafed = np.zeros(m, bool)
    span, depth = G, 0
    while span > 1:
        is_branch = (tag == C.TAG_BRANCH) & (child[node] != 0)
        newly = ~is_branch & ~leafed
        fdepth[newly] = depth
        leafed |= ~is_branch
        half = span // 2
        kx = ((cx - ox) >= half).astype(np.int64)
        ky = ((cy - oy) >= half).astype(np.int64)
        kz = ((cz - oz) >= half).astype(np.int64)
        k = kx | (ky << 1) | (kz << 2)
        new_tag = (mask[node] >> (2 * k)) & 3
        node = np.where(is_branch, child[node] + k, node)
        tag = np.where(is_branch, new_tag, tag)
        span, depth = half, depth + 1
        ox = ox + np.where(is_branch, kx * half, 0)
        oy = oy + np.where(is_branch, ky * half, 0)
        oz = oz + np.where(is_branch, kz * half, 0)
    is_branch = (tag == C.TAG_BRANCH) & (child[node] != 0)
    newly = ~is_branch & ~leafed
    fdepth[newly] = depth
    mixed = is_branch

    flat = (cx * G + cy) * G + cz
    uni_attr = np.zeros(m, np.int64)
    if (~mixed).any():
        uni_attr[~mixed] = _leaf_attr(value, normal, mask, node[~mixed],
                                      tag[~mixed], fdepth[~mixed])

    prev = scene.brick_slot[flat].astype(np.int64)
    need_new = mixed & (prev < 0)
    slot = np.where(mixed, prev, -1)
    slot[need_new] = scene.n_mixed + np.arange(need_new.sum())
    n_mixed2 = scene.n_mixed + int(need_new.sum())

    attrs_m = _raster_subtrees(child, mask, value, normal, node[mixed],
                               depth, brick)
    occ_m = occupancy_words(attrs_m, brick)

    # in-place host-scene update
    scene.brick_slot[flat] = slot.astype(np.int32)
    scene.brick_attr[flat] = np.where(mixed, 0, uni_attr).astype(np.int32)
    grow = n_mixed2 - scene.occ_words.shape[0]
    if grow > 0:
        scene.occ_words = np.concatenate(
            [scene.occ_words, np.zeros((grow, 8, 128), np.int32)])
        scene.attrs = np.concatenate(
            [scene.attrs, np.zeros((grow, 256, 128), np.int32)])
    upd = slot[mixed]
    scene.occ_words[upd] = occ_m
    scene.attrs[upd] = attrs_m.reshape(-1, 256, 128)
    scene.n_mixed = n_mixed2
    l0_occ = (((scene.brick_attr & 0xFF) != 0) | (scene.brick_slot >= 0))
    scene.l0_table = table_rows(pack_occupancy(l0_occ.reshape(G, G, G)))

    return ScenePatch(cells=flat.astype(np.int32),
                      cell_slot=slot.astype(np.int32),
                      cell_attr=np.where(mixed, 0, uni_attr).astype(np.int32),
                      upd_slots=upd.astype(np.int32), occ_rows=occ_m,
                      attr_rows=attrs_m.reshape(-1, 256, 128),
                      n_mixed=n_mixed2)
