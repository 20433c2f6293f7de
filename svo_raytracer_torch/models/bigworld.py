"""Direct heightmap -> BrickScene construction (port of
svo_raytracer_tpu/models/bigworld.py, host NumPy).

A heightmap world's bricks are a closed-form function of the column
heights, so the scene is built without an octree:

  * per brick column, hmin/hmax over the 32x32 footprint classify each
    brick as uniform-air / uniform-stone / mixed (solid iff
    wy <= h = int(hm/65536*height_scale); the top 4 voxels take the
    material map, below is stone = 1);
  * mixed bricks rasterize vectorized in batches;
  * exposed voxels (top faces, and side faces above a neighbour column's
    top) carry a digit-packed normal from the height gradient.

:func:`fractal_heightmap` makes a seeded value-noise terrain for worlds
that have no source heightmap (the port's smoke scene).
"""

from __future__ import annotations

import numpy as np

from ..ops import brick_scene

BRICK = 32


def _pack_normal_digits(nx, ny, nz):
    """Vectorized Util.java:140-146 digit packing (trunc like Java)."""

    def digit(v):
        return (np.trunc(np.trunc(v * 9) / 2) + 5).astype(np.int64)

    return digit(nx) + 10 * digit(ny) + 100 * digit(nz)


def heightmap_brick_scene(hm, mm, world_size: int,
                          height_scale: int | None = None,
                          batch: int = 2048) -> brick_scene.BrickScene:
    """Build a BrickScene for a heightmap world of ``world_size`` voxels.

    hm: (world_size, world_size) uint16 heightmap; mm: same-shape int
    material ids (clipped to [0, 3]).
    """
    ws = world_size
    G = ws // BRICK
    if height_scale is None:
        height_scale = ws // 2
    if hm.shape != (ws, ws):
        raise ValueError(f"heightmap shape {hm.shape} != ({ws}, {ws})")
    full_depth = int(np.log2(ws))

    h = (hm.astype(np.float64) / 65536.0 * height_scale).astype(np.int64)
    m = np.clip(mm.astype(np.int64), 0, 3)

    # column gradient -> unit normal (y up); used by every exposed voxel
    dhx = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) / 2.0
    dhz = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) / 2.0
    dhx[0, :] = h[1, :] - h[0, :]
    dhx[-1, :] = h[-1, :] - h[-2, :]
    dhz[:, 0] = h[:, 1] - h[:, 0]
    dhz[:, -1] = h[:, -1] - h[:, -2]
    nlen = np.sqrt(dhx * dhx + 4.0 + dhz * dhz)
    raw_col = _pack_normal_digits(-dhx / nlen, 2.0 / nlen, -dhz / nlen)

    # a voxel's side faces are exposed above the lowest neighbour column
    hnb = np.minimum.reduce([np.roll(h, 1, 0), np.roll(h, -1, 0),
                             np.roll(h, 1, 1), np.roll(h, -1, 1)])

    # ---- per-brick-column classification -------------------------------
    hb = h.reshape(G, BRICK, G, BRICK)
    hmin = hb.min(axis=(1, 3))          # (G, G) per brick column
    hmax = hb.max(axis=(1, 3))

    # h arrays are (x, z); hmin[:, None, :] broadcast against the (1, by, 1)
    # layer index gives (bx, by, bz), the flat cell id (bx*G + by)*G + bz
    by = np.arange(G, dtype=np.int64)[None, :, None]  # brick y layer
    top = (by + 1) * BRICK - 1
    bot = by * BRICK
    # uniform stone: every voxel solid AND below the material band
    uni_stone = top <= (hmin[:, None, :] - 5)
    air = bot > hmax[:, None, :]
    mixed = ~uni_stone & ~air

    stone_depth = full_depth - 5        # brick-size leaf
    flat_attr = np.zeros(G * G * G, np.int64)
    flat_attr[uni_stone.reshape(-1)] = 1 | (stone_depth << 24)
    mixed_cells = np.nonzero(mixed.reshape(-1))[0].astype(np.int64)
    n_mixed = len(mixed_cells)
    brick_slot = np.full(G * G * G, -1, np.int32)
    brick_slot[mixed_cells] = np.arange(n_mixed, dtype=np.int32)

    # ---- rasterize mixed bricks in batches -----------------------------
    attrs = np.zeros((max(n_mixed, 1), 32768), np.int32)
    occ_words = np.zeros((max(n_mixed, 1), 8, 128), np.int32)
    off = np.arange(BRICK, dtype=np.int64)
    for b0 in range(0, n_mixed, batch):
        cells = mixed_cells[b0:b0 + batch]
        nb = len(cells)
        bx = cells // (G * G)
        byy = (cells // G) % G
        bz = cells % G
        # world x/z coords of the 32x32 footprint: (nb, 32)
        wx = bx[:, None] * BRICK + off[None, :]
        wz = bz[:, None] * BRICK + off[None, :]
        hcol = h[wx[:, :, None], wz[:, None, :]]        # (nb, 32, 32)
        mcol = m[wx[:, :, None], wz[:, None, :]]
        rcol = raw_col[wx[:, :, None], wz[:, None, :]]
        nbcol = hnb[wx[:, :, None], wz[:, None, :]]
        wy = (byy[:, None] * BRICK + off[None, :])      # (nb, 32)
        # voxel grid axes: (nb, x, y, z)
        hc = hcol[:, :, None, :]
        solid = wy[:, None, :, None] <= hc
        near = (hc - wy[:, None, :, None]) <= 4
        value = np.where(solid, np.where(near, mcol[:, :, None, :], 1), 0)
        exposed = solid & ((wy[:, None, :, None] == hc)
                           | (wy[:, None, :, None] > nbcol[:, :, None, :]))
        raw = np.where(exposed, rcol[:, :, None, :], 0)
        attr = np.where(solid,
                        value | (raw << 8)
                        | (np.int64(full_depth) << 24), 0)
        attrs[b0:b0 + nb] = attr.reshape(nb, 32768).astype(np.int32)
        occ_words[b0:b0 + nb] = brick_scene.occupancy_words(
            attrs[b0:b0 + nb])

    l0 = (flat_attr != 0) | (brick_slot >= 0)
    l0_table = brick_scene.table_rows(
        brick_scene.pack_occupancy(l0.reshape(G, G, G)))
    return brick_scene.BrickScene(
        world_size=ws, grid_size=G, n_mixed=n_mixed,
        l0_table=l0_table, brick_slot=brick_slot,
        brick_attr=flat_attr.astype(np.int32),
        occ_words=occ_words, attrs=attrs.reshape(max(n_mixed, 1), 256,
                                                 128))


def fractal_heightmap(size: int, seed: int, lo: float = 0.05,
                      hi: float = 0.5):
    """Seeded fractal value-noise terrain: ((size, size) uint16 heightmap,
    (size, size) int material map) for :func:`heightmap_brick_scene`.

    Octave k (of 6) is a (8 * 2^k + 1)^2 lattice of uniform randoms,
    smoothstep-interpolated to ``size`` and weighted 0.7^k; the sum is
    rescaled to [lo, hi] of the uint16 range (a raised ``lo`` buries the
    bottom bricks as uniform stone).  Materials: grass (3) below 60% of
    the relief, scree (2) above.  At size 1024 the defaults give 3,100-
    3,500 mixed bricks (seeds 1-8), the class of the bench's procgen
    terrain (4,589).
    """
    rng = np.random.default_rng(seed)
    x = (np.arange(size, dtype=np.float64) + 0.5) / size
    acc = np.zeros((size, size))
    for k in range(6):
        n = 8 << k
        lat = rng.uniform(0.0, 1.0, (n + 1, n + 1))
        p = x * n
        i = np.minimum(p.astype(np.int64), n - 1)
        f = p - i
        f = f * f * (3.0 - 2.0 * f)
        rows = lat[i] * (1.0 - f)[:, None] + lat[i + 1] * f[:, None]
        acc += 0.7 ** k * (rows[:, i] * (1.0 - f)[None, :]
                           + rows[:, i + 1] * f[None, :])
    acc = (acc - acc.min()) / max(acc.max() - acc.min(), 1e-12)
    hm = ((lo + (hi - lo) * acc) * 65535.0).astype(np.uint16)
    mm = np.where(acc < 0.6, 3, 2).astype(np.int64)
    return hm, mm
