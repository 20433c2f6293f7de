"""The XLA brick reference engine, and the hit-record decode and direction
clamp shared by the brick engines (port of
svo_raytracer_tpu/ops/brick_trace.py).

:func:`intersect_bricks` traces rays against a BrickScene as a two-level
Amanatides-Woo DDA: phase A marches the (world/32)^3 brick grid (L0
occupancy) to the next occupied brick, where a uniform-solid brick is a
hit on its entry face; phase B marches the 32^3 voxels of a mixed brick,
and an exit re-enters phase A, up to ``max_rounds`` rounds.  It is the
JAX package's plain-array engine, written op for op in PyTorch on the
scene's device: each march runs its fixed step count over the whole batch
with per-ray masks, and the only host synchronisation is the test whether
any ray is still alive, once per round.  It shares no code with kernel K1
(ops/wavefront.py) or K3 (ops/brick_pallas.py), so it serves as their
independent oracle.  Its ``iters`` counts DDA steps, not K1's coarse
steps, and its ``node`` is -1.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp
from .hit import HitResult

#: nudge (voxel units) pushing a ray past a brick boundary before the next
#: round (brick_trace.py _EXIT_EPS)
EXIT_EPS = float(np.float32(1.0 / 1024.0))

# 1e-4, in lock-step with wavefront._DIR_EPS: smaller clamps let
# near-axis rays livelock below the f32 ulp of a 1024-scale coordinate
DIR_EPS = float(np.float32(1e-4))


def _clamp_dir(d):
    """Components with |d| < 1e-4 become +-1e-4; -0.0 takes +1e-4."""
    eps = torch.full_like(d, DIR_EPS)
    return torch.where(d.abs() < DIR_EPS, torch.where(d >= 0, eps, -eps), d)


def decode_hits(ws, origins, dirs, hit, attr, vx, vy, vz, t_vox, iters,
                node=None):
    """Assemble a HitResult from brick-path hit records.

    attr: packed value|raw_normal<<8|depth<<24; (vx,vy,vz): global voxel
    coords of the hit voxel; t_vox: hit distance in voxel units along
    ``dirs``.  Raw normal 555 decodes to the zero vector and normalizes to
    NaN — the reference shader's behaviour, kept on purpose.
    """
    value = attr & 0xFF
    raw = (attr >> 8) & 0xFFFF
    depth = (attr >> 24) & 0x1F
    nx = ((raw % 10) - 5).float()
    ny = (((raw % 100) - (raw % 10)) // 10 - 5).float()
    nz = ((raw - (raw % 100)) // 100 - 5).float()
    nlen = fp.sqrt(nx * nx + ny * ny + nz * nz)
    has_n = raw != 0
    zero = torch.zeros_like(nx)
    nx = torch.where(has_n, nx / nlen, zero)
    ny = torch.where(has_n, ny / nlen, zero)
    nz = torch.where(has_n, nz / nlen, zero)
    normal = torch.stack([nx, ny, nz], dim=-1)

    t = t_vox / float(ws)
    scale_exp2 = torch.exp2(-depth.float())
    span = torch.full_like(depth, ws) >> depth.clamp(0, 30)
    span = span.clamp_min(1)
    cx = torch.div(vx, span, rounding_mode="floor") * span
    cy = torch.div(vy, span, rounding_mode="floor") * span
    cz = torch.div(vz, span, rounding_mode="floor") * span
    corner = torch.stack([cx, cy, cz], dim=-1).float() / float(ws) + 1.0
    voxel_pos = corner + normal * (scale_exp2 * 2 * 1.74)[:, None]
    o = origins.float()
    d = dirs.float()
    hit_pos = o + t[:, None] * d + normal * (scale_exp2 * 2)[:, None]

    value = torch.where(hit, value, torch.zeros_like(value))
    return HitResult(
        hit=hit, value=value, t=t, iters=iters, scale_exp2=scale_exp2,
        depth=torch.where(hit, depth, torch.zeros_like(depth)),
        normal=normal, hit_pos=hit_pos, voxel_pos=voxel_pos,
        node=(torch.full_like(vx, -1) if node is None else node),
    )


def _march(pos, d, extent, cell, probe, max_steps, active):
    """Amanatides-Woo DDA over cells of edge ``cell`` in [0, extent]^3
    (brick_trace.py _march): ``max_steps`` masked steps of every ray.

    pos/d: (x, y, z) tuples of (B,) float32 tensors; ``probe(ix, iy, iz)``
    gives the solid mask of cells.  Returns (hit, ix, iy, iz, t, inside,
    steps): ``t`` is the entry distance (along d, in pos units) of the hit
    cell, or of the last crossing when none was hit; ``inside`` whether
    the ray is still inside the grid."""
    ox, oy, oz = pos
    dx, dy, dz = (_clamp_dir(c) for c in d)
    inv_x, inv_y, inv_z = 1.0 / dx, 1.0 / dy, 1.0 / dz
    n = extent // cell
    gf = float(extent)

    # slab test: advance rays from outside the box to its entry
    t1x, t2x = (0.0 - ox) * inv_x, (gf - ox) * inv_x
    t1y, t2y = (0.0 - oy) * inv_y, (gf - oy) * inv_y
    t1z, t2z = (0.0 - oz) * inv_z, (gf - oz) * inv_z
    t_ent = torch.maximum(torch.maximum(torch.minimum(t1x, t2x),
                                        torch.minimum(t1y, t2y)),
                          torch.minimum(t1z, t2z))
    t_exit = torch.minimum(torch.minimum(torch.maximum(t1x, t2x),
                                         torch.maximum(t1y, t2y)),
                           torch.maximum(t1z, t2z))
    zero = torch.zeros_like(t_ent)
    t0 = torch.maximum(t_ent, zero)
    misses_box = (t_ent > t_exit) | (t_exit < 0.0)
    push = torch.where(t0 > 0.0, t0 + float(np.float32(1e-4) * cell), zero)
    px, py, pz = ox + push * dx, oy + push * dy, oz + push * dz

    def first_cell(p):
        return (p / float(cell)).to(torch.int32).clamp(0, n - 1)

    ix, iy, iz = first_cell(px), first_cell(py), first_cell(pz)
    one = torch.ones_like(ix)
    sx, sy, sz = (torch.where(c > 0, one, -one) for c in (dx, dy, dz))

    def next_t(c, i, p, inv):
        edge = torch.where(c > 0, i + 1, i).float() * float(cell)
        return push + (edge - p) * inv

    tx, ty, tz = next_t(dx, ix, px, inv_x), next_t(dy, iy, py, inv_y), \
        next_t(dz, iz, pz, inv_z)
    adx, ady, adz = (inv.abs() * float(cell) for inv in (inv_x, inv_y,
                                                         inv_z))
    alive0 = active & ~misses_box
    t = torch.where(alive0, push, zero)
    hit = torch.zeros_like(alive0)
    steps = torch.zeros_like(ix)

    def inside_of(ix, iy, iz):
        return ((ix >= 0) & (ix < n) & (iy >= 0) & (iy < n) & (iz >= 0)
                & (iz < n))

    for _ in range(max_steps):
        act = alive0 & inside_of(ix, iy, iz) & ~hit
        solid = probe(ix.clamp(0, n - 1), iy.clamp(0, n - 1),
                      iz.clamp(0, n - 1))
        new_hit = act & solid
        hit = hit | new_hit
        act = act & ~new_hit
        steps = steps + act.to(torch.int32)
        mx = (tx <= ty) & (tx <= tz)
        my = ~mx & (ty <= tz)
        mz = ~mx & ~my
        t = torch.where(act, torch.minimum(torch.minimum(tx, ty), tz), t)
        ax, ay, az = act & mx, act & my, act & mz
        ix = torch.where(ax, ix + sx, ix)
        iy = torch.where(ay, iy + sy, iy)
        iz = torch.where(az, iz + sz, iz)
        tx = torch.where(ax, tx + adx, tx)
        ty = torch.where(ay, ty + ady, ty)
        tz = torch.where(az, tz + adz, tz)
    inside = inside_of(ix, iy, iz) & ~misses_box
    return hit, ix, iy, iz, t, inside, steps


def _bit(table, word, shift):
    """Bit ``shift`` of ``table[word]`` (word clamped into the table)."""
    w = table[word.clamp(0, table.numel() - 1)]
    return ((w >> shift) & 1) != 0


def intersect_bricks(scene, origins, dirs, max_depth=None, cone_trace=False,
                     max_iterations=None, active=None, max_rounds=64):
    """Trace (B,3) world-space rays against a BrickScene whose arrays are
    tensors (BrickScene.to_device), on the scene's device; returns a
    HitResult.  ``intersect_octree``-shaped: ``max_depth``,
    ``cone_trace`` and ``max_iterations`` are accepted and ignored (the
    engine resolves the finest leaf), as in the JAX package.  ``active``
    (B,) masks rays out; they and non-finite rays return as misses."""
    ws, G, n_mixed = scene.world_size, scene.grid_size, scene.n_mixed
    l0_flat = scene.l0_table.reshape(-1)
    slot_map, brick_attr = scene.brick_slot, scene.brick_attr
    occ_flat = scene.occ_words.reshape(-1)
    attrs_flat = scene.attrs.reshape(-1)
    o = origins.to(torch.float32)
    d = dirs.to(torch.float32)
    for a in (o, d) + (() if active is None else (active,)):
        if a.device != l0_flat.device:
            raise ValueError(f"tensor on {a.device}, scene on "
                             f"{l0_flat.device}")
    B = o.shape[0]
    ov = (o - 1.0) * float(ws)
    ox, oy, oz = ov.unbind(1)
    dx, dy, dz = d.unbind(1)
    finite = (torch.isfinite(o) & torch.isfinite(d)).all(1)
    alive = finite if active is None else active.to(torch.bool) & finite
    W = -(-G // 32)

    def l0_probe(ix, iy, iz):
        return _bit(l0_flat, ((ix * G + iy) * W + (iz >> 5)).long(), iz & 31)

    zi = torch.zeros(B, dtype=torch.int32, device=o.device)
    t_vox = torch.zeros(B, dtype=torch.float32, device=o.device)
    t_hit = torch.zeros_like(t_vox)
    hit = torch.zeros_like(alive)
    attr, hvx, hvy, hvz, iters = zi, zi, zi, zi, zi
    for _ in range(max_rounds):
        if not bool(alive.any()):
            break
        px, py, pz = ox + t_vox * dx, oy + t_vox * dy, oz + t_vox * dz

        # phase A: march the brick cells
        chit, bx, by, bz, tA, inside, stA = _march(
            (px, py, pz), (dx, dy, dz), ws, 32, l0_probe, 3 * G + 4, alive)
        iters = iters + stA
        # left the world without meeting an occupied brick: a miss
        alive = alive & (chit | inside)

        cellc = ((bx * G + by) * G + bz).clamp(0, G * G * G - 1).long()
        slot = torch.where(chit, slot_map[cellc], -1)
        uattr = brick_attr[cellc]
        uni_solid = chit & (slot < 0) & ((uattr & 0xFF) != 0)

        # a uniform-solid brick: the hit is on its entry face
        entry_t = t_vox + tA

        def entry_voxel(p, c, b):
            return (p + tA * c).to(torch.int32).clamp(b * 32, b * 32 + 31)

        new_hit = alive & uni_solid
        hit = hit | new_hit
        attr = torch.where(new_hit, uattr, attr)
        hvx = torch.where(new_hit, entry_voxel(px, dx, bx), hvx)
        hvy = torch.where(new_hit, entry_voxel(py, dy, by), hvy)
        hvz = torch.where(new_hit, entry_voxel(pz, dz, bz), hvz)
        t_hit = torch.where(new_hit, entry_t, t_hit)
        alive = alive & ~new_hit

        # phase B: march the voxels of the mixed brick
        in_mixed = alive & chit & (slot >= 0)
        lx = px + tA * dx - (bx * 32).float()
        ly = py + tA * dy - (by * 32).float()
        lz = pz + tA * dz - (bz * 32).float()
        slotc = slot.clamp(0, max(n_mixed - 1, 0)).long()

        def occ_probe(ix, iy, iz):
            return _bit(occ_flat, slotc * 1024 + ix * 32 + iy, iz)

        fhit, fx, fy, fz, tB, _, stB = _march(
            (lx, ly, lz), (dx, dy, dz), 32, 1, occ_probe, 100, in_mixed)
        iters = iters + stB
        fattr = attrs_flat[(slotc * 32768 + fx * 1024 + fy * 32 + fz).clamp(
            0, attrs_flat.numel() - 1)]
        new_hit = in_mixed & fhit
        hit = hit | new_hit
        attr = torch.where(new_hit, fattr, attr)
        hvx = torch.where(new_hit, bx * 32 + fx, hvx)
        hvy = torch.where(new_hit, by * 32 + fy, hvy)
        hvz = torch.where(new_hit, bz * 32 + fz, hvz)
        t_hit = torch.where(new_hit, entry_t + tB, t_hit)
        alive = alive & ~new_hit

        # left the brick (or ran out of fine steps): past the crossing
        t_vox = torch.where(in_mixed & ~fhit, entry_t + tB + EXIT_EPS,
                            t_vox)
        # ran out of coarse steps inside the grid without a cell hit
        stuck = alive & ~chit & inside
        t_vox = torch.where(stuck, t_vox + tA + EXIT_EPS, t_vox)
    return decode_hits(ws, o, d, hit, attr, hvx, hvy, hvz, t_hit, iters)
