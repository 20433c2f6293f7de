"""The reference traversal: a plain voxel walk over the reference world.

A ray is clipped to the world cube, then walks the grid from the voxel
holding its entry point (cells are half-open, so an origin on a face
belongs to the voxel above it, but for the tie rule in ``walk``).  At
each voxel it looks up the 32^3 brick, the 2^3 cell and the voxel
itself, and steps across the exit face
of the largest of the three that is empty, into the neighbour on that
axis; the other coordinates are those of the exit point, kept inside the
cube it leaves.  The first solid voxel is the hit; its distance is that
of the ray's entry into the voxel.  Distances are float64 and in voxel
units, as the world's grid indexes them.

With ``fdt=torch.bfloat16`` the same walk is the precision control: it
rounds every position and distance to bfloat16.

``count`` (a dict) receives what the walk did, for the roofline's work
count: ``steps``, one per step over an empty brick or cell plus one per
occupied cell entered, and under ``word_sets`` the ids of the 32-bit
words of the bit-packed brick, cell and voxel occupancy tables that it
read (``distinct_words`` counts them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

COMPACT = 8         # iterations between compactions of the live rays


class Walk(NamedTuple):
    hit: torch.Tensor      # bool (n,)
    t_vox: torch.Tensor    # fdt (n,) entry distance of the hit voxel
    voxel: torch.Tensor    # int64 (n, 3) hit voxel (-1 on a miss)
    capped: torch.Tensor   # bool (n,) out of steps (a miss)


def _box(ov, dv, W):
    """(t_enter, t_exit) of rays against [0, W]^3; d = 0 rays are inside
    or outside on that axis for all t."""
    inf = torch.full_like(ov, float("inf"))
    zero = dv == 0
    inside = (ov >= 0) & (ov <= W)
    safe = torch.where(zero, torch.ones_like(dv), dv)
    t0 = (0 - ov) / safe
    t1 = (W - ov) / safe
    lo = torch.where(zero, torch.where(inside, -inf, inf), torch.minimum(t0, t1))
    hi = torch.where(zero, torch.where(inside, inf, -inf), torch.maximum(t0, t1))
    return lo.amax(1).clamp_min(0), hi.amin(1)


def walk(world, origins, dirs, active=None, fdt=torch.float64, count=None,
         max_iter=None):
    """Walk (n, 3) world-space rays (the cube [1, 2]^3) through ``world``;
    inactive and non-finite rays miss."""
    W = world.W
    dev = origins.device
    n = origins.shape[0]
    o32 = origins.to(torch.float32)
    d32 = dirs.to(torch.float32)
    alive = torch.isfinite(o32).all(1) & torch.isfinite(d32).all(1)
    if active is not None:
        alive &= active.to(torch.bool)
    ov = ((o32 - 1.0) * float(W)).to(fdt)
    dv = d32.to(fdt)
    te, tx = _box(ov, dv, W)
    alive &= te <= tx      # a ray touching the cube's face meets it

    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    capped = torch.zeros(n, dtype=torch.bool, device=dev)
    t_out = torch.zeros(n, dtype=fdt, device=dev)
    v_out = torch.full((n, 3), -1, dtype=torch.int64, device=dev)
    steps_out = torch.zeros(n, dtype=torch.int64, device=dev)

    ids = torch.nonzero(alive).squeeze(1)
    o, d, t, t_end = ov[ids], dv[ids], te[ids], tx[ids]
    # the voxel holding the entry point: entering from outside, the one
    # on the cube's face; else the origin's own, cells half-open, except
    # that an origin on an odd face, or on a face 32 past a multiple of 64,
    # heading down that axis belongs to the voxel below it
    p0 = o + t[:, None] * d
    v = torch.floor(p0).to(torch.int64)
    on = (p0 == v.to(fdt)) & (d < 0) & (t == 0)[:, None] & (
        (v % 2 == 1) | (v % 64 == 32))
    v = (v - on.to(torch.int64)).clamp(0, W - 1)
    zero = d == 0
    safe = torch.where(zero, torch.ones_like(d), d)
    pos = d > 0
    big = torch.tensor(float("inf"), dtype=fdt, device=dev)
    status = torch.zeros(ids.numel(), dtype=torch.int8, device=dev)
    steps = torch.zeros(ids.numel(), dtype=torch.int64, device=dev)
    last_cell = torch.full((ids.numel(),), -1, dtype=torch.int64, device=dev)
    words = [] if count is not None else None
    max_iter = 4 * W + 64 if max_iter is None else max_iter
    it = 0
    while ids.numel() and it < max_iter:
        for _ in range(COMPACT):
            live = status == 0
            b = v >> 5
            c = v >> 1
            bocc = world.solid_brick[b[:, 0], b[:, 1], b[:, 2]]
            cocc = world.solid_cell[c[:, 0], c[:, 1], c[:, 2]]
            solid = world.vox[v[:, 0], v[:, 1], v[:, 2]] != 0
            now_hit = live & bocc & cocc & solid
            s = torch.where(~bocc, 32, torch.where(~cocc, 2, 1))[:, None]
            lo = torch.div(v, s, rounding_mode="floor") * s
            plane = (lo + pos.to(torch.int64) * s).to(fdt)
            tp = torch.where(zero, big, (plane - o) / safe)
            tn, axis = tp.min(1)
            tn = torch.maximum(tn, t)
            # the next cube: across the exit face on the exit axis, the
            # exit point's voxel, kept inside this cube, on the others
            q = torch.floor(o + tn[:, None] * d).to(torch.int64)
            q = torch.minimum(torch.maximum(q, lo), lo + s - 1)
            across = torch.where(pos, lo + s, lo - 1)
            onaxis = torch.arange(3, device=dev)[None, :] == axis[:, None]
            nv = torch.where(onaxis, across, q)
            out = ((nv < 0) | (nv >= W)).any(1) | (tn >= t_end)
            now_miss = live & ~now_hit & out
            if count is not None:
                cell_id = (c[:, 0] * (W // 2) + c[:, 1]) * (W // 2) + c[:, 2]
                fine = bocc & cocc
                steps += (live & (~fine | (cell_id != last_cell))).to(
                    torch.int64)
                last_cell = torch.where(fine, cell_id, last_cell)
                w = _words(v, bocc, cocc, W)[live].reshape(-1)
                words.append(w[w >= 0].unique())
            move = live & ~now_hit & ~now_miss
            status = torch.where(now_hit, 1, torch.where(now_miss, 2,
                                                         status)).to(torch.int8)
            t = torch.where(move, tn, t)
            v = torch.where(move[:, None], nv, v)
            it += 1
        fin = status != 0
        if bool(fin.any()):
            f = ids[fin]
            hit[f] = status[fin] == 1
            t_out[f] = t[fin]
            v_out[f] = torch.where((status[fin] == 1)[:, None], v[fin],
                                   torch.full_like(v[fin], -1))
            steps_out[f] = steps[fin]
            keep = ~fin
            ids, o, d, t, t_end = ids[keep], o[keep], d[keep], t[keep], \
                t_end[keep]
            v, zero, safe, pos = v[keep], zero[keep], safe[keep], pos[keep]
            status, steps = status[keep], steps[keep]
            last_cell = last_cell[keep]
    if ids.numel():
        capped[ids] = True
        steps_out[ids] = steps
    if count is not None:
        count["steps"] = count.get("steps", 0) + int(steps_out.sum())
        ws = torch.cat(words).unique() if words else torch.zeros(0)
        count.setdefault("word_sets", []).append(ws)
    return Walk(hit=hit, t_vox=t_out, voxel=v_out, capped=capped)


def _words(vc, bocc, cocc, W):
    """(n, 3) word ids of the occupancy tables one step reads, -1 where
    unread: the brick's word, the cell's when the brick holds solid, the
    voxel's when the cell does.  Tables are bit-packed along z, 32 bits a
    word, and numbered apart."""
    G, N = W // 32, W // 2
    b, c = vc >> 5, vc >> 1
    wb = (b[:, 0] * G + b[:, 1]) * ((G + 31) // 32) + (b[:, 2] >> 5)
    wc = (c[:, 0] * N + c[:, 1]) * ((N + 31) // 32) + (c[:, 2] >> 5)
    wv = (vc[:, 0] * W + vc[:, 1]) * (W // 32) + (vc[:, 2] >> 5)
    nb = G * G * ((G + 31) // 32)
    nc = N * N * ((N + 31) // 32)
    none = torch.full_like(wb, -1)
    return torch.stack([wb, torch.where(bocc, wc + nb, none),
                        torch.where(bocc & cocc, wv + nb + nc, none)], 1)


def distinct_words(count) -> int:
    """Distinct table words over every walk ``count`` has seen."""
    sets = count.get("word_sets", [])
    if not sets:
        return 0
    return int(torch.cat(sets).unique().numel())
