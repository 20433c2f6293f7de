"""Coarse occupancy-grid DDA (port of svo_raytracer_tpu/ops/brick_dda.py:
``coarse_dda`` and its Pallas kernel ``_dda_kernel``, K2).

Each ray marches a G^3 grid of z-packed occupancy bits (word
``(x*G + y)*W + (z >> 5)`` holds bit ``z & 31`` of column (x, y), W =
ceil(G/32); built by ``brick_scene.pack_occupancy`` and laid out in
128-word rows by ``brick_scene.table_rows``) cell by cell, Amanatides-Woo,
and reports the first solid cell, its entry distance and its step count.
Rays starting outside [0, G]^3 first advance to the grid's entry face.

  * :func:`coarse_dda_plain` is the plain PyTorch version, the JAX
    kernel's lock-step body over the whole batch;
  * kernel K2 (``csrc/brick_dda.cu`` over ``csrc/brick_dda.cuh``) runs
    one thread per ray with the table in shared memory, bit-equal to the
    plain version;
  * :func:`coarse_dda` takes K2 for CUDA tensors and the plain version
    for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernel_build

#: K2 keeps the whole table (up to 32 KB) in shared memory
MAX_G = 64
DIR_EPS = float(np.float32(1e-4))

_P, _I = ctypes.c_void_p, ctypes.c_int
K2 = kernel_build.Kernel("brick_dda", ["brick_dda.cu"], "dda_march",
                         [_P, _I, _I, _P, _P, _I, _P, _I] + [_P] * 5)


def _cell_of(p, G):
    """int32(p) clipped to [0, G-1], with out-of-range and NaN p taking
    the clipped saturating conversion (csrc/brick_dda.cuh cell_of)."""
    return p.clamp(-1.0, float(G)).to(torch.int32).clamp(0, G - 1)


def coarse_dda_plain(occ_table, o, d, G, max_steps, alive):
    """Plain PyTorch version of kernel K2 (brick_dda.py::_dda_kernel's
    body, lock-step over the batch).  o, d: (B,3) float32 grid units;
    alive: (B,) bool.  Returns dict(hit, t, cell (B,3), steps)."""
    W = -(-G // 32)
    tab = occ_table.reshape(-1)
    eps = torch.full_like(d, DIR_EPS)
    d = torch.where(d.abs() < DIR_EPS, torch.where(d >= 0, eps, -eps), d)
    inv = 1.0 / d
    t1 = (0.0 - o) * inv
    t2 = (float(G) - o) * inv
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    t_ent = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    t_exit = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    t0 = torch.maximum(t_ent, torch.zeros_like(t_ent))
    misses_box = (t_ent > t_exit) | (t_exit < 0.0)
    zf = torch.zeros_like(t0)
    base_t = torch.where(t0 > 0.0, t0 + 1e-4, zf)
    p = o + base_t[:, None] * d
    cell = _cell_of(p, G)
    step = torch.where(d > 0, 1, -1).to(torch.int32)
    tn = base_t[:, None] + ((cell + (d > 0).to(torch.int32)).float()
                            - p) * inv
    adt = inv.abs()
    alive0 = alive & ~misses_box
    t = torch.where(alive0, base_t, zf)
    hit = torch.zeros_like(alive0)
    steps = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    ix, iy, iz = cell.unbind(1)
    tx, ty, tz = tn.unbind(1)
    for _ in range(max_steps):
        inside = ((ix >= 0) & (ix < G) & (iy >= 0) & (iy < G) & (iz >= 0)
                  & (iz < G))
        act = alive0 & inside & ~hit
        if not bool(act.any()):
            break
        czp = iz.clamp(0, G - 1)
        w = (ix.clamp(0, G - 1) * G + iy.clamp(0, G - 1)) * W + (czp >> 5)
        solid = ((tab[w.long()] >> (czp & 31)) & 1) != 0
        hit = hit | (act & solid)
        act = act & ~solid
        steps = steps + act.to(torch.int32)
        mx = (tx <= ty) & (tx <= tz)
        my = ~mx & (ty <= tz)
        mz = ~mx & ~my
        t = torch.where(act, torch.minimum(torch.minimum(tx, ty), tz), t)
        ix = torch.where(act & mx, ix + step[:, 0], ix)
        iy = torch.where(act & my, iy + step[:, 1], iy)
        iz = torch.where(act & mz, iz + step[:, 2], iz)
        tx = torch.where(act & mx, tx + adt[:, 0], tx)
        ty = torch.where(act & my, ty + adt[:, 1], ty)
        tz = torch.where(act & mz, tz + adt[:, 2], tz)
    return dict(hit=hit, t=t, cell=torch.stack([ix, iy, iz], 1),
                steps=steps)


def _row_stride(a):
    """Floats from one row of a (B,3) float32 tensor to the next: 3 for
    packed rows, 0 for one row expanded over the batch (a shadow
    segment's sun direction); None for any other layout."""
    if a.dtype != torch.float32:
        return None
    if a.shape[0] == 0:
        return 0
    if a.stride(1) != 1:
        return None
    if a.shape[0] == 1:           # only row 0 is read
        return 0
    return a.stride(0) if a.stride(0) in (0, 3) else None


def coarse_dda_kernel(occ_table, o, d, G, max_steps, alive=None):
    """Kernel K2 on the card: same contract as :func:`coarse_dda_plain`.
    ``o``: contiguous (B,3) float32; ``d``: (B,3) float32 rows, packed or
    one row expanded over the batch; ``alive``: contiguous (B,) bool, or
    None for every ray.  Launches K2 alone: the bool tensors' bytes are
    its u8 input and output."""
    B = o.shape[0]
    dev = o.device
    if alive is not None and (alive.dtype != torch.bool
                              or not alive.is_contiguous()):
        raise ValueError("alive must be a contiguous bool tensor")
    sd = _row_stride(d)
    if o.dtype != torch.float32 or not o.is_contiguous() or sd is None:
        raise ValueError("origins must be contiguous float32 and "
                         "directions float32 rows, packed or expanded")
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    t = torch.empty(B, dtype=torch.float32, device=dev)
    cell = torch.empty((B, 3), dtype=torch.int32, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        K2.launch(dev, occ_table.data_ptr(), G, max_steps, o.data_ptr(),
                  d.data_ptr(), sd,
                  None if alive is None
                  else alive.view(torch.uint8).data_ptr(), B, hit.data_ptr(),
                  t.data_ptr(), cell.data_ptr(), steps.data_ptr())
    return dict(hit=hit, t=t, cell=cell, steps=steps)


def coarse_dda(occ_table, origins, dirs, grid_size, max_steps=None,
               active=None):
    """March (B,3) rays in GRID units through a G^3 occupancy grid.

    occ_table: (rows, 128) int32 from ``table_rows(pack_occupancy(vox))``
    on the rays' device.  Returns dict of hit (B,) bool, t (B,) float32
    (entry distance of the hit cell, grid units), cell (B,3) int32 and
    steps (B,) int32.  ``max_steps`` defaults to 3G, as the JAX package's.
    Kernel K2 for CUDA tensors, its plain version for CPU tensors.  On the
    card
    contiguous float32 origins, float32 directions with packed or
    expanded rows and a bool ``active`` go to K2 as they are, with no
    copy."""
    G = int(grid_size)
    if not 1 <= G <= MAX_G:
        raise ValueError(f"grid_size {G} outside [1, {MAX_G}]")
    if max_steps is None:
        max_steps = 3 * G
    B = origins.shape[0]
    if (origins.shape != (B, 3) or dirs.shape != (B, 3)
            or (active is not None and active.shape != (B,))):
        raise ValueError(f"ray shapes {tuple(origins.shape)} "
                         f"{tuple(dirs.shape)} "
                         f"{None if active is None else tuple(active.shape)}")
    o = origins.to(torch.float32).contiguous()
    d = dirs.to(torch.float32)
    if _row_stride(d) is None:
        d = d.contiguous()
    alive = None if active is None else active.to(torch.bool).contiguous()
    if occ_table.dtype != torch.int32 or not occ_table.is_contiguous():
        raise ValueError("occ_table must be contiguous int32")
    if occ_table.numel() < G * G * -(-G // 32):
        raise ValueError(f"occ_table of {occ_table.numel()} words is too "
                         f"small for G = {G}")
    for a in (d, alive, occ_table):
        if a is not None and a.device != o.device:
            raise ValueError(f"tensor on {a.device}, rays on {o.device}")
    if o.device.type == "cpu":
        if alive is None:
            alive = torch.ones(B, dtype=torch.bool)
        return coarse_dda_plain(occ_table, o, d, G, max_steps, alive)
    return coarse_dda_kernel(occ_table, o, d, G, max_steps, alive)
