"""Level-synchronous octree build on the device (port of
svo_raytracer_tpu/core/build_jax.py: ``build_octree_jax`` and its
``build_octree`` wrapper).

The reference builds a chunk with a recursive CPU scan
(``src/engine/Octree.java:511-670``); the recursive port
(``core/build_np.py``) would take hours at 1024^3.  This build is the JAX
package's, in plain PyTorch on the grid's device:

  Phase A — bottom-up statistics: per-cell min/max over 2x2x2 folds (a
    cell is a leaf iff homogeneous), the reference's "value" pick (corner
    if nonzero, else the first nonzero voxel in (z, y, x) raster order:
    the min over the cell of the raster key z*S^2 + y*S + x, decoded back
    to its voxel), voxel exposure and digit-packed normals from the 3^3
    air neighbourhood, and the corner-probe big-node exposure.
  Phase B — top-down level-order allocation: the children of the rank-r
    branch of a level occupy slots base + 8r .. base + 8r + 7, ranks in
    raster order of the parent cells.

So the arrays equal ``build_octree_jax``'s up to ``n_nodes``.  Where JAX
scatters full-grid arrays into a fixed capacity, this build gathers each
level's statistics only at the children of that level's branches and
sizes the table from the branch counts, so there is no capacity to
overflow.  Grids are stored narrow (uint8 voxels, int8 neighbourhood
sums), and each level's statistics are freed once consumed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import constants as C
from .octree import DeviceOctree

KEY_INF = int(np.iinfo(np.int32).max)
#: the int32 raster key z*S^2 + y*S + x holds S <= 1024
MAX_SIZE = 1024


def _fold(a, op):
    """Reduce 2x2x2 blocks of a cubic grid with ``op`` (amin / amax)."""
    n = a.shape[0] // 2
    return op(a.view(n, 2, n, 2, n, 2), dim=(1, 3, 5))


def _shift_sum3(a, axis):
    """a[i-1] + a[i] + a[i+1] along ``axis``, zero outside the grid."""
    out = a.clone()
    n = a.shape[axis]
    out.narrow(axis, 1, n - 1).add_(a.narrow(axis, 0, n - 1))
    out.narrow(axis, 0, n - 1).add_(a.narrow(axis, 1, n - 1))
    return out


def _shift_diff(a, axis):
    """a[i+1] - a[i-1] along ``axis``, zero outside the grid."""
    out = torch.zeros_like(a)
    n = a.shape[axis]
    out.narrow(axis, 0, n - 1).add_(a.narrow(axis, 1, n - 1))
    out.narrow(axis, 1, n - 1).sub_(a.narrow(axis, 0, n - 1))
    return out


def _trunc_half(a):
    """Java int division by 2 (truncates toward zero)."""
    return torch.where(a < 0, -(torch.div(-a, 2, rounding_mode="floor")),
                       torch.div(a, 2, rounding_mode="floor"))


def _voxel_exposure_and_normals(v):
    """Per-voxel (exposed, packed normal) from the 3^3 air neighbourhood,
    out-of-grid never air (Octree.java:620-649; build_jax
    _voxel_exposure_and_normals)."""
    air = (v == 0).to(torch.int8)
    yz = _shift_sum3(_shift_sum3(air, 1), 2)
    exposed = _shift_sum3(yz, 0) > 0
    packed = (_trunc_half(_shift_diff(yz, 0)).to(torch.int16) + 5)
    del yz
    xz = _shift_sum3(_shift_sum3(air, 0), 2)
    packed += (_trunc_half(_shift_diff(xz, 1)).to(torch.int16) + 5) * 10
    del xz
    xy = _shift_sum3(_shift_sum3(air, 0), 1)
    packed += (_trunc_half(_shift_diff(xy, 2)).to(torch.int16) + 5) * 100
    return exposed, packed


def _big_node_exposure(v, s):
    """Corner-probe exposure of the cells of size s (Octree.java:651-670):
    any of the <= 27 probes with all coords in {c-1, c+s, c+s+1} inside
    the grid is air."""
    S = v.shape[0]
    n = S // s
    base = torch.arange(n, device=v.device) * s
    coords = base[:, None] + torch.tensor([-1, s, s + 1], device=v.device)
    valid = (coords >= 0) & (coords < S)
    cc = coords.clamp(0, S - 1)
    exposed = torch.zeros((n, n, n), dtype=torch.bool, device=v.device)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                probe = v[cc[:, a][:, None, None], cc[:, b][None, :, None],
                          cc[:, c][None, None, :]] == 0
                ok = (valid[:, a][:, None, None] & valid[:, b][None, :, None]
                      & valid[:, c][None, None, :])
                exposed |= probe & ok
    return exposed


def _level_stats(v, d, max_lod, folds):
    """(tag int8, value uint8, normal int16 or None) grids of level d."""
    S = v.shape[0]
    s = S >> d
    corner = v[::s, ::s, ::s]
    if d == max_lod:
        leaf = None
        value = corner
    else:
        mn, mx, key = folds.pop(d)
        leaf = mn == mx
        del mn, mx
        has = key != KEY_INF
        k = torch.where(has, key, torch.zeros_like(key)).long()
        first_nz = torch.where(
            has, v[k % S, torch.div(k, S, rounding_mode="floor") % S,
                   torch.div(k, S * S, rounding_mode="floor")],
            torch.zeros_like(corner))
        del k, key, has
        value = torch.where(leaf, corner,
                            torch.where(corner != 0, corner, first_nz))
        del first_nz
    solid = value != 0
    normal = None
    if s == 1:
        # the voxel level is always max_lod, so every cell is a leaf
        exposed, normal = _voxel_exposure_and_normals(v)
        tag = torch.where(solid & exposed, C.TAG_SURFACE_LEAF,
                          C.TAG_NON_SURFACE_LEAF)
    else:
        leaf_solid = solid if leaf is None else leaf & solid
        leaf = torch.full_like(solid, True) if leaf is None else leaf
        tag = torch.where(
            leaf_solid,
            torch.where(_big_node_exposure(v, s), C.TAG_BRANCH,
                        C.TAG_SUBDIV_LEAF),
            torch.where(leaf, C.TAG_SUBDIV_LEAF, C.TAG_BRANCH))
    return tag.to(torch.int8), value, normal


def build_octree_device(voxels, max_lod: int | None = None,
                        world_size: int | None = None) -> DeviceOctree:
    """Build the SoA node table of a dense [x, y, z] voxel grid (values
    0..255) on the grid's device; a NumPy grid goes to the card first
    (pass a CPU tensor to build on the CPU).

    Returns a DeviceOctree of exactly ``n_nodes`` slots, equal to
    ``build_octree_jax``'s arrays up to its count.  Raises ValueError for
    grids that are not cubic powers of two or larger than 1024^3."""
    v = (voxels if isinstance(voxels, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(voxels)).to("cuda"))
    S = int(v.shape[0])
    if v.shape != (S, S, S) or S < 2 or S & (S - 1):
        raise ValueError(f"voxel grid must be a cubic power of two, got "
                         f"{tuple(v.shape)}")
    if S > MAX_SIZE:
        raise ValueError(f"{S}^3 overflows the int32 raster key; chunks are "
                         f"at most {MAX_SIZE}^3")
    if v.dtype != torch.uint8:
        if int(v.min()) < 0 or int(v.max()) > 255:
            raise ValueError("voxel values must lie in 0..255")
        v = v.to(torch.uint8)
    v = v.contiguous()
    levels = int(np.log2(S))
    max_lod = levels if max_lod is None else min(max_lod, levels)

    # ---- Phase A: bottom-up min / max / min raster key per level
    folds = {}
    if max_lod > 1:
        ax = torch.arange(S, dtype=torch.int32, device=v.device)
        key = torch.where(v != 0, (ax[None, None, :] * S
                                   + ax[None, :, None]) * S
                          + ax[:, None, None], KEY_INF)
        mn = mx = v
        for d in range(levels - 1, 0, -1):
            mn, mx, key = (_fold(mn, torch.amin), _fold(mx, torch.amax),
                           _fold(key, torch.amin))
            if d < max_lod:
                folds[d] = (mn, mx, key)
        del mn, mx, key, ax

    # ---- Phase B: level-order allocation, gathering each level's stats at
    # the children of its parent level's branches
    dev = v.device
    i32 = torch.int32
    child_blk = [torch.zeros(8, dtype=i32, device=dev)]
    mask_blk = [torch.zeros(8, dtype=i32, device=dev)]
    value_blk = [torch.zeros(8, dtype=i32, device=dev)]
    normal_blk = [torch.zeros(8, dtype=i32, device=dev)]
    value_blk[0][0] = 1  # root (dummy head, Octree.java:97-100)
    par_cells = torch.zeros(1, dtype=torch.int64, device=dev)
    par_local = torch.zeros(1, dtype=torch.int64, device=dev)  # in prev blk
    level_base = 8
    k = torch.arange(8, device=dev)
    offs = torch.tensor(C.CHILD_OFFSETS, device=dev)  # (8, 3)
    for d in range(1, max_lod + 1):
        P = par_cells.numel()
        if P == 0:
            break
        n = 1 << d
        npar = n // 2
        pc = torch.stack([torch.div(par_cells, npar * npar,
                                    rounding_mode="floor"),
                          torch.div(par_cells, npar,
                                    rounding_mode="floor") % npar,
                          par_cells % npar], 1)
        c = pc[:, None, :] * 2 + offs[None]                    # (P, 8, 3)
        cflat = (c[..., 0] * n + c[..., 1]) * n + c[..., 2]    # (P, 8)
        tag_g, value_g, normal_g = _level_stats(v, d, max_lod, folds)
        ctag = tag_g.reshape(-1)[cflat].to(i32)
        cval = value_g.reshape(-1)[cflat].to(i32)
        if normal_g is None:
            cnorm = torch.zeros_like(cval)
        else:
            cnorm = torch.where(ctag == C.TAG_SURFACE_LEAF,
                                normal_g.reshape(-1)[cflat].to(i32), 0)
        del tag_g, value_g, normal_g
        child_base = level_base + 8 * torch.arange(P, dtype=i32, device=dev)
        cmask = (ctag << (2 * k.to(i32))[None]).sum(1, dtype=i32)
        child_blk[-1][par_local] = child_base
        mask_blk[-1][par_local] = cmask
        value_blk.append(cval.reshape(-1))
        normal_blk.append(cnorm.reshape(-1))
        child_blk.append(torch.zeros(8 * P, dtype=i32, device=dev))
        mask_blk.append(torch.zeros(8 * P, dtype=i32, device=dev))
        level_base += 8 * P
        if d < max_lod:
            br = (ctag == C.TAG_BRANCH).reshape(-1)
            cells = cflat.reshape(-1)[br]
            local = torch.arange(8 * P, device=dev)[br]
            order = torch.argsort(cells)
            par_cells, par_local = cells[order], local[order]
    out = [torch.cat(b) for b in (child_blk, mask_blk, value_blk,
                                  normal_blk)]
    return DeviceOctree(*out, n_nodes=level_base,
                        world_size=world_size or S)
