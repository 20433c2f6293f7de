"""Procedural terrain noise of the reference world: a frozen copy of the
chunkgen noise stack (chunkgen.comp: 2-D Perlin ``cnoise`` :49-86, 3-D
simplex ``snoise`` :95-162, 2-D Worley ``worley`` :174-212, the terrain
composition :214-226), elementwise float32 PyTorch written op for op as
the shaders compose it.  The reference world is generated from this copy
alone: nothing here comes from the system under test.
"""

from __future__ import annotations

import numpy as np
import torch

f32 = torch.float32


def _f32(a):
    return a.to(f32)


def _mod(x, m):
    """``jnp.mod(x, m)`` for m > 0: XLA's ``rem`` is C ``fmod``, exact, and
    jnp.mod adds m where the signs differ.  ``torch.remainder`` computes
    x - m * floor(x / m) instead, and on the card a tensor divided by a
    Python scalar is multiplied by its reciprocal: an exact multiple of
    289 can then come out as 289, not 0."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def _sqrt(x):
    """Correctly rounded float32 square root, the same bits on the card
    and on the CPU, where NumPy takes it: torch's multi-threaded CPU sqrt
    has returned approximate roots (up to ~2e-4 relative) on one thread's
    share of a call's elements, in some processes and not others."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def _mod289(x):
    # the reference's own op (not fmod): floor of a multiply by 1/289
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    """mod289(((x*34)+10)*x) — chunkgen.comp:33-36."""
    return _mod289(((x * 34.0) + 10.0) * x)


def _permute3d(x):
    """mod(((x*34)+1)*x, 289) — chunkgen.comp:93."""
    return _mod(((x * 34.0) + 1.0) * x, 289.0)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def cnoise(px, py):
    """Classic 2-D Perlin noise (chunkgen.comp:49-86).  Range ~[-1, 1]."""
    px, py = _f32(px), _f32(py)
    pix, piy = torch.floor(px), torch.floor(py)
    pfx, pfy = px - pix, py - piy

    ix = torch.stack([pix, pix + 1.0, pix, pix + 1.0], dim=-1)
    iy = torch.stack([piy, piy, piy + 1.0, piy + 1.0], dim=-1)
    fx = torch.stack([pfx, pfx - 1.0, pfx, pfx - 1.0], dim=-1)
    fy = torch.stack([pfy, pfy, pfy - 1.0, pfy - 1.0], dim=-1)

    i = _permute(_permute(_mod289(ix)) + _mod289(iy))

    gx = i * (1.0 / 41.0)
    gx = (gx - torch.floor(gx)) * 2.0 - 1.0  # fract(i/41)*2-1
    gy = torch.abs(gx) - 0.5
    tx = torch.floor(gx + 0.5)
    gx = gx - tx

    norm = _taylor_inv_sqrt(gx * gx + gy * gy)
    gx = gx * norm
    gy = gy * norm

    n = gx * fx + gy * fy  # dot(g, f) per corner

    fade_x = _fade(pfx)
    fade_y = _fade(pfy)
    nx0 = n[..., 0] + fade_x * (n[..., 1] - n[..., 0])  # mix along x, y=0
    nx1 = n[..., 2] + fade_x * (n[..., 3] - n[..., 2])  # y=1
    nxy = nx0 + fade_y * (nx1 - nx0)
    return 2.3 * nxy


def snoise(x, y, z):
    """3-D simplex noise (chunkgen.comp:95-162).  Range ~[-1, 1]."""
    x, y, z = _f32(x), _f32(y), _f32(z)
    C_x, C_y = 1.0 / 6.0, 1.0 / 3.0

    s = (x + y + z) * C_y
    ix = torch.floor(x + s)
    iy = torch.floor(y + s)
    iz = torch.floor(z + s)
    t = (ix + iy + iz) * C_x
    x0 = x - ix + t
    y0 = y - iy + t
    z0 = z - iz + t

    gx = (x0 >= y0).to(f32)
    gy = (y0 >= z0).to(f32)
    gz = (z0 >= x0).to(f32)
    lx, ly, lz = 1.0 - gx, 1.0 - gy, 1.0 - gz
    i1x = torch.minimum(gx, lz)
    i1y = torch.minimum(gy, lx)
    i1z = torch.minimum(gz, ly)
    i2x = torch.maximum(gx, lz)
    i2y = torch.maximum(gy, lx)
    i2z = torch.maximum(gz, ly)

    x1 = x0 - i1x + C_x
    y1 = y0 - i1y + C_x
    z1 = z0 - i1z + C_x
    x2 = x0 - i2x + 2.0 * C_x
    y2 = y0 - i2y + 2.0 * C_x
    z2 = z0 - i2z + 2.0 * C_x
    x3 = x0 - 1.0 + 3.0 * C_x
    y3 = y0 - 1.0 + 3.0 * C_x
    z3 = z0 - 1.0 + 3.0 * C_x

    ix, iy, iz = _mod(ix, 289.0), _mod(iy, 289.0), _mod(iz, 289.0)

    def corner_perm(az, ay, ax):
        return _permute3d(_permute3d(_permute3d(iz + az) + iy + ay) + ix + ax)

    p0 = corner_perm(0.0, 0.0, 0.0)
    p1 = corner_perm(i1z, i1y, i1x)
    p2 = corner_perm(i2z, i2y, i2x)
    p3 = corner_perm(1.0, 1.0, 1.0)

    # gradient construction: N*N points over a square mapped onto an
    # octahedron, ns = n_*D.wyz - D.xzx with D = (0, .5, 1, 2); the op
    # order of each term is the JAX package's (folded in double)
    n_ = 1.0 / 7.0
    D_y, D_z = 0.5, 1.0
    ns_x = n_ * 2.0 - 0.0          # D.w*n_ - D.x = 2/7
    ns_y = n_ * D_y - D_z          # = 1/14 - 1
    ns_z = n_ * D_z - 0.0          # = 1/7

    def gradients(p):
        j = p - 49.0 * torch.floor(p * ns_z * ns_z)
        x_ = torch.floor(j * ns_z)
        y_ = torch.floor(j - 7.0 * x_)
        gx_ = x_ * ns_x + ns_y
        gy_ = y_ * ns_x + ns_y
        h = 1.0 - torch.abs(gx_) - torch.abs(gy_)
        sx = torch.floor(gx_) * 2.0 + 1.0
        sy = torch.floor(gy_) * 2.0 + 1.0
        sh = -(h <= 0.0).to(f32)
        ax = gx_ + sx * sh
        ay = gy_ + sy * sh
        return ax, ay, h

    def norm3(gx_, gy_, gz_):
        n = _taylor_inv_sqrt(gx_ * gx_ + gy_ * gy_ + gz_ * gz_)
        return gx_ * n, gy_ * n, gz_ * n

    def contrib(p, cx, cy, cz):
        gx_, gy_, gz_ = norm3(*gradients(p))
        m = torch.clamp_min(0.6 - (cx * cx + cy * cy + cz * cz), 0.0)
        m = m * m
        return m * m * (gx_ * cx + gy_ * cy + gz_ * cz)

    return 42.0 * (contrib(p0, x0, y0, z0)
                   + contrib(p1, x1, y1, z1)
                   + contrib(p2, x2, y2, z2)
                   + contrib(p3, x3, y3, z3))


def _permute_w(x):
    return _mod((34.0 * x + 1.0) * x, 289.0)


def worley(px, py, jitter=1.0, manhattan=False):
    """2-D cellular (Worley) noise returning (F1, F2)
    (chunkgen.comp:174-212)."""
    px, py = _f32(px), _f32(py)
    K = 0.142857142857
    Ko = 0.428571428571
    pix = _mod(torch.floor(px), 289.0)
    piy = _mod(torch.floor(py), 289.0)
    pfx = px - torch.floor(px)
    pfy = py - torch.floor(py)

    oi = torch.tensor([-1.0, 0.0, 1.0], dtype=f32, device=px.device)
    of_ = torch.tensor([-0.5, 0.5, 1.5], dtype=f32, device=px.device)
    pxp = _permute_w(pix[..., None] + oi)  # (..., 3)

    def column(col_idx, dx_base):
        p = _permute_w(pxp[..., col_idx:col_idx + 1] + piy[..., None] + oi)
        ox = (p * K) - torch.floor(p * K) - Ko
        oy = _mod(torch.floor(p * K), 7.0) * K - Ko
        dx = pfx[..., None] + dx_base + jitter * ox
        dy = pfy[..., None] - of_ + jitter * oy
        if manhattan:
            return torch.abs(dx) + torch.abs(dy)
        return dx * dx + dy * dy

    d1 = column(0, 0.5)
    d2 = column(1, -0.5)
    d3 = column(2, -1.5)

    d1a = torch.minimum(d1, d2)
    d2 = torch.maximum(d1, d2)
    d2 = torch.minimum(d2, d3)
    d1 = torch.minimum(d1a, d2)
    d2 = torch.maximum(d1a, d2)

    # sort the three candidates in d1 so F1 = d1[...,0]
    d1x, d1y, d1z = d1[..., 0], d1[..., 1], d1[..., 2]
    d1x, d1y = torch.minimum(d1x, d1y), torch.maximum(d1x, d1y)
    d1x, d1z = torch.minimum(d1x, d1z), torch.maximum(d1x, d1z)
    d1y = torch.minimum(d1y, d2[..., 1])
    d1z = torch.minimum(d1z, d2[..., 2])
    d1y = torch.minimum(d1y, d1z)
    d1y = torch.minimum(d1y, d2[..., 0])
    return _sqrt(d1x), _sqrt(d1y)


def sample_perlin_terrain(x, y, z, scale=0.003, slab=None):
    """The chunkgen terrain composition (chunkgen.comp:214-226): 2-D Perlin
    base height, Worley-ridge F2 added where 3-D simplex is positive; solid
    (material 1) below the surface.  Coordinates in world voxels, int or
    float tensors that broadcast, e.g. (X, 1, 1), (1, Y, 1), (1, 1, Z).

    ``cnoise`` and ``worley`` see only (x, z), so they run at (X, 1, Z);
    ``snoise`` spans the grid, and with ``slab`` it runs over ``slab``
    rows of y (dim 1) at a time: a few float32 temporaries of
    X * slab * Z each, where a whole 512^3 grid would hold ~30 of 0.5 GB
    at once.  The result is elementwise, so slabs change no bit."""
    x, y, z = _f32(x), _f32(y), _f32(z)
    px = x * scale
    pz = z * scale
    land = cnoise(px, pz)
    _, f2 = worley(px, pz, 1.0, False)

    def solid(ys):
        gate = snoise(x * scale * 0.5, ys * scale * 0.5, z * scale * 0.5) > 0.0
        h = land + torch.where(gate, f2, 0.0)
        return torch.where(ys * scale > h, 0, 1).to(torch.uint8)

    if slab is None:
        return solid(y)
    return torch.cat([solid(y[:, a:a + slab])
                      for a in range(0, y.shape[1], slab)], dim=1)
