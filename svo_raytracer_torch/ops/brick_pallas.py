"""The v1 brick-wavefront traversal (port of
svo_raytracer_tpu/ops/brick_pallas.py: ``intersect_bricks_tpu`` and its
Pallas round kernel ``_round_kernel``, K3).

Each ray advances in rounds.  A round runs a voxel DDA through the ray's
current 32^3 mixed brick (phase 1), then a DDA of the L0 brick grid to the
next occupied brick (phase 2); a uniform-solid brick is a hit at its entry
voxel, any other stop is the brick the next round enters.  The TPU engine
bins rays by brick between rounds so that each tile's brick can be
pipelined into VMEM; the per-ray answer does not depend on the binning,
except that JAX rays overflowing a bin's padding lose a round.

  * :func:`trace_plain` is the plain PyTorch version, the rounds
    lock-step over the pending rays;
  * kernel K3 (``csrc/brick_round.cu`` over ``csrc/brick_round.cuh``) runs
    one thread per ray looping its own rounds, bit-equal to the plain
    version, over the rays in the order its caller passes;
  * :func:`intersect_bricks_tpu` takes K3 for CUDA tensors and the plain
    version for CPU tensors, and decodes the hits into a HitResult.  It
    serves as the ``intersect_fn`` of ``shade.shade_*``.

The scene is a ``brick_scene.BrickScene`` after ``to_device`` (G <= 32).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import brick_trace, kernel_build
from .hit import HitResult

f32 = np.float32

EXIT_EPS = float(f32(1e-2))   # brick_pallas._EXIT_EPS (not brick_trace's)
INNER_STEPS = 100             # phase-1 step budget
MAX_G = 32                    # the L0 grid of this engine (world <= 1024^3)
BRICK_WORDS = 32768
FIELDS = ("hit", "attr", "hvox", "t", "iters")

_P, _I = ctypes.c_void_p, ctypes.c_int
K3 = kernel_build.Kernel("brick_round", ["brick_round.cu"], "brick_round",
                         [_P] * 5 + [_I] * 2 + [_P] * 4 + [_I] + [_P] * 5
                         + [_P])


def _dda_vec(px, py, pz, dc, inv, n, cell, probe, max_steps, act0):
    """Masked DDA over an n^3 grid of ``cell``-edge cells in [0, n*cell]^3
    (brick_pallas._dda_vec; per-ray C++ in csrc/brick_round.cuh).  Ray
    args are (R,) tensors, ``act0`` bool; ``probe(m, x, y, z)`` tells
    whether the cells (x, y, z) of the rays of mask ``m`` are solid.
    Returns (hit, ix, iy, iz, t, inside, steps).  Stops once no ray is
    active: later masked steps change nothing."""
    dxc, dyc, dzc = dc
    inv_x, inv_y, inv_z = inv
    fcell = float(f32(cell))
    gf = float(f32(n) * f32(cell))
    t1x, t2x = (0.0 - px) * inv_x, (gf - px) * inv_x
    t1y, t2y = (0.0 - py) * inv_y, (gf - py) * inv_y
    t1z, t2z = (0.0 - pz) * inv_z, (gf - pz) * inv_z
    t_ent = torch.maximum(torch.maximum(torch.minimum(t1x, t2x),
                                        torch.minimum(t1y, t2y)),
                          torch.minimum(t1z, t2z))
    t_out = torch.minimum(torch.minimum(torch.maximum(t1x, t2x),
                                        torch.maximum(t1y, t2y)),
                          torch.maximum(t1z, t2z))
    zf = torch.zeros_like(px)
    t0 = torch.maximum(t_ent, zf)
    misses_box = (t_ent > t_out) | (t_out < 0.0)
    push = torch.where(t0 > 0.0, t0 + float(f32(1e-4) * f32(cell)), zf)
    qx = px + push * dxc
    qy = py + push * dyc
    qz = pz + push * dzc
    # truncation toward zero, then the clip (astype(i32), jnp.clip)
    ix = (qx / fcell).to(torch.int32).clamp(0, n - 1)
    iy = (qy / fcell).to(torch.int32).clamp(0, n - 1)
    iz = (qz / fcell).to(torch.int32).clamp(0, n - 1)
    one = torch.ones_like(ix)
    sx = torch.where(dxc > 0, one, -one)
    sy = torch.where(dyc > 0, one, -one)
    sz = torch.where(dzc > 0, one, -one)
    tx = push + (torch.where(dxc > 0, ix + 1, ix).float() * fcell - qx) \
        * inv_x
    ty = push + (torch.where(dyc > 0, iy + 1, iy).float() * fcell - qy) \
        * inv_y
    tz = push + (torch.where(dzc > 0, iz + 1, iz).float() * fcell - qz) \
        * inv_z
    adx, ady, adz = (i.abs() * fcell for i in inv)
    alive0 = act0 & ~misses_box
    t = torch.where(alive0, push, zf)
    hit = torch.zeros_like(alive0)
    steps = torch.zeros_like(ix)

    def inside_of(ix, iy, iz):
        return ((ix >= 0) & (ix < n) & (iy >= 0) & (iy < n) & (iz >= 0)
                & (iz < n))

    for _ in range(max_steps):
        act = alive0 & inside_of(ix, iy, iz) & ~hit
        if not bool(act.any()):
            break
        solid = torch.zeros_like(act)
        solid[act] = probe(act, ix[act], iy[act], iz[act])
        hit = hit | solid
        act = act & ~solid
        steps = steps + act.to(torch.int32)
        mx = (tx <= ty) & (tx <= tz)
        my = ~mx & (ty <= tz)
        mz = ~mx & ~my
        t = torch.where(act, torch.minimum(torch.minimum(tx, ty), tz), t)
        ix = torch.where(act & mx, ix + sx, ix)
        iy = torch.where(act & my, iy + sy, iy)
        iz = torch.where(act & mz, iz + sz, iz)
        tx = torch.where(act & mx, tx + adx, tx)
        ty = torch.where(act & my, ty + ady, ty)
        tz = torch.where(act & mz, tz + adz, tz)
    inside = inside_of(ix, iy, iz) & ~misses_box
    return hit, ix, iy, iz, t, inside, steps


def _bit(words, index, z):
    """Bit z of words[index] (i32 table, int tensors)."""
    return ((words[index.long()] >> z) & 1) != 0


def trace_plain(scene, o, d, alive, max_rounds):
    """Plain PyTorch version of kernel K3, the rounds lock-step over the
    pending rays (a finished ray leaves the batch, which changes no other
    ray's result).

    o: (B,3) f32 voxel-unit origins; d: (B,3) f32 directions; alive: (B,)
    bool.  Returns dict(hit, attr, hvox, t, iters) as the kernel writes
    them: hvox = (x*ws + y)*ws + z of the hit voxel, t its distance in
    voxel units, iters the DDA steps over all rounds."""
    G, ws = scene.grid_size, scene.world_size
    B, dev = o.shape[0], o.device
    hit = torch.zeros(B, dtype=torch.int32, device=dev)
    attr = torch.zeros_like(hit)
    hvox = torch.zeros_like(hit)
    t = torch.zeros(B, dtype=torch.float32, device=dev)
    iters = torch.zeros_like(hit)
    l0 = scene.l0_table.view(-1)
    occ = scene.occ_words.view(-1)
    attrs = scene.attrs.view(-1)
    dc_all = brick_trace._clamp_dir(d)
    inv_all = 1.0 / dc_all
    idx = torch.nonzero(alive).flatten()
    n = idx.numel()
    t_tot = torch.zeros(n, dtype=torch.float32, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cell = torch.zeros_like(slot)
    it = torch.zeros_like(slot)
    for _ in range(max_rounds):
        if idx.numel() == 0:
            break
        ox, oy, oz = o[idx].unbind(1)
        dx, dy, dz = d[idx].unbind(1)
        dc, inv = dc_all[idx].unbind(1), inv_all[idx].unbind(1)
        px, py, pz = ox + t_tot * dx, oy + t_tot * dy, oz + t_tot * dz
        # ---- phase 1: voxel DDA inside the current mixed brick
        in_brick = slot >= 0
        base = slot.clamp_min(0) * 1024
        cx = torch.div(cell, G * G, rounding_mode="floor")
        cy = torch.div(cell, G, rounding_mode="floor") % G
        cz = cell % G
        hit1, fx, fy, fz, t1, _, st1 = _dda_vec(
            px - cx.float() * 32.0, py - cy.float() * 32.0,
            pz - cz.float() * 32.0, dc, inv, 32, 1.0,
            lambda m, x, y, z: _bit(occ, base[m] + x * 32 + y, z),
            INNER_STEPS,
            in_brick)
        # ---- phase 2: L0 march to the next occupied brick
        t2_0 = torch.where(in_brick, t1 + EXIT_EPS, torch.zeros_like(t1))
        hit2, b2x, b2y, b2z, t2, ins2, st2 = _dda_vec(
            px + t2_0 * dc[0], py + t2_0 * dc[1], pz + t2_0 * dc[2], dc, inv,
            G, 32.0, lambda m, x, y, z: _bit(l0, x * G + y, z), 3 * G + 4,
            ~hit1)
        it = it + st1 + st2
        # ---- classify (brick_pallas._intersect_impl round_body)
        stop = ~hit1 & (hit2 | ins2)
        r_t = t2_0 + t2
        cell2 = ((b2x * G + b2y) * G + b2z).clamp(0, G * G * G - 1)
        s2 = scene.brick_slot[cell2.long()]
        uattr = scene.brick_attr[cell2.long()]
        uni = stop & (s2 < 0) & ((uattr & 0xFF) != 0)
        ux, uy, uz = (torch.div(cell2, G * G, rounding_mode="floor") * 32,
                      torch.div(cell2, G, rounding_mode="floor") % G * 32,
                      cell2 % G * 32)
        ex = (px + r_t * dx).to(torch.int32).clamp(min=ux, max=ux + 31)
        ey = (py + r_t * dy).to(torch.int32).clamp(min=uy, max=uy + 31)
        ez = (pz + r_t * dz).to(torch.int32).clamp(min=uz, max=uz + 31)
        widx = (fx * 32 + fy) * 32 + fz
        gx, gy, gz = cx * 32 + fx, cy * 32 + fy, cz * 32 + fz
        a1 = torch.zeros_like(widx)
        a1[hit1] = attrs[base[hit1].long() * 32 + widx[hit1]]
        got = hit1 | uni
        done = got | ~stop
        fin = idx[done]
        g = got[done]
        hit[fin] = g.to(torch.int32)
        attr[fin] = torch.where(hit1, a1, uattr)[done] * g
        hvox[fin] = torch.where(hit1, (gx * ws + gy) * ws + gz,
                                (ex * ws + ey) * ws + ez)[done] * g
        t[fin] = torch.where(g, torch.where(hit1, t_tot + t1,
                                            t_tot + r_t)[done],
                             torch.zeros_like(t[fin]))
        iters[fin] = it[done]
        keep = ~done
        idx, it = idx[keep], it[keep]
        slot = torch.where(s2 >= 0, s2, -1)[keep]
        cell, t_tot = cell2[keep], (t_tot + r_t)[keep]
    iters[idx] = it      # still pending after max_rounds: misses
    return dict(hit=hit != 0, attr=attr, hvox=hvox, t=t, iters=iters)


def _args(scene):
    arrs = [getattr(scene, f) for f in ("l0_table", "brick_slot",
                                        "brick_attr", "occ_words", "attrs")]
    for a in arrs:
        if a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError("scene tables must be contiguous int32 "
                             "(BrickScene.to_device)")
    return [a.data_ptr() for a in arrs] + [scene.grid_size]


def trace_kernel(scene, o, d, alive, max_rounds, order=None):
    """Kernel K3 on the card: same contract as :func:`trace_plain`.
    Thread k traces ray ``order[k]`` (a (B,) int64 permutation on the
    rays' device, e.g. ``traverse.tile_order``), or ray k when ``order``
    is None; the records land at the rays' own slots either way.
    Launches K3 alone: the bool tensors' bytes are its u8 input and
    output."""
    B, dev = o.shape[0], o.device
    kernel_build.check_order(order, B, dev)
    if alive.dtype != torch.bool or not alive.is_contiguous():
        raise ValueError("alive must be a contiguous bool tensor")
    out = dict(hit=torch.empty(B, dtype=torch.bool, device=dev),
               attr=torch.empty(B, dtype=torch.int32, device=dev),
               hvox=torch.empty(B, dtype=torch.int32, device=dev),
               t=torch.empty(B, dtype=torch.float32, device=dev),
               iters=torch.empty(B, dtype=torch.int32, device=dev))
    if B:
        K3.launch(dev, *_args(scene), max_rounds, o.data_ptr(), d.data_ptr(),
                  alive.view(torch.uint8).data_ptr(),
                  None if order is None else order.data_ptr(), B,
                  *[out[f].data_ptr() for f in FIELDS])
    return out


def trace(scene, o, d, alive, max_rounds, order=None):
    """K3's records of (B,3) voxel-unit rays: the kernel over the rays in
    ``order`` (None: ray order) for CUDA tensors, its plain version for
    CPU tensors (in ray order: the records do not depend on the
    order)."""
    B = o.shape[0]
    if o.shape != (B, 3) or d.shape != (B, 3) or alive.shape != (B,):
        raise ValueError(f"ray shapes {tuple(o.shape)} {tuple(d.shape)} "
                         f"{tuple(alive.shape)}")
    for a in (d, alive, scene.l0_table, scene.attrs):
        if a.device != o.device:
            raise ValueError(f"tensor on {a.device}, rays on {o.device}")
    kernel_build.check_order(order, B, o.device)
    if o.device.type == "cpu":
        return trace_plain(scene, o, d, alive, max_rounds)
    return trace_kernel(scene, o, d, alive, max_rounds, order)


def intersect_bricks_tpu(scene, origins, dirs, max_depth=None,
                         cone_trace=False, max_iterations=None, active=None,
                         max_rounds=24, order=None) -> HitResult:
    """Trace (B,3) world-space rays through a device BrickScene (G <= 32);
    signature-compatible with the JAX package's (``max_depth``,
    ``cone_trace`` and ``max_iterations`` are accepted and unused: the
    engine resolves finest leaves).  Non-finite and inactive rays are
    misses, as are rays still pending after ``max_rounds`` rounds.
    ``order`` is the (B,) int64 permutation K3 traces the rays in
    (``traverse.tile_order`` for a render's pixel rays; None: ray order),
    which changes no result.  The JAX package's TPU-only knobs
    (``slack``, ``interpret``) have no counterpart."""
    del max_depth, cone_trace, max_iterations
    if scene.grid_size > MAX_G:
        raise ValueError("brick-wavefront L0 grid is limited to 32^3 "
                         f"(world <= 1024^3); got G={scene.grid_size}")
    ws = scene.world_size
    o = origins.to(torch.float32)
    d = dirs.to(torch.float32)
    finite = torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
    alive = finite if active is None else finite & active.to(torch.bool)
    rec = trace(scene, ((o - 1.0) * float(ws)).contiguous(), d.contiguous(),
                alive.contiguous(), max_rounds, order)
    h = rec["hvox"]
    hvx = torch.div(h, ws * ws, rounding_mode="floor")
    hvy = torch.div(h, ws, rounding_mode="floor") % ws
    return brick_trace.decode_hits(ws, o, d, rec["hit"], rec["attr"], hvx,
                                   hvy, h % ws, rec["t"], rec["iters"])
