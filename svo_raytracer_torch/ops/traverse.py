"""ESVO octree traversal (port of svo_raytracer_tpu/ops/traverse.py:
``make_packed_table``, ``_setup``, ``_make_step``, ``_decode`` and
``intersect_octree``).

The reference walks a Laine-Karras sparse voxel octree one GL thread per
pixel (``src/shaders/svotrace.comp:211-432``).  The JAX package runs that
walk as an XLA while_loop over lock-step ray batches.  Here:

  * :func:`intersect_plain` is the plain PyTorch version: the JAX step,
    op for op, over the rays still active (each ray's state evolves from
    its own state alone, so dropping finished rays changes no result);
  * kernel KE (``csrc/esvo.cu`` over ``csrc/esvo_ray.cuh``) runs the same
    walk one thread per ray on the GPU, bit-equal to the plain version,
    over the rays in a given order (:func:`tile_order` for a render's
    segments; cone-traced segments regrouped by octant in each block);
  * :func:`intersect_octree` takes KE for CUDA tensors and the plain
    version for CPU tensors, then decodes the hit in PyTorch.

The float-mantissa POP (svotrace.comp:347-368) is integer bit math on the
float32 position bits.  Positions lie in (0, 3), so their sign bit is 0
and PyTorch's arithmetic int32 shifts act as the JAX package's logical
uint32 shifts; the plain version checks that.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import constants as C
from . import kernel_build
from .hit import HitResult

MAX_SCALE = C.MAX_SCALE
EPS = float(np.float32(C.EPSILON))

#: the state fields _decode reads (traverse.py _DECODE_STATE), in the order
#: of KE's float and int output planes
F_FIELDS = ("t_min", "t_max", "px", "py", "pz", "scale_exp2")
I_FIELDS = ("idx", "parent", "scale", "iters", "done")

_P, _I = ctypes.c_void_p, ctypes.c_int
_KE_ARGS = [_P] * 5 + [_I] * 5 + [_P] * 3
KE = kernel_build.Kernel("esvo", ["esvo.cu"], "esvo_trace", _KE_ARGS)
# Cone-traced segments take the binned schedule: the same library's second
# entry point.  Its launches count in KE.launches, and in
# KE_BINNED.launches as well.
KE_BINNED = kernel_build.Kernel("esvo", ["esvo.cu"], "esvo_trace_binned",
                                _KE_ARGS)
TILE_W, TILE_H = 8, 4    # the pixel tiles a render's segments are traced in


def make_packed_table(tree) -> torch.Tensor:
    """(n,) int32 per-node word: (effective child base << 1) | value != 0.

    The node's 2-bit type tag lives in its parent's mask; a node whose tag
    is not BRANCH gets child base 0 (svotrace.comp:103-130)."""
    child, mask, value, _ = tree.arrays()
    n = child.numel()
    tags = torch.zeros(n, dtype=torch.int32, device=child.device)
    br = torch.nonzero(child != 0).flatten()
    base = child[br].long()
    pmask = mask[br]
    for k in range(8):
        slot = base + k
        ok = slot < n  # the JAX scatter drops out-of-range slots
        tags[slot[ok]] = ((pmask >> (2 * k)) & 3)[ok]
    eff = torch.where(tags == C.TAG_BRANCH, child, torch.zeros_like(child))
    return ((eff << 1) | (value != 0).to(torch.int32)).contiguous()


def _clamp(v):
    eps = torch.full_like(v, EPS)
    return torch.where(v.abs() < EPS, torch.where(v >= 0, eps, -eps), v)


def _ray_consts(o, d, active):
    """Per-ray constants of _setup: clamped direction, mirror octant and
    the retire-at-once mask (non-finite or inactive rays)."""
    dx, dy, dz = (_clamp(d[:, i]) for i in range(3))
    octant = ((dx > 0).to(torch.int32) | ((dy > 0).to(torch.int32) << 1)
              | ((dz > 0).to(torch.int32) << 2))
    finite = torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
    dead0 = ~(finite & active)
    return dict(dx=dx, dy=dy, dz=dz, octant=octant, dead0=dead0)


def _setup(o, d, active):
    """_setup (svotrace.comp:226-257): the t-coefficients and the initial
    state of every ray."""
    k = _ray_consts(o, d, active)
    dx, dy, dz = k["dx"], k["dy"], k["dz"]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    cx, cy, cz = 1.0 / -dx.abs(), 1.0 / -dy.abs(), 1.0 / -dz.abs()
    bx = torch.where(dx > 0, 3.0 * cx - cx * ox, cx * ox)
    by = torch.where(dy > 0, 3.0 * cy - cy * oy, cy * oy)
    bz = torch.where(dz > 0, 3.0 * cz - cz * oz, cz * oz)
    t_min = torch.maximum(torch.maximum(2.0 * cx - bx, 2.0 * cy - by),
                          2.0 * cz - bz)
    t_max = torch.minimum(torch.minimum(cx - bx, cy - by), cz - bz)
    t_min = torch.maximum(t_min, torch.zeros_like(t_min))
    condx, condy, condz = (1.5 * c - b > t_min
                           for c, b in ((cx, bx), (cy, by), (cz, bz)))
    one, onehalf = torch.ones_like(t_min), torch.full_like(t_min, 1.5)
    B = o.shape[0]
    i32 = dict(dtype=torch.int32, device=o.device)
    state = dict(
        t_min=t_min, t_max=t_max,
        px=torch.where(condx, onehalf, one),
        py=torch.where(condy, onehalf, one),
        pz=torch.where(condz, onehalf, one),
        scale_exp2=torch.full((B,), 0.5, dtype=torch.float32,
                              device=o.device),
        idx=(condx.to(torch.int32) | (condy.to(torch.int32) << 1)
             | (condz.to(torch.int32) << 2)),
        parent=torch.zeros(B, **i32),
        scale=torch.full((B,), MAX_SCALE - 1, **i32),
        iters=torch.zeros(B, **i32),
        done=k["dead0"].to(torch.int32))
    coef = dict(cx=cx, cy=cy, cz=cz, bx=bx, by=by, bz=bz,
                octant=k["octant"])
    return state, coef


def _find_msb(x):
    """31 - clz(x) for int32 x >= 0, -1 for 0: an exact shift-and-compare
    ladder (float log2 is not exact)."""
    n = torch.zeros_like(x)
    y = x
    for sh in (16, 8, 4, 2, 1):
        big = y >= (1 << sh)
        n = n + torch.where(big, sh, 0)
        y = torch.where(big, y >> sh, y)
    return torch.where(x == 0, -1, n).to(torch.int32)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _float(b):
    return b.to(torch.int32).contiguous().view(torch.float32)


def _step(s, c, stack_node, stack_word, packed, root_word, cone, lo):
    """One step of every ray in ``s`` (all active): _make_step's
    PUSH / ADVANCE / POP (svotrace.comp:262-376), in place on ``s`` and the
    (A, MAX_SCALE) stacks."""
    cx, cy, cz, bx, by, bz = (c[k] for k in ("cx", "cy", "cz", "bx", "by",
                                             "bz"))
    t_min, t_max, h = s["t_min"], s["t_max"], s["h"]
    px, py, pz, se = s["px"], s["py"], s["pz"], s["scale_exp2"]
    idx, scale, parent, pword = s["idx"], s["scale"], s["parent"], s["pword"]
    s["iters"] = s["iters"] + 1
    if cone:  # LOD clamp, sticky (svotrace.comp:275-277)
        s["max_depth"] = torch.where(t_min > 0.05, 11, s["max_depth"]).to(
            torch.int32)

    txc, tyc, tzc = px * cx - bx, py * cy - by, pz * cz - bz
    tc_max = torch.minimum(torch.minimum(txc, tyc), tzc)
    ci = (pword >> 1) + (idx ^ c["octant"])
    cword = packed[ci.long()]
    hit_cond = ((cword & 1) != 0) & (t_min <= t_max)
    depth_break = hit_cond & (MAX_SCALE - scale == s["max_depth"])
    tv_max = torch.minimum(t_max, tc_max)
    half = se * 0.5
    descend = hit_cond & ~depth_break & (t_min <= tv_max)
    leaf_break = descend & ((cword >> 1) == 0)
    push = descend & ~leaf_break
    adv = ~depth_break & ~descend

    # ---- PUSH (svotrace.comp:315-334): stack (parent, its word) at scale
    store = torch.nonzero(push & (tc_max < h) & (scale >= lo)).flatten()
    col = scale[store].long()
    stack_node[store, col] = parent[store]
    stack_word[store, col] = pword[store]
    cxm = half * cx + txc > t_min
    cym = half * cy + tyc > t_min
    czm = half * cz + tzc > t_min
    pidx = (cxm.to(torch.int32) | (cym.to(torch.int32) << 1)
            | (czm.to(torch.int32) << 2))

    # ---- ADVANCE (svotrace.comp:337-344)
    sx = adv & (txc <= tc_max)
    sy = adv & (tyc <= tc_max)
    sz = adv & (tzc <= tc_max)
    step_mask = (sx.to(torch.int32) | (sy.to(torch.int32) << 1)
                 | (sz.to(torch.int32) << 2))
    apx = torch.where(sx, px - se, px)
    apy = torch.where(sy, py - se, py)
    apz = torch.where(sz, pz - se, pz)
    aidx = idx ^ step_mask

    # ---- POP (svotrace.comp:347-368)
    pop = adv & ((aidx & step_mask) != 0)
    bpx, bpy, bpz = _bits(apx), _bits(apy), _bits(apz)
    if bool(((bpx | bpy | bpz) < 0)[pop].any()):
        raise AssertionError("ESVO position left (0, 3): sign bit set")
    zero = torch.zeros_like(bpx)
    diff = (torch.where(sx, bpx ^ _bits(apx + se), zero)
            | torch.where(sy, bpy ^ _bits(apy + se), zero)
            | torch.where(sz, bpz ^ _bits(apz + se), zero))
    new_scale = _find_msb(diff)
    new_exp2 = _float((new_scale - MAX_SCALE + 127) << 23)
    safe = new_scale.clamp(0, MAX_SCALE)
    win = (safe >= lo) & (safe < MAX_SCALE)
    slot = torch.where(win, safe, 0).long()[:, None]
    pop_parent = torch.where(win, stack_node.gather(1, slot)[:, 0], zero)
    pop_word = torch.where(win, stack_word.gather(1, slot)[:, 0], zero)
    pop_word = torch.where(pop_parent == 0, root_word, pop_word)
    shx, shy, shz = bpx >> safe, bpy >> safe, bpz >> safe
    up = safe + 1
    pop_tmax = torch.minimum(
        torch.minimum(_float((bpx >> up) << up) * cx - bx,
                      _float((bpy >> up) << up) * cy - by),
        _float((bpz >> up) << up) * cz - bz)
    pop_idx = (shx & 1) | ((shy & 1) << 1) | ((shz & 1) << 2)

    def sel(on_push, on_pop, other):
        return torch.where(push, on_push, torch.where(pop, on_pop, other))

    s["px"] = sel(torch.where(cxm, px + half, px), _float(shx << safe), apx)
    s["py"] = sel(torch.where(cym, py + half, py), _float(shy << safe), apy)
    s["pz"] = sel(torch.where(czm, pz + half, pz), _float(shz << safe), apz)
    s["idx"] = sel(pidx, pop_idx, aidx)
    s["t_min"] = torch.where(adv, tc_max, t_min)
    s["t_max"] = sel(tv_max, pop_tmax, t_max)
    s["scale"] = sel(scale - 1, new_scale, scale)
    s["scale_exp2"] = sel(half, new_exp2, se)
    s["parent"] = sel(ci, pop_parent, parent)
    s["pword"] = sel(cword, pop_word, pword)
    s["h"] = sel(tc_max, torch.zeros_like(h), h)
    s["done"] = (leaf_break | depth_break
                 | (s["scale"] >= MAX_SCALE)).to(torch.int32)


def intersect_plain(packed, o, d, alive, max_depth=C.MAX_DEPTH,
                    cone_trace=False,
                    max_iterations=C.MAX_RAYCAST_ITERATIONS,
                    stack_depth=C.MAX_DEPTH):
    """Plain PyTorch version of kernel KE.

    packed: (n,) int32 words; o, d: (B,3) float32 world-space rays;
    alive: (B,) bool.  Returns the decode state as a dict of (B,) tensors
    (F_FIELDS float32, I_FIELDS int32), as KE writes it."""
    state, coef = _setup(o, d, alive)
    root_word = packed[0]
    lo = MAX_SCALE - stack_depth
    rows = torch.nonzero((state["done"] == 0)
                         & (state["iters"] < max_iterations)).flatten()
    s = {k: v[rows] for k, v in state.items()}
    s["h"] = s["t_max"]
    s["pword"] = root_word.expand(rows.numel()).clone()
    s["max_depth"] = torch.full_like(s["idx"], max_depth)
    c = {k: v[rows] for k, v in coef.items()}
    A = rows.numel()
    i32 = dict(dtype=torch.int32, device=o.device)
    stack_node = torch.zeros((A, MAX_SCALE), **i32)
    stack_word = torch.zeros((A, MAX_SCALE), **i32)
    while rows.numel():
        _step(s, c, stack_node, stack_word, packed, root_word, cone_trace,
              lo)
        fin = (s["done"] != 0) | (s["iters"] >= max_iterations)
        if bool(fin.any()):
            out = rows[fin]
            for k in state:
                state[k][out] = s[k][fin]
            keep = ~fin
            rows = rows[keep]
            s = {k: v[keep] for k, v in s.items()}
            c = {k: v[keep] for k, v in c.items()}
            stack_node, stack_word = stack_node[keep], stack_word[keep]
    return state


@functools.lru_cache(maxsize=8)
def _tile_order(width, height, device):
    tx, ty = -(-width // TILE_W), -(-height // TILE_H)
    wp = tx * TILE_W
    # padded row-major ids taken tile by tile, then the padding dropped
    pad = torch.arange(ty * TILE_H * wp, device=device).reshape(
        ty, TILE_H, tx, TILE_W).permute(0, 2, 1, 3).reshape(-1)
    y, x = pad // wp, pad % wp
    keep = (x < width) & (y < height)
    return (y * width + x)[keep]


def tile_order(width, height, device):
    """The (width * height,) int64 permutation a render traces its
    segments in: row-major pixel ids (y * width + x) taken in TILE_W x
    TILE_H tiles, the tiles row-major, pixels row-major within a tile
    (the last column and row of tiles cut at the image's edge).  Built
    once per image size and device, then cached: callers must not write
    to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:   # "cuda" and "cuda:0" alike
        dev = torch.device("cuda", torch.cuda.current_device())
    return _tile_order(int(width), int(height), dev)


def intersect_kernel(packed, o, d, alive, max_depth=C.MAX_DEPTH,
                     cone_trace=False,
                     max_iterations=C.MAX_RAYCAST_ITERATIONS,
                     stack_depth=C.MAX_DEPTH, order=None):
    """Kernel KE on the card: same contract as :func:`intersect_plain`.
    Thread k traces ray ``order[k]`` (a (B,) int64 permutation on the
    rays' device, e.g. :func:`tile_order`), or ray k when ``order`` is
    None; the records land at the rays' own slots either way.  A
    cone-traced segment takes the binned schedule (KE_BINNED): each block
    regroups its rays by direction octant before tracing them."""
    _check(packed, o, d, alive, "cuda")
    B = o.shape[0]
    _check_order(order, B, o.device)
    f_out = torch.empty((len(F_FIELDS), B), dtype=torch.float32,
                        device=o.device)
    i_out = torch.empty((len(I_FIELDS), B), dtype=torch.int32,
                        device=o.device)
    if B:
        kern = KE_BINNED if cone_trace else KE
        fn = kern.load()
        act = alive.to(torch.uint8)
        with torch.cuda.device(o.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(packed.data_ptr(), o.data_ptr(), d.data_ptr(),
                    act.data_ptr(),
                    None if order is None else order.data_ptr(), B,
                    int(max_depth), int(bool(cone_trace)),
                    int(max_iterations), int(stack_depth), f_out.data_ptr(),
                    i_out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"KE launch failed with cudaError {rc}")
        KE.launches += 1
        if cone_trace:
            KE_BINNED.launches += 1
    rec = dict(zip(F_FIELDS, f_out.unbind(0)))
    rec.update(zip(I_FIELDS, i_out.unbind(0)))
    return rec


def _check_order(order, B, device):
    if order is not None and (order.shape != (B,)
                              or order.dtype != torch.int64
                              or order.device != device
                              or not order.is_contiguous()):
        raise ValueError("order must be a contiguous (B,) int64 tensor on "
                         "the rays' device")


def _check(packed, o, d, alive, device_type):
    B = o.shape[0]
    if o.shape != (B, 3) or d.shape != (B, 3) or alive.shape != (B,):
        raise ValueError(f"ray shapes {tuple(o.shape)} {tuple(d.shape)} "
                         f"{tuple(alive.shape)}")
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError("origins and directions must be float32")
    if alive.dtype != torch.bool or packed.dtype != torch.int32:
        raise ValueError("alive must be bool and packed int32")
    if o.device.type != device_type:
        raise ValueError(f"rays on {o.device}, expected {device_type}")
    for a in (d, alive, packed):
        if a.device != o.device:
            raise ValueError(f"tensor on {a.device}, rays on {o.device}")
    if not all(a.is_contiguous() for a in (packed, o, d, alive)):
        raise ValueError("ray tensors and the packed table must be "
                         "contiguous")


def trace(packed, o, d, alive, order=None, **kw):
    """The decode state of each ray: kernel KE over the rays in ``order``
    (None: ray order) for CUDA tensors, its plain version for CPU tensors
    (in ray order: the records do not depend on the order)."""
    if o.device.type == "cpu":
        _check(packed, o, d, alive, "cpu")
        _check_order(order, o.shape[0], o.device)
        return intersect_plain(packed, o, d, alive, **kw)
    return intersect_kernel(packed, o, d, alive, order=order, **kw)


def _decode(tree, rec, o, d, alive) -> HitResult:
    """Hit decode (svotrace.comp:380-431; traverse.py::_decode)."""
    child_t, mask_t, value_t, normal_t = tree.arrays()
    k = _ray_consts(o, d, alive)
    parent = rec["parent"].long()
    cs = rec["idx"] ^ k["octant"]
    ci = child_t[parent] + cs
    tag = (mask_t[parent] >> (2 * cs)) & 3
    cil = ci.long()
    zero = torch.zeros_like(ci)
    # the tag-dependent raw normal field (octree.effective_normal_raw)
    raw = torch.where(tag == C.TAG_SURFACE_LEAF, normal_t[cil],
                      torch.where(tag == C.TAG_NON_SURFACE_LEAF, zero,
                                  mask_t[cil]))
    # non-negative 16-bit fields: floor and truncating % and // agree
    nx = ((raw % 10) - 5).float()
    ny = (torch.div((raw % 100) - (raw % 10), 10, rounding_mode="floor")
          - 5).float()
    nz = (torch.div(raw - (raw % 100), 100, rounding_mode="floor")
          - 5).float()
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    has = raw != 0
    fz = torch.zeros_like(nx)
    normal = torch.stack([torch.where(has, nx / nlen, fz),
                          torch.where(has, ny / nlen, fz),
                          torch.where(has, nz / nlen, fz)], dim=-1)
    t_min, se = rec["t_min"], rec["scale_exp2"]
    scale = rec["scale"]
    # still active at the cap, or retired at once: a miss (:264-266)
    hit = ((rec["done"] != 0) & (scale < MAX_SCALE) & (t_min <= rec["t_max"])
           & ~k["dead0"])
    hit_pos = o + t_min[:, None] * d + normal * (se * 2)[:, None]
    vox = torch.stack([torch.where(k[a] > 0, 3.0 - rec[p] - se, rec[p])
                       for a, p in (("dx", "px"), ("dy", "py"),
                                    ("dz", "pz"))], dim=-1)
    voxel_pos = vox + normal * (se * 2 * float(np.float32(1.74)))[:, None]
    return HitResult(
        hit=hit, value=torch.where(hit, value_t[cil], zero), t=t_min,
        iters=rec["iters"], scale_exp2=se, depth=MAX_SCALE - scale,
        normal=normal, hit_pos=hit_pos, voxel_pos=voxel_pos,
        node=torch.where(hit, ci, torch.full_like(ci, -1)))


def _rays(tree, origin, direction, active):
    o = origin.to(torch.float32).contiguous()
    d = direction.to(torch.float32).contiguous()
    alive = (torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
             if active is None else active.to(torch.bool).contiguous())
    for a in (o, d, alive):
        if a.device != tree.device:
            raise ValueError(f"tensor on {a.device}, tree on {tree.device}")
    return o, d, alive


def intersect_octree(tree, origin, direction, max_depth=C.MAX_DEPTH,
                     cone_trace=False,
                     max_iterations=C.MAX_RAYCAST_ITERATIONS, active=None,
                     stack_depth=C.MAX_DEPTH, packed=None,
                     profile=None, order=None) -> HitResult:
    """Trace (B,3) world-space rays through a DeviceOctree.

    Inputs lie on the tree's device.  ``active`` (B,) masks rays out
    (they return as misses, as do non-finite rays); ``packed`` is the
    cached :func:`make_packed_table`; ``order`` the (B,) int64
    permutation the rays are traced in (:func:`tile_order` for a render's
    pixel rays; None: ray order), which changes no result.  ``profile``
    (a dict) receives the counts of traced rays, hits, rays still active
    at the iteration cap and KE launches (reading them synchronizes).
    Returns a HitResult whose ``node`` is the SoA index of the hit
    node."""
    if max_depth > stack_depth:
        raise ValueError(f"max_depth={max_depth} exceeds the stack_depth="
                         f"{stack_depth} stack window")
    if not 1 <= stack_depth <= MAX_SCALE:
        raise ValueError(f"stack_depth={stack_depth} outside [1, "
                         f"{MAX_SCALE}]")
    if packed is None:
        packed = make_packed_table(tree)
    o, d, alive = _rays(tree, origin, direction, active)
    launches = KE.launches
    rec = trace(packed, o, d, alive, order=order, max_depth=max_depth,
                cone_trace=cone_trace, max_iterations=max_iterations,
                stack_depth=stack_depth)
    res = _decode(tree, rec, o, d, alive)
    if profile is not None:
        traced = alive & torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
        profile.update(
            rays=int(traced.sum()), hits=int(res.hit.sum()),
            capped=int((traced & (rec["done"] == 0)).sum()),
            launches=KE.launches - launches)
    return res
