"""Differentiable rendering on the wavefront engine, with gradients
through visibility (port of svo_raytracer_tpu/diff/wave_diff.py, without
its sharded train step).

  * :func:`khit_chain` marches K hits per ray with the wavefront
    traversal (``wavefront.intersect_wavefront``: kernel K1 on the GPU,
    one launch per stage).  Stage k + 1 starts just past the exit face of
    stage k's hit cube, so on solid terrain it usually starts inside the
    voxel under the hit one and hits it at once.  Traversal is geometric
    and carries no gradients; the chain (per-hit parameter index, cube
    edge, light term) is the residual set.
  * :func:`composite_khit` is front-to-back transmittance compositing
    over the chain, a ``torch.autograd.Function`` whose backward is the
    JAX package's hand-derived VJP: a closed-form suffix recurrence and
    ``index_add_`` scatters into the parameter tables.  Because hit k's
    alpha attenuates every later hit and the sky term, d loss/d
    density[front] sees the back voxel.

Parameters are keyed by the wavefront engine's per-voxel id (HitResult.node,
the attr_comb index: mixed-brick voxels at slot*32768 + widx, uniform
bricks at capacity*32768 + cell), so the tables have
capacity*32768 + G^3 rows.  That id is a voxel only in a flat int32
``attr_comb`` (G <= 64, no attr16, 1-D storage): for paged, attr16 and
2-D scenes :func:`param_size`, :func:`init_params` and :func:`khit_chain`
raise ValueError, where the JAX package gives tables that do not match
its ids.  On a CUDA index_add_ adds in no fixed order, so gradients on the
card agree with the CPU's to float32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import shade, wavefront
from .render_diff import (d_unit, loss_and_grads, palette_albedo, sgd,
                          sun_light)


class WaveParams(NamedTuple):
    """Learnable per-voxel appearance parameters, attr-index aligned."""

    albedo: torch.Tensor   # f32 (capacity*32768 + G^3, 3)
    density: torch.Tensor  # f32 (capacity*32768 + G^3,) pre-softplus


def _check_scene(wscene):
    """Raise ValueError unless the scene's node ids are voxels: a flat
    int32 attr_comb (no paged L0, no attr16, 1-D storage)."""
    if wscene.pages or wscene.attr16 or wscene.attr_comb.dim() != 1:
        raise ValueError(
            f"differentiable rendering needs a flat int32 attr_comb: this "
            f"scene has G {wscene.grid_size} (paged above "
            f"{wavefront.PAGE}), attr16 {wscene.attr16}, attr_comb "
            f"{wscene.attr_comb.dim()}-D")


def param_size(wscene) -> int:
    _check_scene(wscene)
    return wscene.capacity * wavefront.BRICK_WORDS + wscene.grid_size ** 3


def init_params(wscene, init_density: float = 10.0) -> WaveParams:
    """Palette-seeded parameters like render_diff.init_params, built on
    the scene's device from its attr table (value = attr_comb & 0xFF),
    which never goes to the host."""
    n = param_size(wscene)
    return WaveParams(
        albedo=palette_albedo(wscene.attr_comb & 0xFF),
        density=torch.full((n,), float(init_density), dtype=torch.float32,
                           device=wscene.device))


class HitChain(NamedTuple):
    """K stacked hit records (geometry only — no gradients)."""

    aidx: torch.Tensor   # i32 (K, B) param index (0 where no hit)
    hitm: torch.Tensor   # f32 (K, B) 1.0 where hit k exists
    ds: torch.Tensor     # f32 (K, B) hit cube edge (normalized units)
    light: torch.Tensor  # f32 (K, B) diffuse sun term at the hit


def _advance_past(origins, dirs, res):
    """Origin for the next traversal stage: just past the exit face of
    the hit cube.  The corner comes from the entry point nudged into the
    cube (not from voxel_pos/normal: zero-normal voxels decode to NaN).
    Operation for operation as the JAX package."""
    e = res.scale_exp2[:, None]
    p_in = origins + (res.t + 0.01 * res.scale_exp2)[:, None] * dirs
    corner = 1.0 + torch.floor((p_in - 1.0) / e) * e
    d = torch.where(torch.abs(dirs) < 1e-4,
                    torch.where(dirs >= 0, 1e-4, -1e-4).to(dirs.dtype), dirs)
    tx = torch.maximum((corner - origins) / d, (corner + e - origins) / d)
    t_exit = torch.min(tx, dim=-1).values
    t_push = t_exit + 0.05 * res.scale_exp2
    return origins + t_push[:, None] * dirs


def khit_chain(wscene, origins, dirs, K, stats=None) -> HitChain:
    """March K hits per (B,3) world-space ray: K traversal stages, each
    active on the rays that hit in the stage before.  ``stats`` (a list)
    collects one intersect_wavefront profile per stage (rays, hits,
    ITER_CAP retirements, K1 launches; reading them synchronizes), with
    the stage's ``origins`` and ``active`` mask."""
    _check_scene(wscene)
    # res.t is measured along the unit direction, so every stage uses it
    dirs = d_unit(dirs)
    act = torch.ones(origins.shape[0], dtype=torch.bool,
                     device=origins.device)
    o = origins
    aidxs, hitms, dss, lights = [], [], [], []
    for _ in range(K):
        prof = None if stats is None else {}
        res = wavefront.intersect_wavefront(wscene, o, dirs, active=act,
                                            profile=prof)
        if stats is not None:
            stats.append(dict(prof, origins=o, active=act))
        hit = act & res.hit
        aidxs.append(torch.where(hit, res.node, torch.zeros_like(res.node)))
        hitms.append(hit.to(torch.float32))
        dss.append(torch.where(hit, res.scale_exp2,
                               torch.zeros_like(res.scale_exp2)))
        lights.append(sun_light(res.normal))
        o = _advance_past(o, dirs, res)
        act = hit
    return HitChain(aidx=torch.stack(aidxs), hitm=torch.stack(hitms),
                    ds=torch.stack(dss), light=torch.stack(lights))


# ------------------------------------------------------------- compositor
def _composite_fwd_math(albedo, density, chain, bg):
    """col = sum_k T_k alpha_k albedo[aidx_k] light_k + T_K bg, with
    alpha_k = hit_k (1 - exp(-softplus(density[aidx_k]) ds_k)) and
    T_k = prod_{j<k} (1 - alpha_j).  Returns (col, per-stage residuals)."""
    K, B = chain.aidx.shape
    T = torch.ones(B, dtype=density.dtype, device=density.device)
    col = torch.zeros((B, 3), dtype=albedo.dtype, device=albedo.device)
    Ts, alphas, albs, exps = [], [], [], []
    for k in range(K):
        idx = chain.aidx[k].long()
        den = F.softplus(density[idx])
        ex = torch.exp(-den * chain.ds[k])
        alpha = chain.hitm[k] * (1.0 - ex)
        alb = albedo[idx]
        col = col + (T * alpha * chain.light[k])[:, None] * alb
        Ts.append(T)
        alphas.append(alpha)
        albs.append(alb)
        exps.append(ex)
        T = T * (1.0 - alpha)
    col = col + T[:, None] * bg
    return col, (Ts, alphas, albs, exps, T)


class _CompositeKHit(torch.autograd.Function):
    """composite_khit with the JAX package's hand-written backward; the
    chain tensors and the sky colour get no gradient."""

    @staticmethod
    def forward(ctx, albedo, density, aidx, hitm, ds, light, bg):
        chain = HitChain(aidx, hitm, ds, light)
        col, (Ts, alphas, albs, exps, Tend) = _composite_fwd_math(
            albedo, density, chain, bg)
        ctx.save_for_backward(torch.stack(Ts), torch.stack(alphas),
                              torch.stack(albs), torch.stack(exps), Tend,
                              density, aidx, hitm, ds, light, bg)
        ctx.albedo_shape = albedo.shape
        return col

    @staticmethod
    def backward(ctx, g):
        (Ts, alphas, albs, exps, Tend, density, aidx, hitm, ds, light,
         bg) = ctx.saved_tensors
        K = aidx.shape[0]
        d_albedo = g.new_zeros(ctx.albedo_shape)
        d_density = torch.zeros_like(density)
        # suffix S_k = sum_{j>k} T_j alpha_j light_j (g . alb_j)
        #              + T_end (g . bg);
        # d col/d alpha_k = T_k light_k (g . alb_k) - S_k / (1 - alpha_k)
        gb = torch.sum(g * bg, dim=-1)
        S = Tend * gb
        for k in range(K - 1, -1, -1):
            idx = aidx[k].long()
            ga = torch.sum(g * albs[k], dim=-1)
            direct = Ts[k] * light[k] * ga
            d_alpha = direct - S / torch.clamp_min(1.0 - alphas[k], 1e-20)
            # alpha = hit * (1 - exp(-softplus(den_raw) * ds))
            d_den = (d_alpha * hitm[k] * exps[k] * ds[k]
                     * torch.sigmoid(density[idx]))
            w_alb = (Ts[k] * alphas[k] * light[k])[:, None] * g
            d_albedo.index_add_(0, idx, w_alb * hitm[k][:, None])
            d_density.index_add_(0, idx, d_den * hitm[k])
            S = S + direct * alphas[k]
        return d_albedo, d_density, None, None, None, None, None


def composite_khit(albedo, density, chain: HitChain, bg):
    """Front-to-back transmittance compositing over a K-hit chain (see
    :func:`_composite_fwd_math`), differentiated by the hand-written
    suffix recurrence."""
    return _CompositeKHit.apply(albedo, density, chain.aidx, chain.hitm,
                                chain.ds, chain.light, bg)


def composite_khit_ref(albedo, density, chain, bg):
    """The same forward, differentiated by plain autograd: the reference
    the hand-written backward is checked against."""
    return _composite_fwd_math(albedo, density, chain, bg)[0]


# ------------------------------------------------------------- training
def render_wave_diff(params: WaveParams, wscene, origins, dirs, K):
    """(B, 3) colours of K-hit compositing along (B,3) world-space rays."""
    chain = khit_chain(wscene, origins, dirs, K)
    bg = shade.sky(d_unit(dirs))
    return composite_khit(params.albedo, params.density, chain, bg)


def make_wave_train_step(wscene, width, height, K=3, lr=0.5):
    """SGD step on (albedo, density) through the wavefront K-hit chain:
    ``step(params, cam5, target) -> (params, loss)``.  The step returns
    new tables and leaves the given ones as they were: with the gradients
    it holds three copies of the tables at its peak (2.7 GB each on the
    1024^3 bench world)."""
    _check_scene(wscene)

    def image(params, cam5):
        dirs = d_unit(shade.pixel_dirs_device(cam5, width, height))
        origins = cam5[0].expand_as(dirs)
        chain = khit_chain(wscene, origins, dirs, K)
        col = composite_khit(params.albedo, params.density, chain,
                             shade.sky(dirs))
        return col.reshape(height, width, 3)

    def step(params, cam5, target):
        cam5 = cam5.to(torch.float32)
        loss, grads = loss_and_grads(
            lambda p: torch.mean((image(p, cam5) - target) ** 2), params)
        return sgd(params, grads, lr), loss

    return step
