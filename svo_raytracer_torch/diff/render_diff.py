"""Differentiable rendering on the ESVO traversal: pixel gradients with
respect to per-node albedo and density (port of
svo_raytracer_tpu/diff/render_diff.py).

The traversal is geometric and carries no gradients: it returns hit
records (node index, t, normal), through kernel KE on the GPU.  The
shading is a differentiable function of per-node parameters gathered at
the hit node, so autograd turns the forward gather into a backward
scatter-add into the node tables.

Model (single-hit alpha compositing):

  alpha = 1 - exp(-softplus(density[node]) * ds)   (ds = hit cube edge)
  pixel = alpha * albedo[node] * light(normal)  +  (1 - alpha) * sky(dir)

The port takes a :class:`~svo_raytracer_torch.core.octree.DeviceOctree`
where the JAX package takes the tree's arrays tuple; every tensor made
here lies on the tree's device.  Parameters have one row per node of the
tree (the JAX package's have one per slot of its padded capacity; node
ids, and so the rows a render reads, are the same).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import shade, traverse
from ..utils import constants as C


class VoxelParams(NamedTuple):
    """Learnable per-node appearance parameters (node-table aligned)."""

    albedo: torch.Tensor   # f32 (n_nodes, 3)
    density: torch.Tensor  # f32 (n_nodes,) — softplus-activated opacity rate


def palette_albedo(value):
    """(n, 3) float32 albedo of voxel values: the palette's colour
    (svotrace.comp:577-586), 0.5 grey elsewhere."""
    albedo = torch.full((value.shape[0], 3), 0.5, dtype=torch.float32,
                        device=value.device)
    for v, rgb in shade._PALETTE.items():
        albedo[value == v] = torch.tensor(rgb, dtype=torch.float32,
                                          device=value.device)
    return albedo


def init_params(tree, init_density: float = 10.0) -> VoxelParams:
    """Palette-seeded parameters, so an untrained render matches mode 2's
    albedo."""
    return VoxelParams(
        albedo=palette_albedo(tree.value),
        density=torch.full((tree.n_nodes,), float(init_density),
                           dtype=torch.float32, device=tree.device))


def d_unit(d):
    """(B,3) rows over their length, rounded as the JAX package's
    ``d / jnp.linalg.norm(d)``: that norm is jitted, and XLA contracts
    its sum of squares into fma(z, z, fma(y, y, x * x)).  Each fma is
    taken in float64 (exact products) and rounded to float32, and the
    square root in float64 rounded back (correct rounding, which torch's
    float32 sqrt on the CPU does not always give)."""
    x, y, z = d.double().unbind(1)
    s = (x * x).float().double()
    s = (y * y + s).float().double()
    s = (z * z + s).float().double()
    return d / torch.sqrt(s).float()[:, None]


def sun_light(normal):
    """Diffuse sun term plus a floor, clip(n . sun, 0, 1) * 0.7 + 0.3; NaN
    normals count as 0."""
    n = torch.nan_to_num(normal)
    s = shade.SUN_DIR_DIRECT
    dot = n[:, 0] * s[0] + n[:, 1] * s[1] + n[:, 2] * s[2]
    return torch.clamp(dot, 0.0, 1.0) * 0.7 + 0.3


def shade_hits(params: VoxelParams, res, dirs):
    """(B, 3) colours of the single-hit model at the hit records ``res``
    of the unit rays ``dirs``: the gather of the hit nodes' parameters
    (differentiable), the sun light and the sky."""
    node = torch.where(res.hit, res.node, torch.zeros_like(res.node)).long()
    # index_select's backward is index_add_; indexing's (index_put_ with
    # accumulate) took 24.5 of a 30.2 ms step on an H100 at 1080p, the
    # miss pixels all gathering node 0
    alb = params.albedo.index_select(0, node)
    den = F.softplus(params.density.index_select(0, node))
    alpha = 1.0 - torch.exp(-den * res.scale_exp2)
    surf = alb * sun_light(res.normal)[:, None]
    bg = shade.sky(dirs)
    return torch.where(res.hit[:, None],
                       alpha[:, None] * surf + (1.0 - alpha[:, None]) * bg,
                       bg)


def render_diff(params: VoxelParams, tree, cam5, width: int, height: int,
                max_depth: int = C.MAX_DEPTH,
                max_iterations: int = C.MAX_RAYCAST_ITERATIONS,
                packed=None):
    """Differentiable forward render -> (H, W, 3).

    Only ``params`` carries gradients; the octree geometry is constant.
    One traversal segment (kernel KE on the GPU) in the image's 8x4 pixel
    tiles; ``packed`` is the cached traverse.make_packed_table.  Light is
    diffuse-from-sun like render mode 2 plus a floor."""
    cam5 = cam5.to(torch.float32)
    dirs = d_unit(shade.pixel_dirs_device(cam5, width, height))
    origins = cam5[0].expand_as(dirs)
    res = traverse.intersect_octree(
        tree, origins, dirs, max_depth=max_depth,
        max_iterations=max_iterations, packed=packed,
        order=traverse.tile_order(width, height, cam5.device))
    col = shade_hits(params, res, dirs)
    return col.reshape(height, width, 3)


def pixel_loss(params: VoxelParams, tree, cam5, target, width: int,
               height: int, packed=None):
    """L2 image loss against a target render."""
    img = render_diff(params, tree, cam5, width, height, packed=packed)
    return torch.mean((img - target) ** 2)


def loss_and_grads(loss_fn, params):
    """(loss, gradients) of ``loss_fn(params)`` with respect to both
    tables, the tables themselves left without autograd history."""
    leaves = type(params)(*(p.detach().requires_grad_(True)
                            for p in params))
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, tuple(leaves))
    return loss.detach(), type(params)(*grads)


def sgd(params, grads, lr):
    """params - lr * grads, table by table, in one pass over each (new
    tables; the given ones are left as they were)."""
    return type(params)(*(torch.add(p, g, alpha=-lr)
                          for p, g in zip(params, grads)))


def train_step(params: VoxelParams, tree, cam5, target, width: int,
               height: int, lr: float = 0.5, packed=None):
    """One SGD step on (albedo, density) -> (new params, loss)."""
    loss, grads = loss_and_grads(
        lambda p: pixel_loss(p, tree, cam5, target, width, height,
                             packed=packed), params)
    return sgd(params, grads, lr), loss


def finite_difference_grad(params: VoxelParams, tree, cam5, target,
                           width: int, height: int, node: int, channel: int,
                           eps: float = 1e-3) -> float:
    """Central finite difference of the loss with respect to one albedo
    entry: the gradient check's independent side.  The shading and the
    loss run in float64 (the traversal is float32 as always): in float32
    the loss's last bit is ~4e-6 of a 1e-3 difference quotient, 10% of a
    typical entry's gradient."""
    p64 = VoxelParams(params.albedo.double(), params.density.double())

    def loss_with(delta):
        a = p64.albedo.clone()
        a[node, channel] += delta
        return float(pixel_loss(VoxelParams(a, p64.density), tree, cam5,
                                target, width, height))

    return (loss_with(eps) - loss_with(-eps)) / (2 * eps)
