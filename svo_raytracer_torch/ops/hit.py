"""The traversal result record (HitResult of
svo_raytracer_tpu/ops/traverse.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class HitResult(NamedTuple):
    """Batched castResult (svotrace.comp:186-197); fields are (B,) / (B,3)."""

    hit: torch.Tensor         # bool
    value: torch.Tensor       # i32 material of the hit voxel
    t: torch.Tensor           # f32 hit distance in world units
    iters: torch.Tensor       # i32 traversal iterations spent
    scale_exp2: torch.Tensor  # f32 edge length of the hit cube
    depth: torch.Tensor       # i32 leaf depth below the root
    normal: torch.Tensor      # f32 (B,3) decoded digit-packed normal
    hit_pos: torch.Tensor     # f32 (B,3) origin + t*dir + normal*scale_exp2*2
    voxel_pos: torch.Tensor   # f32 (B,3) cube corner + normal offset
    node: torch.Tensor        # i32 per-voxel id (attr_comb index), -1 on miss
