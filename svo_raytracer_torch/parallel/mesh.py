"""Process meshes with named axes, and the collectives the sharded paths
use (port of svo_raytracer_tpu/parallel/mesh.py).

The JAX package's ``Mesh`` names device axes, and ``shard_map`` runs one
function per device with collectives over an axis.  Here each rank of a
``torch.distributed`` group is one "device": :class:`Mesh` wraps a
``DeviceMesh`` (``init_device_mesh``) and gives each named axis its
process group, this rank's index along it and its size, and the three
collectives the sharded code uses:

  ``tiles``  — image rows: every rank traces its rows against a
               replicated scene; parameter gradients are summed over it.
  ``bricks`` — the octree's bricks (parallel/bricks.py): nearest hits
               are combined over it.

:meth:`Mesh.psum` (all_reduce SUM), :meth:`Mesh.pmin` (all_reduce MIN)
and :meth:`Mesh.all_gather` (rank-ordered stacking, in place of
``out_specs=P("tiles")``).  Where a JAX function returns a global array,
the port returns the whole array on every rank.

An nccl group takes CUDA tensors, one card per rank.  A gloo group takes
CPU tensors, and in the card's torch (2.11) it also takes CUDA tensors
for all_reduce (SUM and MIN, float32 and int32) and all_gather, which it
copies through host memory itself: so ranks sharing one card run over
gloo with no staging here (scripts/gloo_cuda_collectives.py, NVIDIA H100
80GB HBM3, 700 W).  No collective falls back to another backend or path
when it fails.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


class Mesh:
    """Named axes over the ranks of the default group.  ``device`` is
    this rank's device (the tensors it hands to collectives live there);
    ``shape`` maps each axis name to its size."""

    def __init__(self, shape, axis_names, device_type: str = "cuda"):
        shape = tuple(int(s) for s in shape)
        n = 1
        for s in shape:
            n *= s
        if n != dist.get_world_size():
            raise ValueError(f"a mesh of {shape} ranks over a group of "
                             f"{dist.get_world_size()}")
        if device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif device_type == "cpu":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"device_type {device_type!r}")
        self.device_mesh = init_device_mesh(device_type, shape,
                                            mesh_dim_names=tuple(axis_names))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def _all_reduce(self, x, axis, op, inplace):
        out = x if inplace else x.clone()
        if self.size(axis) > 1:
            dist.all_reduce(out, op=op, group=self.group(axis))
        return out

    def psum(self, x, axis: str, inplace: bool = False):
        """The elementwise sum of ``x`` over ``axis`` (``jax.lax.psum``);
        ``inplace`` writes it into ``x``."""
        return self._all_reduce(x, axis, dist.ReduceOp.SUM, inplace)

    def pmin(self, x, axis: str):
        """The elementwise minimum of ``x`` over ``axis``
        (``jax.lax.pmin``)."""
        return self._all_reduce(x, axis, dist.ReduceOp.MIN, False)

    def all_gather(self, x, axis: str):
        """(size(axis), *x.shape): every rank's ``x`` along ``axis``, in
        the axis's rank order (the blocks ``out_specs=P(axis)`` lays
        out)."""
        n = self.size(axis)
        x = x.contiguous()
        if n == 1:
            return x[None]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.group(axis))
        return torch.stack(parts)


def tile_mesh(n: int | None = None, device_type: str = "cuda") -> Mesh:
    """1-D ``tiles`` mesh over the group's ranks (``n``, when given, must
    be the group's size)."""
    n = dist.get_world_size() if n is None else n
    return Mesh((n,), ("tiles",), device_type)


def grid_mesh(n_tiles: int, n_bricks: int,
              device_type: str = "cuda") -> Mesh:
    """2-D ``(tiles, bricks)`` mesh: image rows shard over ``tiles``, the
    octree's bricks over ``bricks`` (parallel/bricks.py).  Rank r sits at
    (r // n_bricks, r % n_bricks), as the JAX package's device grid."""
    return Mesh((n_tiles, n_bricks), ("tiles", "bricks"), device_type)
