"""Checkpoint and resume (port of svo_raytracer_tpu/diff/checkpoint.py).

Two things are checkpointed, as ``.npz`` files whose keys are the JAX
package's, so a file written by either package loads in the other:

* the scene: the octree's node arrays (``child``, ``mask``, ``value``,
  ``normal``, ``n_nodes``, ``world_size``);
* training state: the parameter tables (``albedo``, ``density``) and the
  step count (``step``), for VoxelParams and WaveParams alike.

:func:`params_from_reference` carries parameters the JAX package trained
(NumPy arrays) onto a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.octree import DeviceOctree, Octree
from .render_diff import VoxelParams
from .wave_diff import WaveParams

KINDS = {"voxel": VoxelParams, "wave": WaveParams}


def save_tree_npz(tree, path: str) -> None:
    """Write an Octree (or a DeviceOctree, through the host) to ``path``."""
    if isinstance(tree, DeviceOctree):
        tree = tree.to_numpy()
    n = tree.n_nodes
    np.savez(path, child=tree.child[:n], mask=tree.mask[:n],
             value=tree.value[:n], normal=tree.normal[:n],
             n_nodes=np.asarray(n), world_size=np.asarray(tree.world_size))


def load_tree_npz(path: str) -> Octree:
    with np.load(path) as z:
        return Octree(child=z["child"], mask=z["mask"], value=z["value"],
                      normal=z["normal"], n_nodes=int(z["n_nodes"]),
                      world_size=int(z["world_size"]))


def save_params(params, path: str, step: int = 0) -> None:
    """Write VoxelParams or WaveParams and the step count to ``path``."""
    np.savez(path, albedo=params.albedo.detach().cpu().numpy(),
             density=params.density.detach().cpu().numpy(),
             step=np.asarray(step))


def params_from_reference(albedo, density, device, kind="voxel"):
    """Parameters as NumPy arrays (the JAX package's, through np.asarray)
    as ``kind`` ("voxel": VoxelParams, "wave": WaveParams) on ``device``."""
    albedo = np.asarray(albedo)
    density = np.asarray(density)
    if (albedo.dtype != np.float32 or density.dtype != np.float32
            or albedo.shape != density.shape + (3,) or density.ndim != 1):
        raise ValueError(f"parameters must be float32 albedo (n, 3) and "
                         f"density (n,), got {albedo.dtype}{albedo.shape} "
                         f"and {density.dtype}{density.shape}")
    return KINDS[kind](albedo=torch.from_numpy(albedo.copy()).to(device),
                       density=torch.from_numpy(density.copy()).to(device))


def load_params(path: str, device, kind="voxel"):
    """(params, step) from ``path``, the tables on ``device``."""
    with np.load(path) as z:
        return (params_from_reference(z["albedo"], z["density"], device,
                                      kind), int(z["step"]))
