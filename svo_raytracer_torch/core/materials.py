"""Material registry (Material.java parity).

Port of svo_raytracer_tpu/core/materials.py.

Shading colors stay keyed by voxel value in the shading code
(svotrace.comp:514-522) just like the reference; this registry carries the
asset-pipeline metadata (mask-texture paths for the matmap bake).
"""

from __future__ import annotations

import dataclasses

from ..utils import constants as C


@dataclasses.dataclass
class Material:
    value: int
    name: str
    type: int
    matmap_file_path: str | None = None

    def has_matmap(self) -> bool:
        return self.matmap_file_path is not None


_materials: list[Material | None] = [None] * C.MAX_MATERIALS
_num_mats = 0


def init_materials(asset_dir: str = "./assets") -> None:
    """The reference's hardcoded registry (Material.java:39-46)."""
    global _num_mats
    _materials[:] = [None] * C.MAX_MATERIALS
    _num_mats = 0

    def add(name, type_, path=None):
        global _num_mats
        _materials[_num_mats] = Material(_num_mats, name, type_, path)
        _num_mats += 1

    add("air", 1)
    add("stone", 1, f"{asset_dir}/matmaps/nz/stone.png")
    add("scree", 1, f"{asset_dir}/matmaps/nz/scree.png")
    add("grass", 1, f"{asset_dir}/matmaps/nz/grass.png")


def get_material(mat_id: int) -> Material | None:
    return _materials[mat_id]


def get_num_mats() -> int:
    return _num_mats
