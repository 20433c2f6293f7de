"""Small host math helpers (port of svo_raytracer_tpu/utils/mathutil.py;
the reference's ``Util.java``): the AABB test, the world -> voxel
transform and the decimal-digit normal packing, in NumPy."""

from __future__ import annotations

import numpy as np

from . import constants as C


def intersect_aabb(min0, max0, min1, max1) -> bool:
    """Inclusive AABB overlap test (Util.java:5-9)."""
    return bool(
        min0[0] <= max1[0] and max0[0] >= min1[0]
        and min0[1] <= max1[1] and max0[1] >= min1[1]
        and min0[2] <= max1[2] and max0[2] >= min1[2]
    )


def to_voxel_space(world_pos, world_size: int = C.WORLD_SIZE):
    """World [1,2] cube -> integer voxel coords, ``(w - 1) * world_size``
    truncated toward zero (Util.java:11-18)."""
    w = np.asarray(world_pos, dtype=np.float64)
    return ((w - 1.0) * world_size).astype(np.int64)


def pack_normal(normal) -> int:
    """Pack a unit vector into decimal digits (Util.java:140-146): each
    axis maps to trunc(trunc(v*9) / 2) + 5 in [1, 9], packed as
    ``x + 10*y + 100*z``.  Java's integer division truncates toward zero,
    hence trunc, not floor."""
    n = np.asarray(normal, dtype=np.float64)
    digits = (np.trunc(np.trunc(n * 9) / 2) + 5).astype(np.int64)
    return int(digits[0] + digits[1] * 10 + digits[2] * 100)


def unpack_normal(raw: int) -> np.ndarray:
    """The unnormalized integer offset vector (each component in [-5, 4])
    of a digit-packed normal, decoded as the shader does
    (svotrace.comp:383-388); raw 0 decodes to the zero vector."""
    raw = int(raw)
    x = (raw % 10) - 5
    y = ((raw % 100) - (raw % 10)) // 10 - 5
    z = (raw - (raw % 100)) // 100 - 5
    return np.array([x, y, z], dtype=np.float64)


def normalize(v):
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def child_offset(i: int) -> np.ndarray:
    """Octant i -> (dx, dy, dz) in {0,1}^3 (Constants.java:18-27)."""
    return np.array(C.CHILD_OFFSETS[i], dtype=np.int64)
