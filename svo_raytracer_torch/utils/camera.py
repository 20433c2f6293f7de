"""Camera — position plus (pitch, yaw), giving the renderer's cam5 uniform
(port of svo_raytracer_tpu/utils/camera.py).

The frustum is four corner direction vectors (l1, l2, r1, r2; x spread
±1.6, y spread ±0.9, ``Camera.java:13-18``), a pure function of
(pitch, yaw): corners = Ry(yaw) @ Rx(pitch) @ base.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as C
from . import mathutil


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


@dataclasses.dataclass
class Camera:
    """Position + (pitch, yaw) Euler camera over the world cube [1,2]^3."""

    pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.5, 1.5, 2.0], np.float64))
    pitch: float = 0.0
    yaw: float = 0.0
    speed: float = 0.005  # Camera.java:28

    _BASE = np.array([
        [-C.CAMERA_SCALE_Y, -C.CAMERA_SCALE_X, -1.0],  # l1
        [-C.CAMERA_SCALE_Y, +C.CAMERA_SCALE_X, -1.0],  # l2
        [+C.CAMERA_SCALE_Y, -C.CAMERA_SCALE_X, -1.0],  # r1
        [+C.CAMERA_SCALE_Y, +C.CAMERA_SCALE_X, -1.0],  # r2
    ], np.float64)

    def rotate(self, dpitch: float, dyaw: float) -> None:
        """Clamp pitch to ±~90° like Camera.rotate (Camera.java:78-86)."""
        self.pitch = float(np.clip(self.pitch + dpitch,
                                   C.CAMERA_LOWER_LIMIT, C.CAMERA_UPPER_LIMIT))
        self.yaw = float((self.yaw + dyaw) % (2 * np.pi))

    @property
    def rotation(self) -> np.ndarray:
        return _ry(self.yaw) @ _rx(self.pitch)

    @property
    def forward(self) -> np.ndarray:
        """-z view direction (the corner average direction)."""
        return self.rotation @ np.array([0.0, 0.0, -1.0])

    @property
    def right(self) -> np.ndarray:
        return self.rotation @ np.array([1.0, 0.0, 0.0])

    def strafe(self, forward: float, side: float) -> None:
        """Move in the view plane (Camera.strafe, Camera.java:46-50)."""
        self.pos = (self.pos + self.forward * (self.speed * forward)
                    + self.right * (self.speed * side))

    def move_vertical(self, up: float) -> None:
        self.pos = self.pos + np.array([0.0, 1.0, 0.0]) * (self.speed * up)

    def corners(self) -> np.ndarray:
        """(4,3) [l1, l2, r1, r2] corner direction vectors."""
        return (self.rotation @ self._BASE.T).T

    def uniform(self) -> np.ndarray:
        """(5,3): position then 4 corners (cam[5] uniform, svotrace.comp:5-9)."""
        return np.concatenate([np.asarray(self.pos, np.float64)[None, :],
                               self.corners()], axis=0)

    def ray_pick_location(self, depth: float, world_size: int = C.WORLD_SIZE):
        """Un-project the crosshair depth to voxel coords
        (Camera.getRayPickLocation, Camera.java:31-34)."""
        return mathutil.to_voxel_space(self.pos + self.forward * depth,
                                       world_size)


def pixel_directions(corners: np.ndarray, width: int, height: int):
    """Per-pixel *unnormalized* ray directions, (H, W, 3) float32, in
    NumPy: dir = mix(mix(l1, l2, p.y), mix(r1, r2, p.y), p.x) with
    p = (px + 0.5) / size (svotrace.comp:662-664).  Row 0 is p.y ~ 0 (the
    bottom scanline in GL image coordinates)."""
    l1, l2, r1, r2 = (np.asarray(corners[i], np.float32) for i in range(4))
    px = (np.arange(width, dtype=np.float32) + 0.5) / width
    py = (np.arange(height, dtype=np.float32) + 0.5) / height
    left = l1[None, :] + (l2 - l1)[None, :] * py[:, None]
    right = r1[None, :] + (r2 - r1)[None, :] * py[:, None]
    dirs = left[:, None, :] + (right - left)[:, None, :] * px[None, :, None]
    return dirs.astype(np.float32)
