"""Camera — position plus (pitch, yaw), giving the renderer's cam5 uniform
(port of svo_raytracer_tpu/utils/camera.py, the parts the renderer reads).

The frustum is four corner direction vectors (l1, l2, r1, r2; x spread
±1.6, y spread ±0.9, ``Camera.java:13-18``), a pure function of
(pitch, yaw): corners = Ry(yaw) @ Rx(pitch) @ base.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as C


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

    def corners(self) -> np.ndarray:
        """(4,3) [l1, l2, r1, r2] corner direction vectors."""
        return ((_ry(self.yaw) @ _rx(self.pitch)) @ self._BASE.T).T

    def uniform(self) -> np.ndarray:
        """(5,3): position then 4 corners (cam[5] uniform, svotrace.comp:5-9)."""
        return np.concatenate([np.asarray(self.pos, np.float64)[None, :],
                               self.corners()], axis=0)
