"""The reference camera: position plus (pitch, yaw) over the world cube
[1, 2]^3, its (5, 3) uniform (position, then the l1, l2, r1, r2 corner
directions: x spread 1.6, y spread 0.9, corners = Ry(yaw) Rx(pitch) base,
Camera.java:13-18) and the viewer's commands (Main.java:161-243: w/s
move along the view direction, a/d along its right vector, by the
viewer's speed of 0.02; i/k pitch and j/l yaw by 0.1, pitch clamped to
+-1.570).  Float64 NumPy, in the order the reference computes it.
"""

from __future__ import annotations

import numpy as np

SCALE_X, SCALE_Y = 0.9, 1.6
PITCH_LIMIT = 1.570
SPEED = 0.02
TURN = 0.1

_BASE = np.array([[-SCALE_Y, -SCALE_X, -1.0], [-SCALE_Y, SCALE_X, -1.0],
                  [SCALE_Y, -SCALE_X, -1.0], [SCALE_Y, SCALE_X, -1.0]],
                 np.float64)


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


class Camera:
    def __init__(self, pos, pitch, yaw):
        self.pos = np.asarray(pos, np.float64).copy()
        self.pitch = float(pitch)
        self.yaw = float(yaw)

    def rotation(self):
        return _ry(self.yaw) @ _rx(self.pitch)

    def forward(self):
        return self.rotation() @ np.array([0.0, 0.0, -1.0])

    def right(self):
        return self.rotation() @ np.array([1.0, 0.0, 0.0])

    def rotate(self, dpitch, dyaw):
        self.pitch = float(np.clip(self.pitch + dpitch, -PITCH_LIMIT,
                                   PITCH_LIMIT))
        self.yaw = float((self.yaw + dyaw) % (2 * np.pi))

    def command(self, key):
        """Apply one of the viewer's move or look keys."""
        if key == "w":
            self.pos = self.pos + self.forward() * SPEED
        elif key == "s":
            self.pos = self.pos - self.forward() * SPEED
        elif key == "a":
            self.pos = self.pos - self.right() * SPEED
        elif key == "d":
            self.pos = self.pos + self.right() * SPEED
        elif key == "j":
            self.rotate(0.0, TURN)
        elif key == "l":
            self.rotate(0.0, -TURN)
        elif key == "i":
            self.rotate(TURN, 0.0)
        elif key == "k":
            self.rotate(-TURN, 0.0)
        else:
            raise ValueError(f"not a move or look key: {key!r}")

    def uniform(self):
        corners = (self.rotation() @ _BASE.T).T
        return np.concatenate([self.pos[None, :], corners], axis=0)
