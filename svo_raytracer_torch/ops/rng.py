"""The reference's per-pixel random (port of svo_raytracer_tpu/ops/rng.py
``glsl_rand`` / ``pixel_rand``).

fract(sin(x) * 43758.5453) turns one ulp of ``sin`` into ~3e-3 of the
result, and PyTorch's and XLA's ``sin`` differ by an ulp on some inputs,
so the two packages agree on this function only to a tolerance
(tests/test_torch_shade.py); frame tests feed both the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def glsl_rand(x, y):
    """fract(sin(dot(co, (12.9898, 78.233))) * 43758.5453) in float32."""
    s = torch.sin(x.float() * 12.9898 + y.float() * 78.233)
    v = s * 43758.5453
    return v - torch.floor(v)


def pixel_rand(px, py, frame):
    """The composed per-pixel random of render mode 0 (svotrace.comp:486):
    rand(seed0 + rand(seed0, frame*0.1), seed1 + rand(seed1, frame*0.02))."""
    fr = np.float32(frame)
    r1 = glsl_rand(px, torch.full_like(px, float(fr * np.float32(0.1))))
    r2 = glsl_rand(py, torch.full_like(py, float(fr * np.float32(0.02))))
    return glsl_rand(px + r1, py + r2)
