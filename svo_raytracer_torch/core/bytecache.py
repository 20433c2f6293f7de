"""Backwards-growing ring buffer (ByteCache.java parity).

Port of svo_raytracer_tpu/core/bytecache.py.

Vestigial in the reference — intended for shader-side node streaming with the
``requestBuffer`` SSBO (svobeam.comp:18-20, Constants.REQUEST_BUFFER_SIZE_KB)
but never wired into the render path.  Kept for capability parity; quirk
preserved: the ring wraps modulo ``cache_size`` (the MB count), not the
allocated byte length (ByteCache.java:17-20), exactly as the unit test
ByteCacheTest.eval exercises it.
"""

from __future__ import annotations

import numpy as np


class ByteCache:
    def __init__(self, cache_size_mb: int):
        self.cache_size = cache_size_mb
        self.buffer = np.zeros(cache_size_mb * 1_000_000, np.int8)
        self.start = cache_size_mb

    def append_byte(self, data: int) -> None:
        self.start = (self.start - 1) % self.cache_size
        if self.start < 0:
            self.start += self.cache_size
        self.buffer[self.start] = np.int8(data)

    def get_first(self) -> int:
        return int(self.buffer[self.start])

    def get_buffer(self) -> np.ndarray:
        return self.buffer
