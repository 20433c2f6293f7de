"""ctypes bindings of the native ``.svo`` codec (port of
svo_raytracer_tpu/runtime/native.py).

``csrc/svo_codec.cc`` is compiled with the host C++ compiler into
``svo_raytracer_torch/_build/`` at first use (ops/kernel_build.library)
and loaded with ctypes.  There is no fallback: when the library cannot
be built, the first call raises.  The Python codec in core/svo_format.py
is its plain version, and the tests hold the two equal byte for byte.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.octree import Octree
from ..ops import kernel_build
from ..utils import constants as C

CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = kernel_build.load("svo_codec", ["svo_codec.cc"],
                                kernel_build.host_compiler(), CXX_FLAGS)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.svo_import.restype = ctypes.c_int64
        lib.svo_import.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   i32p, i32p, i32p, i32p, ctypes.c_int64]
        lib.svo_export.restype = ctypes.c_int64
        lib.svo_export.argtypes = [i32p, i32p, i32p, i32p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the native codec builds and loads (the port has no
    fallback: without it, import_svo and export_svo raise)."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def import_svo(data: bytes, world_size: int = C.WORLD_SIZE) -> Octree:
    """core.svo_format.import_svo in C++; malformed or truncated input
    raises ValueError."""
    lib = _load()
    capacity = max(16, len(data) + 8)
    arrays = [np.zeros(capacity, np.int32) for _ in range(4)]
    n = lib.svo_import(data, len(data), *map(_i32ptr, arrays), capacity)
    if n < 0:
        raise ValueError(f"svo_import failed with code {n}")
    return Octree(*(a[:n].copy() for a in arrays), n_nodes=int(n),
                  world_size=world_size)


def export_svo(tree) -> bytes:
    """core.svo_format.export_svo in C++ (BFS order, the same bytes)."""
    lib = _load()
    t = tree.to_numpy()
    arrays = [np.ascontiguousarray(np.asarray(a)[:t.n_nodes], np.int32)
              for a in t.arrays()]
    ptrs = list(map(_i32ptr, arrays))
    size = lib.svo_export(*ptrs, t.n_nodes, None, 0)
    if size < 0:
        raise ValueError(f"svo_export sizing failed with code {size}")
    out = np.zeros(size, np.uint8)
    rc = lib.svo_export(*ptrs, t.n_nodes,
                        out.ctypes.data_as(ctypes.c_void_p), size)
    if rc < 0:
        raise ValueError(f"svo_export failed with code {rc}")
    return out.tobytes()
