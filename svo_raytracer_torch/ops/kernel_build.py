"""Build the hand-written kernels in ``csrc/`` into shared libraries.

Kernels are compiled at first use (never at import) with a plain C
interface and loaded with ctypes: nvcc for the CUDA sources, and the host
C++ compiler for the CPU build of the per-ray body that the tests use.
Libraries land in ``svo_raytracer_torch/_build/`` (git-ignored), named by
a hash of every source under ``csrc/``, the compiler and its flags, so a
changed source or flag never loads a stale library.  Each build writes a
temporary file and renames it into place, so concurrent builders are safe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# sm_90a keeps wgmma/setmaxnreg available to later kernels.  No
# --use_fast_math: 1.0f/x and the comparisons must stay IEEE.  -fmad=false
# keeps a*b+c as two roundings, as the plain PyTorch version computes it
# (the choice and its measured effect are in PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(compiler: str, sources, flags) -> str:
    h = hashlib.sha256()
    h.update(compiler.encode())
    h.update("\0".join(flags).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".cpp", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    for src in sources:
        h.update(str(src).encode())
    return h.hexdigest()[:16]


def load(name: str, sources, compiler: str, flags) -> ctypes.CDLL:
    """Compile ``sources`` (paths under csrc/) into BUILD_DIR/<name>-<hash>.so
    unless that library already exists, and dlopen it."""
    srcs = [CSRC / s for s in sources]
    out = BUILD_DIR / f"{name}-{_digest(compiler, sources, flags)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [compiler, *flags, "-I", str(CSRC), "-o", tmp,
                   *map(str, srcs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(str(out))
