"""Build the hand-written kernels in ``csrc/`` into shared libraries.

Kernels are compiled at first use (never at import) with a plain C
interface and loaded with ctypes: nvcc for the CUDA sources, and the host
C++ compiler for the CPU build of the per-ray body that the tests use.
Libraries land in ``svo_raytracer_torch/_build/`` (git-ignored), named by
a hash of every source under ``csrc/``, the compiler and its flags, so a
changed source or flag never loads a stale library.  Each build writes a
temporary file and renames it into place, so concurrent builders are safe;
the compiler's output (for nvcc, ptxas's registers and spills per kernel)
is kept beside the library as ``<name>-<hash>.log``.
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
# (the choice and its measured effect are in PERF.md).  -Xptxas -v only
# reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


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


def library(name: str, sources, compiler: str, flags) -> Path:
    """Compile ``sources`` (paths under csrc/) into BUILD_DIR/<name>-<hash>.so
    unless that library already exists; returns its path."""
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
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def load(name: str, sources, compiler: str, flags) -> ctypes.CDLL:
    """Build (if needed) and dlopen the library of ``sources``."""
    return ctypes.CDLL(str(library(name, sources, compiler, flags)))


class Kernel:
    """A ctypes-bound CUDA kernel library, built from ``sources`` at first
    use.  The entry point ``symbol`` returns the launch's cudaError_t.

    ``launches`` counts the launches of the kernel (one per call that
    reaches the card); the wrapper adds one after each launch, and callers
    reset and read it."""

    def __init__(self, name, sources, symbol, argtypes):
        self.name, self.sources, self.symbol = name, sources, symbol
        self.argtypes = argtypes
        self.fn = None
        self.path = None
        self.launches = 0

    def load(self):
        if self.fn is None:
            self.path = library(self.name, self.sources, nvcc_path(),
                                NVCC_FLAGS)
            fn = getattr(ctypes.CDLL(str(self.path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self.fn = fn
        return self.fn

    def build_log(self) -> str:
        """The compiler's output of the library's build (ptxas's registers,
        shared memory and spills)."""
        self.load()
        return self.path.with_suffix(".log").read_text()
