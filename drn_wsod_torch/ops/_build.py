"""Builds the package's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/drn_wsod_torch/lib<name>.so`` at the root of the checkout, at first
use. The sources have a plain C interface (no PyTorch headers), so a build
takes seconds. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drn_wsod_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_all() -> dict:
    """Compile every source whose library is missing or older than it.
    Returns {name: nvcc output} for the sources built by this call (the
    ``-Xptxas -v`` report of registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale = [src for src in sorted(CSRC.glob("*.cu"))
             if not library_path(src.stem).exists()
             or library_path(src.stem).stat().st_mtime < src.stat().st_mtime]
    nvcc = _nvcc() if stale else None
    logs = {}
    for src in stale:
        lib = library_path(src.stem)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs[src.stem] = proc.stdout
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"CUDA build of {src.name} failed (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, lib)
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu``, building the sources first."""
    build_all()
    return ctypes.CDLL(str(library_path(name)))
