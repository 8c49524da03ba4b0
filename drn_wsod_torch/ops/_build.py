"""Builds the package's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/drn_wsod_torch/lib<name>.so`` at the root of the checkout, at first
use. The sources have a plain C interface (no PyTorch headers), so a build
takes seconds; the stale sources build in parallel, one ``nvcc`` each. A
library is stale when it is older than its source or than any shared header
(``csrc/*.cuh``). A missing ``nvcc`` or a failed build raises.
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


def _stale(src: Path, newest_header: float) -> bool:
    lib = library_path(src.stem)
    return (not lib.exists() or lib.stat().st_mtime
            < max(src.stat().st_mtime, newest_header))


def build_all() -> dict:
    """Compile every source whose library is stale, all at once.
    Returns {name: nvcc output} for the sources built by this call (the
    ``-Xptxas -v`` report of registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    newest_header = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                        default=0.0)
    stale = [src for src in sorted(CSRC.glob("*.cu"))
             if _stale(src, newest_header)]
    nvcc = _nvcc() if stale else None
    jobs = {}
    for src in stale:
        tmp = library_path(src.stem).with_name(
            f"lib{src.stem}.so.{os.getpid()}.tmp")
        jobs[src] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for src, (tmp, proc) in jobs.items():
        logs[src.stem] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"CUDA build of {src.name} failed (nvcc exit "
                          f"{proc.returncode}):\n{logs[src.stem]}")
        else:
            os.replace(tmp, library_path(src.stem))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu``, building the sources first."""
    build_all()
    return ctypes.CDLL(str(library_path(name)))
