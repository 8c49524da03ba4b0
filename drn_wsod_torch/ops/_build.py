"""Builds the package's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/drn_wsod_torch/lib<name>.so`` at the root of the checkout, at first
use. The sources have a plain C interface (no PyTorch headers), so a build
takes seconds; the stale sources build in parallel, one ``nvcc`` each. A
library is stale when it is older than its source or than any shared header
(``csrc/*.cuh``). A missing ``nvcc`` or a failed build raises.

The host code among the sources (``csrc/<name>.cpp``, the JPEG decoder)
builds alike with the host's C++ compiler (:func:`build_host`): it needs
no ``nvcc``, so it builds on a machine without CUDA too.

The wrappers issue their launches alike, through helpers that keep the
host's per-call work small: :func:`bind` sets a C entry point's prototype
once, and :func:`stream_of` (:data:`raw_stream` for a device index) reads
the raw handle of PyTorch's current stream without building a
``torch.cuda.Stream`` object.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drn_wsod_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


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


def _host_compiler() -> str:
    """The host's C++ compiler: ``c++`` or ``g++`` on ``PATH``."""
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the port's "
                       "host code (ops/csrc/*.cpp) cannot be built")


def build_host(name: str) -> dict:
    """Compile ``csrc/<name>.cpp`` with the host's C++ compiler into
    ``lib<name>.so`` where the library is older than its source. Returns
    {"compiler", "seconds", "built"}; a failed build raises."""
    src = CSRC / f"{name}.cpp"
    lib = library_path(name)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return {"compiler": None, "seconds": 0.0, "built": False}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = _host_compiler()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *HOST_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of {src.name} failed ({compiler} "
                           f"exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return {"compiler": compiler, "seconds": seconds, "built": True}


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cpp``, building it first. Loaded
    as a ``CDLL``: its calls drop the GIL, so threads decode in
    parallel."""
    build_host(name)
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def bind_host(library: str, symbol: str, *argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<library>.cpp`` with its
    prototype set once, as :func:`bind` does for the CUDA sources."""
    fn = getattr(load_host(library), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.PyDLL:
    """The built library ``csrc/<name>.cu``, building the sources first.
    Loaded as a ``PyDLL``: its calls keep the GIL, since a launch returns
    in microseconds and dropping and retaking the GIL costs about as
    much."""
    build_all()
    return ctypes.PyDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def bind(library: str, symbol: str, *argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<library>.cu`` with its
    prototype set once (``argtypes``; the result a C int, the CUDA error
    code): ctypes then converts plain Python ints at each call."""
    fn = getattr(load(library), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


# PyTorch's current stream on a CUDA device (an index), as the raw
# cudaStream_t: no torch.cuda.Stream object is built. A CUDA build of
# PyTorch has it; a CPU build, whose tensors never reach a kernel, does not.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` (an int) of PyTorch's current stream on the
    CUDA device of ``t``."""
    return raw_stream(t.get_device())
