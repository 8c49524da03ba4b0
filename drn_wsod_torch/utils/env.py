"""Environment helpers (counterpart of ``drn_wsod_tpu/utils/env.py``):
seeding every generator a run draws from, and a report of the software
and the cards."""

from __future__ import annotations

import os
import random
import subprocess
import sys
from typing import Optional

import numpy as np
import torch


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed numpy, Python's ``random`` and torch (every device's default
    generator) with ``seed``, a random one where it is None; returns the
    seed. ``PYTHONHASHSEED`` is set for child processes, as the JAX
    package sets it."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def _nvcc_version() -> str:
    """The release line of the ``nvcc`` the kernels build with
    (``ops/_build.py``: on PATH, else in ``$CUDA_HOME/bin``)."""
    from ..ops._build import _nvcc

    try:
        nvcc = _nvcc()
    except RuntimeError:
        return "not found"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip()


def collect_env_info() -> str:
    """One line each: Python, torch, numpy, the CUDA torch was built with,
    the cards (name and capability) and ``nvcc``."""
    lines = [
        f"python: {sys.version.split()[0]}",
        f"torch: {torch.__version__}",
        f"numpy: {np.__version__}",
        f"torch CUDA: {torch.version.cuda}",
    ]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            cap = torch.cuda.get_device_capability(i)
            lines.append(f"cuda:{i}: {torch.cuda.get_device_name(i)} "
                         f"(sm_{cap[0]}{cap[1]})")
    else:
        lines.append("cards: none (CUDA unavailable)")
    lines.append(f"nvcc: {_nvcc_version()}")
    return "\n".join(lines)
