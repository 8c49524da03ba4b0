"""Process-group helpers (counterpart of
``drn_wsod_tpu/parallel/multihost.py``): rank and world size, a barrier,
the pickled all-gather that collects each rank's evaluator state, and
``reduce_dict``; all of them the single-process identity where no process
group is initialised, as the JAX package's are at ``process_count() == 1``.

:func:`init_process_group` is the torch counterpart of
``jax.distributed.initialize``: it reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
initialises the default group, NCCL on CUDA unless the caller names the
backend (gloo runs two ranks on one card, which NCCL refuses).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    """The rank on this host (``LOCAL_RANK``), 0 where it is not set."""
    return int(os.environ.get("LOCAL_RANK", 0))


def is_main_process() -> bool:
    return get_rank() == 0


def init_process_group(backend: Optional[str] = None,
                       timeout_s: float = 1800.0) -> bool:
    """Initialise the default process group from the environment that
    ``torchrun`` sets, where ``WORLD_SIZE`` is above 1 and no group exists
    yet. ``backend`` defaults to NCCL where CUDA is available, else gloo.
    Returns whether it initialised one."""
    if is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank())
    dist.init_process_group(
        backend=backend, init_method="env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def synchronize() -> None:
    """Barrier across the ranks (a no-op for one)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def reduce_dict(metrics: Dict[str, float], average: bool = True
                ) -> Dict[str, float]:
    """The mean (or sum) over the ranks of each scalar of ``metrics``."""
    if get_world_size() == 1:
        return dict(metrics)
    gathered = all_gather_object(metrics)
    out: Dict[str, float] = {}
    for k in metrics:
        vals = [g[k] for g in gathered if k in g]
        out[k] = float(np.mean(vals) if average else np.sum(vals))
    return out
