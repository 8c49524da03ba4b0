"""Out-of-memory retry (counterpart of ``drn_wsod_tpu/utils/memory.py``,
Detectron2's ``retry_if_cuda_oom``)."""

from __future__ import annotations

import functools
import logging

import torch

logger = logging.getLogger(__name__)


def retry_if_oom(fn, fallback=None):
    """``fn`` wrapped: where it raises ``torch.OutOfMemoryError``, the CUDA
    caching allocator's free blocks are released and ``fallback`` runs on
    the same arguments; without a fallback the error is raised again. Any
    other error passes through."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except torch.OutOfMemoryError:
            logger.warning(f"Out of memory in {fn.__name__}; "
                           f"{'running the fallback' if fallback else 'no fallback'}")
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            if fallback is None:
                raise
            return fallback(*args, **kwargs)

    return wrapped
