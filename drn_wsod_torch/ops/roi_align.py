"""The differentiable exact RoIPool (counterpart of
``drn_wsod_tpu/ops/roi_align.py:roi_pool``).

The model pools through this function where the pool must carry gradients
to the map: CSC heads take image gradients through it for their
class-peak-gradient maps, and a trainable backbone (``FREEZE_AT < 5``)
takes feature gradients. The forward-only kernel K1
(:func:`drn_wsod_torch.ops.roi_pool.roi_pool_batched`) serves every other
configuration, as in the JAX package (``models/build.py:111-117``).

Each bin max is the max of four lookups in the sparse range-max tables (the
two power-of-two windows that cover each integer span, on each axis), so
the forward is bit-equal to the JAX function's. The gradient is autograd's
through the same operations: ``torch.maximum`` sends half the gradient each
way on a tie, as ``jnp.maximum``'s VJP does, and a gather's gradient is a
scatter-add, as ``jnp.take``'s is. Plain torch ops on either device.
"""

from __future__ import annotations

import torch

from .roi_pool import _pool_cells, map_coords


def roi_pool(features: torch.Tensor, boxes: torch.Tensor,
             spatial_scale: float, resolution: int = 7) -> torch.Tensor:
    """Exact, differentiable RoIPool of one image.

    features: (H, W, C); boxes: (P, 4) XYXY image coordinates.
    Returns (P, R, R, C) in ``features.dtype``; RoIs are pooled 512 at a
    time, as the JAX function maps over chunks of 512, which bounds the
    gathered tensors autograd keeps."""
    return _pool_cells(features, *map_coords(boxes, spatial_scale),
                       resolution)
