"""Multi-level RoI pooler (counterpart of ``drn_wsod_tpu/ops/poolers.py``).

Each box is assigned a pyramid level by the FPN rule ``floor(canonical_level
+ log2(sqrt(area) / canonical_size))`` and pooled from that level's map. As
in the JAX package, every RoI is pooled at every level and the level mask
selects the result: no box is partitioned by level, at the cost of pooling
each box once per level.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from ..structures.boxes import area
from .roi_align import roi_align, roi_pool


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int,
                           max_level: int, canonical_size: int = 224,
                           canonical_level: int = 4) -> torch.Tensor:
    """(..., 4) -> (...) int32 level ids in [min_level, max_level]. The
    ``1e-8`` guards and ``log2`` as ``log(x) / log(2)`` follow the JAX
    function's float32 arithmetic."""
    sizes = torch.sqrt(area(boxes).clamp(min=1e-8))
    lvl = torch.floor(canonical_level
                      + torch.log(sizes / canonical_size + 1e-8)
                      / math.log(2.0))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def multilevel_roi_pool(features: Dict[str, torch.Tensor],
                        strides: Dict[str, int], boxes: torch.Tensor,
                        level_names: Sequence[str], resolution: int = 7,
                        pooler_type: str = "ROIAlignV2",
                        sampling_ratio: int = 2) -> torch.Tensor:
    """Pool the (P, 4) boxes of ONE image from its pyramid ({"p2": (H2, W2,
    C), ...}, ``strides`` {"p2": 4, ...}) by ``pooler_type`` ("ROIPool",
    "ROIAlign" or "ROIAlignV2"). Returns (P, R, R, C) in the maps' dtype;
    a box's row comes from its assigned level."""
    levels = sorted(level_names, key=lambda n: strides[n])
    min_level = int(math.log2(strides[levels[0]]))
    max_level = int(math.log2(strides[levels[-1]]))
    assignment = assign_boxes_to_levels(boxes, min_level, max_level)
    out = None
    for li, name in enumerate(levels):
        scale = 1.0 / strides[name]
        if pooler_type == "ROIPool":
            pooled = roi_pool(features[name], boxes, scale, resolution)
        else:
            pooled = roi_align(features[name], boxes, scale, resolution,
                               sampling_ratio,
                               aligned=pooler_type == "ROIAlignV2")
        m = (assignment == min_level + li)[:, None, None, None]
        out = torch.where(m, pooled, 0.0 if out is None else out)
    return out
