"""Cascade R-CNN's per-stage labelling (counterpart of
``drn_wsod_tpu/models/heads/cascade.py``).

Stage k > 0 trains on the detached, clipped boxes regressed by stage k-1,
matched again to the GT at its own IoU threshold, on the slots stage 0
sampled (no new sampling); the stages themselves live in
``models/meta_arch.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...ops.matcher import match
from ...structures import boxes as box_ops


def match_and_label(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                    iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label (B, S, 4) boxes against (B, G, 4) GT at ``iou_threshold``:
    (gt_class (B, S) int64, -1 for background; gt_box (B, S, 4) of the
    best-matching GT)."""
    quality = box_ops.pairwise_iou(gt_boxes, boxes)
    midx, mlab = match(quality, gt_valid, [iou_threshold], [0, 1])
    cls = torch.where(mlab == 1, gt_classes.long().gather(1, midx), -1)
    return cls, gt_boxes.gather(1, midx[..., None].expand(-1, -1, 4))
