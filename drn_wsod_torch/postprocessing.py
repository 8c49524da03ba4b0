"""Detection postprocessing (counterpart of
``drn_wsod_tpu/postprocessing.py``)."""

from __future__ import annotations

import torch


def rescale_boxes(boxes: torch.Tensor, image_hw: torch.Tensor,
                  orig_hw: torch.Tensor) -> torch.Tensor:
    """boxes: (..., D, 4) XYXY in the resized frame; image_hw/orig_hw:
    (..., 2) int (h, w). Returns boxes in original-image coordinates,
    clipped to the original image."""
    scale_x = (orig_hw[..., 1] / image_hw[..., 1].clamp(min=1))[..., None]
    scale_y = (orig_hw[..., 0] / image_hw[..., 0].clamp(min=1))[..., None]
    w = orig_hw[..., 1][..., None].to(boxes.dtype)
    h = orig_hw[..., 0][..., None].to(boxes.dtype)

    def c(v, hi):
        return torch.minimum(v.clamp(min=0), hi)

    return torch.stack([c(boxes[..., 0] * scale_x, w),
                        c(boxes[..., 1] * scale_y, h),
                        c(boxes[..., 2] * scale_x, w),
                        c(boxes[..., 3] * scale_y, h)], dim=-1)
